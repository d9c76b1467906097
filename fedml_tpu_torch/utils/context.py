"""Run-level error/cleanup context managers + sweep coordination glue.

A copy of fedml_tpu/utils/context.py (the port imports nothing of the
JAX package).  Parity: fedml_api/utils/context.py (raise_MPI_error aborts COMM_WORLD on
any exception — we tear down comm managers instead of nuking the world)
and fedml_api/distributed/fedavg/utils.py:19-27
(post_complete_message_to_sweep_process — wandb-sweep agents block on a
named pipe until the training process reports completion).
"""
from __future__ import annotations

import logging
import os
import traceback
from contextlib import contextmanager

log = logging.getLogger(__name__)


@contextmanager
def graceful_abort(*managers, reraise: bool = True):
    """Run a deployment block; on ANY exception, log the traceback and
    finish() every comm manager so sockets/threads shut down instead of
    hanging the peer ranks (the reference calls MPI Abort; we close the
    transports we own).  `reraise=False` mirrors
    raise_error_without_process."""
    try:
        yield
    except BaseException as e:      # incl. KeyboardInterrupt/SystemExit:
        log.error("aborting run:\n%s", traceback.format_exc())
        for m in managers:
            try:
                m.finish()
            except Exception:       # teardown must not mask the real error
                log.exception("manager %r failed to finish", m)
        # Ctrl-C / sys.exit always propagate; reraise=False only swallows
        # ordinary Exceptions (raise_error_without_process parity)
        if reraise or not isinstance(e, Exception):
            raise


def post_complete_message_to_sweep_process(args,
                                           pipe_path: str = "./tmp/fedml",
                                           wait_for_reader: float = 2.0):
    """Notify a sweep coordinator over a named pipe (reference
    fedavg/utils.py:19-27).  Waits up to `wait_for_reader` seconds for a
    coordinator to attach, then drops the message with a warning — the
    reference instead blocks forever when run outside a sweep."""
    import time
    os.makedirs(os.path.dirname(pipe_path) or ".", exist_ok=True)
    if not os.path.exists(pipe_path):
        try:
            os.mkfifo(pipe_path)
        except OSError:             # plain file already there, etc.
            pass
    deadline = time.monotonic() + wait_for_reader
    while True:
        try:
            pipe_fd = os.open(pipe_path, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:             # ENXIO: no reader attached yet
            if time.monotonic() >= deadline:
                log.warning("no sweep coordinator reading %s; completion "
                            "message dropped", pipe_path)
                return
            time.sleep(0.05)
    with os.fdopen(pipe_fd, "w") as pipe:
        pipe.write(f"training is finished! \n{args}\n")
