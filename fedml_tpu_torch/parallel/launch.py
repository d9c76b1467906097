"""Multi-process launcher (port of tools/launch_multihost.py).

Forks N copies of a worker command wired as one cluster: each rank gets
FEDML_MH_RANK / FEDML_MH_WORLD / FEDML_MH_COORD (the HostChannel
coordinator rank 0 binds).  It replaces the reference's
`mpirun -np N -hostfile ...` bootstrap on one machine; a multi-machine
run launches one process per machine through its own runner and sets
the same env.

    python -m fedml_tpu_torch.parallel.launch --procs 2 -- \\
        python -m fedml_tpu_torch.parallel.mh_worker cfg.json

Failure policy (spawn_cluster): the first rank to exit nonzero kills the
rest and the launcher exits nonzero naming that rank with its stderr
tail; a --timeout overrun names the ranks still running.  With --elastic
a dead rank does not take the survivors down (only rank 0's death is
fatal), and --respawn starts a dead rank other than 0 once more with
FEDML_MH_REJOIN=1, so it rejoins through the elastic channel:

    python -m fedml_tpu_torch.parallel.launch --procs 3 --elastic \\
        --respawn -- python -m fedml_tpu_torch.parallel.mh_worker CFG

(CFG with "elastic": true).  Child stderr streams through line-prefixed
(`[rank i]`); child stdout is echoed after completion in rank order.
--jax-distributed also exports FEDML_MH_JAX_COORD, the rendezvous at
which each rank's `init_multihost` joins torch.distributed's gloo group
(the client-axis mesh, parallel/mesh.py):

    python -m fedml_tpu_torch.parallel.launch --procs 2 --jax-distributed \\
        -- python -m fedml_tpu_torch.parallel.mesh_worker CASE.json

--procs counts host-channel members: a worker with local_devices k > 1
(mh_worker) starts its member's k - 1 further ranks itself.
"""
from __future__ import annotations

import argparse
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, required=True,
                    help="process count (one per rank)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="whole-cluster wall deadline in seconds")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic launch policy: a dead rank does not "
                         "kill the survivors; only rank 0's death (or "
                         "the deadline) fails the launch.  The workers "
                         "must run the elastic runtime (mh_worker "
                         "'elastic': true)")
    ap.add_argument("--respawn", action="store_true",
                    help="with --elastic: start a dead rank other than 0 "
                         "once more with FEDML_MH_REJOIN=1 (it rejoins "
                         "through the elastic handshake)")
    ap.add_argument("--jax-distributed", action="store_true",
                    help="also export FEDML_MH_JAX_COORD: each rank's "
                         "init_multihost joins torch.distributed's gloo "
                         "group there (the name is the JAX package's, so "
                         "one launch line drives both)")
    ap.add_argument("--port", type=int, default=None,
                    help="the host channel coordinator's port (default: a "
                         "free one); --jax-distributed's rendezvous takes "
                         "port + 1 and member m's local group (mh_worker "
                         "local_devices > 1) port + 2 + m")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    # bad arguments fail before any rank starts
    if args.procs < 1:
        ap.error(f"--procs must be >= 1, got {args.procs}")
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing worker command (append it after --, e.g. "
                 "`-- python -m fedml_tpu_torch.parallel.mh_worker "
                 "cfg.json`)")
    if args.timeout <= 0:
        ap.error(f"--timeout must be > 0, got {args.timeout}")
    if args.respawn and not args.elastic:
        ap.error("--respawn needs --elastic (a fail-fast cluster kills "
                 "the survivors the rejoiner would rejoin)")
    args.cmd = cmd
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from fedml_tpu_torch.parallel.multihost import (MultihostLaunchError,
                                                    spawn_cluster)
    try:
        outs = spawn_cluster(args.cmd, args.procs, timeout_s=args.timeout,
                             echo=True, elastic=args.elastic,
                             respawn=args.respawn,
                             jax_distributed=args.jax_distributed,
                             coordinator_port=args.port)
    except MultihostLaunchError as e:
        print(f"launch: {e}", file=sys.stderr)
        return 1
    for r, out in enumerate(outs):
        for line in out.splitlines():
            print(f"[rank {r}] {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
