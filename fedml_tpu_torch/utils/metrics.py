"""Local run logger, the wandb-parity metrics system of record (a copy of
fedml_tpu/utils/metrics.py: the port imports nothing of the JAX package).

The reference logs Train/Acc, Train/Loss, Test/Acc, Test/Loss keyed by
round to wandb (FedAVGAggregator.py:137-162) and its CI reads results back
out of wandb-summary.json (CI-script-fedavg.sh:42-47).  Zero-egress
equivalent: a per-run directory with

  history.jsonl   one JSON line per log() call (step-keyed)
  summary.json    last value per key — same contract the CI oracle reads

If wandb is importable AND configured, mirror to it; never required.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class RunLogger:
    def __init__(self, root: str = "./runs", project: str = "fedml_tpu",
                 name: Optional[str] = None, config: Optional[dict] = None,
                 use_wandb: bool = False):
        stamp = name or time.strftime("run-%Y%m%d-%H%M%S")
        self.dir = os.path.join(root, project, stamp)
        os.makedirs(self.dir, exist_ok=True)
        self.summary: dict[str, Any] = {}
        self._hist = open(os.path.join(self.dir, "history.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:                        # optional, absent in this image
                import wandb
                self._wandb = wandb.init(project=project, name=name,
                                         config=config or {})
            except Exception:
                self._wandb = None
        if config:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if self._hist.closed:
            raise ValueError("RunLogger is closed (log after close())")
        rec = {"_step": step, "_time": time.time(), **metrics}
        self._hist.write(json.dumps(rec, default=float) + "\n")
        # flush per log(): a killed run keeps every line it logged —
        # history.jsonl is the post-mortem record, not a best-effort one
        self._hist.flush()
        self.summary.update(metrics)
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, default=float)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        """Close the history handle and the wandb mirror.  Idempotent —
        every exit path (cli main, context-manager __exit__, an
        engine's own cleanup) may call it."""
        if not self._hist.closed:
            self._hist.close()
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    # close()/with-statement aliases: `with RunLogger(...) as logger:`
    # guarantees the wandb mirror and the history handle are released on
    # ANY exit, including an exception mid-run
    close = finish

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    @staticmethod
    def read_summary(run_dir: str) -> dict:
        """The CI-oracle read path (reference reads
        wandb/latest-run/files/wandb-summary.json)."""
        with open(os.path.join(run_dir, "summary.json")) as f:
            return json.load(f)
