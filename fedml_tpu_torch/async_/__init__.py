"""Async federation: buffered staleness-aware aggregation (port of
fedml_tpu/async_/).

  staleness.py   staleness weight families, the flat-row buffer in drain
                 and streaming (aggregation-on-arrival) modes, the seeded
                 bucketed robust commit, and the RowLayout the decode-into
                 path targets
  adversary.py   seeded adversarial client simulator
  defense.py     the update admission pipeline at the ONE insert path
  scheduler.py   AsyncFedAvgEngine, the event-driven virtual-time
                 scheduler (FedBuff; FedAsync at K=1)
  lifecycle.py   the seeded client-lifecycle simulator and the
                 AsyncServerManager / AsyncClientManager FSM pair over the
                 comm backends, with the bounded decode pool
"""
from fedml_tpu_torch.async_.adversary import (ATTACK_MODES, AdversarySim,
                                              AttackConfig, apply_data_attack)
from fedml_tpu_torch.async_.defense import (DefenseConfig, QUARANTINE_REASONS,
                                            UpdateAdmission)
from fedml_tpu_torch.async_.lifecycle import (AsyncClientManager,
                                              AsyncMessage,
                                              AsyncServerManager,
                                              ClientLifecycle,
                                              LifecycleConfig,
                                              run_async_messaging)
from fedml_tpu_torch.async_.scheduler import AsyncFedAvgEngine
from fedml_tpu_torch.async_.staleness import (AsyncBuffer,
                                              BUCKET_COMBINE_MODES,
                                              RowLayout, STALENESS_MODES,
                                              make_bucket_commit_fn,
                                              make_commit_fn,
                                              make_drain_fold_fn,
                                              make_fold_fn,
                                              make_stream_commit_fn,
                                              staleness_weight)
from fedml_tpu_torch.async_.torture import (run_connection_torture,
                                            run_ingest_torture)

__all__ = [
    "ATTACK_MODES", "AdversarySim", "AsyncBuffer", "AsyncClientManager",
    "AsyncFedAvgEngine", "AsyncMessage", "AsyncServerManager",
    "AttackConfig", "BUCKET_COMBINE_MODES", "ClientLifecycle",
    "DefenseConfig", "LifecycleConfig", "QUARANTINE_REASONS", "RowLayout",
    "STALENESS_MODES", "UpdateAdmission", "apply_data_attack",
    "make_bucket_commit_fn", "make_commit_fn", "make_drain_fold_fn",
    "make_fold_fn", "make_stream_commit_fn", "run_async_messaging",
    "run_connection_torture", "run_ingest_torture", "staleness_weight",
]
