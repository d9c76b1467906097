"""fedml_tpu_torch.scale: the million-client serving spine (port of
fedml_tpu/scale/).

The sharded O(1)-per-round client registry, streaming cohort samplers
over its eligibility mask, on-demand client-shard stores, trace-driven
arrival processes, and the one-process virtual-time serve simulation.
The host-sharded serving cluster (``scale/cluster.py``) is a later slice.
"""
from fedml_tpu_torch.scale.arrivals import (ARRIVAL_MODES, ArrivalConfig,
                                            ArrivalProcess,
                                            ConstantArrivals,
                                            DiurnalArrivals,
                                            FlashCrowdArrivals,
                                            TraceArrivals, make_arrivals)
from fedml_tpu_torch.scale.registry import (BANNED, BYTES_PER_CLIENT,
                                            CRASHED, DEAD, FREE, IN_FLIGHT,
                                            ClientRegistry)
from fedml_tpu_torch.scale.sampler import (SAMPLER_MODES,
                                           StreamingCohortSampler)
from fedml_tpu_torch.scale.serve import (fold_partials, pack_partial,
                                         rss_bytes, run_serve_sim,
                                         zero_partial)
from fedml_tpu_torch.scale.shardstore import (GeneratorShardStore,
                                              MaterializedShardStore,
                                              MmapShardStore, ShardStore)

__all__ = [
    "ARRIVAL_MODES", "ArrivalConfig", "ArrivalProcess",
    "ConstantArrivals", "DiurnalArrivals", "FlashCrowdArrivals",
    "TraceArrivals", "make_arrivals",
    "BANNED", "BYTES_PER_CLIENT", "CRASHED", "DEAD", "FREE", "IN_FLIGHT",
    "ClientRegistry",
    "SAMPLER_MODES", "StreamingCohortSampler",
    "fold_partials", "pack_partial", "run_serve_sim", "rss_bytes",
    "zero_partial",
    "GeneratorShardStore", "MaterializedShardStore", "MmapShardStore",
    "ShardStore",
]
