from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine,
                                             MeshRobustEngine)
from fedml_tpu_torch.parallel.multihost import (HostChannel,
                                                MultihostContext,
                                                MultihostRunner,
                                                spawn_cluster)

__all__ = ["MeshFedAvgEngine", "MeshFedNovaEngine", "MeshFedOptEngine",
           "MeshFedProxEngine", "MeshRobustEngine", "HostChannel",
           "MultihostContext", "MultihostRunner", "spawn_cluster"]
