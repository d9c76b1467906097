from fedml_tpu_torch.parallel.mesh import (client_sharding, make_mesh,
                                           make_mesh_batch,
                                           replicated_sharding,
                                           shard_cohort)
from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine,
                                             MeshRobustEngine)
from fedml_tpu_torch.parallel.hierarchical import MeshHierarchicalEngine
from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
from fedml_tpu_torch.parallel.multihost import (HostChannel,
                                                MultihostContext,
                                                MultihostRunner,
                                                init_multihost,
                                                make_global_mesh,
                                                make_hierarchical_host_mesh,
                                                make_local_mesh,
                                                spawn_cluster)

__all__ = ["make_mesh", "make_mesh_batch", "client_sharding",
           "replicated_sharding", "shard_cohort", "MeshFedAvgEngine",
           "MeshFedNovaEngine", "MeshFedOptEngine", "MeshFedProxEngine",
           "MeshRobustEngine", "MeshHierarchicalEngine", "MeshGossipEngine",
           "HostChannel", "MultihostContext", "MultihostRunner",
           "init_multihost", "make_global_mesh",
           "make_hierarchical_host_mesh", "make_local_mesh", "spawn_cluster"]
