from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine,
                                             MeshRobustEngine)

__all__ = ["MeshFedAvgEngine", "MeshFedNovaEngine", "MeshFedOptEngine",
           "MeshFedProxEngine", "MeshRobustEngine"]
