from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine

__all__ = ["MeshFedAvgEngine"]
