from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine

__all__ = ["FedAvgEngine"]
