from fedml_tpu_torch.algorithms.decentralized import DecentralizedGossipEngine
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustEngine
from fedml_tpu_torch.algorithms.fednas import FedNASSearchEngine
from fedml_tpu_torch.algorithms.fednova import FedNovaEngine
from fedml_tpu_torch.algorithms.fedopt import FedOptEngine
from fedml_tpu_torch.algorithms.fedprox import FedProxEngine
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvgEngine

__all__ = ["DecentralizedGossipEngine", "FedAvgEngine", "FedAvgRobustEngine",
           "FedNASSearchEngine", "FedNovaEngine", "FedOptEngine", "FedProxEngine",
           "HierarchicalFedAvgEngine"]
