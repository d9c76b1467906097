from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import ClientTrainer

__all__ = ["ClientSampler", "ClientTrainer"]
