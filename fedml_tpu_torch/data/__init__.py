from fedml_tpu_torch.data.federated import (FederatedData, build_client_shards,
                                            build_eval_shard, pad_to_batches)
from fedml_tpu_torch.data.loaders import load_data, load_vfl_data
from fedml_tpu_torch.data.poison import (backdoor_test_shard, pixel_trigger,
                                         poison_federated_data)

__all__ = ["FederatedData", "build_client_shards", "build_eval_shard",
           "pad_to_batches", "load_data", "load_vfl_data",
           "poison_federated_data", "backdoor_test_shard", "pixel_trigger"]
