from fedml_tpu_torch.data.federated import (FederatedData, build_client_shards,
                                            build_eval_shard, pad_to_batches)

__all__ = ["FederatedData", "build_client_shards", "build_eval_shard",
           "pad_to_batches"]
