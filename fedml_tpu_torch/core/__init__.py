from fedml_tpu_torch.core.pytree import (
    clip_scale,
    tree_add,
    tree_cast,
    tree_clip_by_norm,
    tree_dot,
    tree_l2_norm,
    tree_scale,
    tree_select,
    tree_stack,
    tree_sub,
    tree_unstack,
    tree_weighted_mean,
    tree_zeros_like,
    vectorize_weights,
)
from fedml_tpu_torch.core.partition import (
    partition_dirichlet,
    partition_homo,
    partition_power_law,
    record_data_stats,
)
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.core.topology import (
    AsymmetricTopologyManager,
    SymmetricTopologyManager,
)
from fedml_tpu_torch.core.robust import (add_weak_dp_noise, clip_row,
                                         norm_diff_clip)

# fedml_tpu.core's names, but TrainState: the port's trainer state is a
# flat vector and an optimizer dict
__all__ = [
    "tree_weighted_mean", "tree_select", "tree_stack", "tree_unstack",
    "tree_zeros_like",
    "tree_add", "tree_sub", "tree_scale", "tree_dot", "tree_l2_norm",
    "tree_clip_by_norm", "tree_cast", "vectorize_weights",
    "partition_homo", "partition_dirichlet", "partition_power_law",
    "record_data_stats", "ClientSampler", "ClientTrainer",
    "SymmetricTopologyManager", "AsymmetricTopologyManager",
    "norm_diff_clip", "add_weak_dp_noise", "clip_scale", "clip_row",
]
