"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version and a launch counter."""
from fedml_tpu_torch.ops.aggregate import (clip_agg, clip_fold, fold,
                                           robust_weighted_mean, sqnorm,
                                           weighted_mean, weighted_mean_flat,
                                           wsum)
from fedml_tpu_torch.ops.build import reset_counts
from fedml_tpu_torch.ops.groupnorm import (GroupNorm, gn_backward, gn_forward,
                                           group_norm)

# every kernel wrapper whose `launches` counts its kernel's launches
KERNEL_WRAPPERS = (gn_forward, gn_backward, wsum, sqnorm, clip_agg)


def reset_launch_counts() -> None:
    reset_counts(KERNEL_WRAPPERS)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = ["GroupNorm", "group_norm", "gn_forward", "gn_backward", "fold",
           "weighted_mean", "weighted_mean_flat", "wsum", "sqnorm",
           "clip_agg", "clip_fold", "robust_weighted_mean", "KERNEL_WRAPPERS",
           "reset_launch_counts", "launch_counts"]
