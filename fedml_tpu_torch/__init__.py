"""fedml_tpu_torch: the PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of fedml_tpu on the
ported path is a hand-written CUDA kernel (fedml_tpu_torch/csrc, built at
first use into fedml_tpu_torch/_build).  Entry points run on CUDA unless
the caller passes device="cpu", where each kernel's plain PyTorch version
runs instead.  The package imports neither JAX nor fedml_tpu.
"""
