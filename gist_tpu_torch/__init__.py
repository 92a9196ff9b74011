"""gist_tpu_torch — the PyTorch/CUDA port of gist_tpu.

A second package beside the JAX reference: the same datasets, graph
layouts, models, sampler and GIST trainers as tensors on an explicit
device, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (``csrc/``).  It imports torch, numpy and scipy, never JAX.
Entry points run on ``device="cuda"`` unless the caller asks for the
CPU, where every kernel takes its plain PyTorch version.
"""

__version__ = "0.1.0"
