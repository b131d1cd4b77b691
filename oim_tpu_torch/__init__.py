"""PyTorch/CUDA port of the oim_tpu compute path for NVIDIA Hopper.

The JAX package ``oim_tpu`` stays the reference; this package keeps its
module paths and names (``ops/``, ``models/``, ``serve/``, ``cli/``) so
each counterpart is easy to find.  The serving path runs its paged
attention in two CUDA C++ kernels written for ``sm_90a``
(``csrc/paged_attention.cu``); everything else is plain PyTorch.  Entry
points run on the GPU unless the caller asks for the CPU, where each
kernel wrapper runs its plain PyTorch version.
"""
