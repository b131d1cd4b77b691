"""RMSNorm reference (plain PyTorch).

Only the reference formula is on the serving path: the JAX engine forces
``use_pallas=False`` there, so the Pallas RMSNorm kernel
(``oim_tpu/ops/rmsnorm.py::_kernel``) arrives with the training slice.
"""

from __future__ import annotations

import torch


def reference_rmsnorm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x², -1) + eps) * w`` reduced in f32, returned in
    x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return normed.to(x.dtype)
