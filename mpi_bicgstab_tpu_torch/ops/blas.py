"""BLAS-1 layer (counterpart of mpi_bicgstab_tpu/ops/blas.py; reference
vector.c:3-26: my_daxpy / my_ddot)."""
from __future__ import annotations

import torch


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Local dot product as a 0-d tensor (reference my_ddot,
    vector.c:10-16)."""
    return torch.dot(u, v)


def dots(*pairs) -> torch.Tensor:
    """Several dot products stacked into one length-k tensor."""
    return torch.stack([dot(u, v) for u, v in pairs])


def axpy(alpha: torch.Tensor, x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """y + alpha*x for a 0-d tensor alpha, one fused op (reference
    my_daxpy, vector.c:3-8)."""
    return torch.addcmul(y, alpha, x)
