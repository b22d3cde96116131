"""The plain float64 operator the check judges answers with.

Plain PyTorch over the diagonals of reference/generators.py: y = A x
for x of shape [..., n], one slice-and-add per diagonal, in float64 on
whatever device the diagonals were put on. It takes nothing from the
program: the right-hand sides are made with it, and every answer the
program returns is judged by its true relative residual under it.
"""
from __future__ import annotations

import numpy as np
import torch


class DiaOperator:
    """A square matrix held as its diagonals (generators' layout)."""

    def __init__(self, n: int, offsets, values, device="cpu"):
        self.n = int(n)
        self.offsets = [int(o) for o in offsets]
        self.values = [torch.as_tensor(np.asarray(v, dtype=np.float64),
                                       device=device) for v in values]

    @classmethod
    def from_generator(cls, gen, device="cpu", **kw) -> "DiaOperator":
        n, offs, vals = gen(**kw)
        return cls(n, offs, vals, device)

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def band_entries(self) -> int:
        """Stored entries of the band: sum over diagonals of n - |o|."""
        return sum(self.n - abs(o) for o in self.offsets)

    def to(self, device) -> "DiaOperator":
        op = DiaOperator.__new__(DiaOperator)
        op.n, op.offsets = self.n, self.offsets
        op.values = [v.to(device) for v in self.values]
        return op

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x over the last axis of a float64 x."""
        n = self.n
        y = torch.zeros_like(x)
        for o, v in zip(self.offsets, self.values):
            if o >= 0:
                y[..., : n - o] += v * x[..., o:]
            else:
                y[..., -o:] += v * x[..., : n + o]
        return y


def relres(A: DiaOperator, x: torch.Tensor, b: torch.Tensor,
           shifts: torch.Tensor | None = None) -> torch.Tensor:
    """||b - (A + shift_j I) x_j|| / ||b|| in float64 for each row x_j of
    x ([n] or [k, n]); shifts ([k] or None) add shift_j x_j."""
    x = x.to(torch.float64)
    ax = A.matvec(x)
    if shifts is not None:
        ax = ax + shifts.to(torch.float64)[:, None] * x
    r = b.to(torch.float64) - ax
    return torch.linalg.vector_norm(r, dim=-1) \
        / torch.linalg.vector_norm(b.to(torch.float64))
