"""Communicator (counterpart of mpi_bicgstab_tpu/parallel/comm.py).

The reference's communication surface is MPI_Iallgatherv (assemble the
iterate) and MPI_Iallreduce(SUM) (global dots). The solvers take a Comm
so that the same solver code serves one device and, from ROADMAP slice 8
on, a torch.distributed process group. This slice has the single-device
Comm only: every reduction is the local one.
"""
from __future__ import annotations

from mpi_bicgstab_tpu_torch.ops import blas


class Comm:
    """Single-device collectives: allreduce is the identity."""

    def allreduce(self, x):
        return x

    def dot(self, u, v):
        """One global dot product."""
        return self.allreduce(blas.dot(u, v))

    def dots(self, *pairs):
        """Several global dot products as ONE stacked reduction — the
        batched-Iallreduce of the reference (solver.c:240-247)."""
        return self.allreduce(blas.dots(*pairs))
