"""Communicator (counterpart of mpi_bicgstab_tpu/parallel/comm.py).

The reference's communication surface is MPI_Iallgatherv (assemble the
iterate) and MPI_Iallreduce(SUM) (global dots). The solvers take a Comm,
so the same solver code serves one device (Comm(), every collective the
identity) and a torch.distributed process group (Comm(group, size,
rank), the group of the ranks that share a row partition: parallel/
mesh.py).

Reductions keep the port's rule that dots reduce in a fixed order: a
reduction is no dist.all_reduce on floats (whose order NCCL and gloo
choose). Each rank contributes its partial (or stacked partials), the
ranks all_gather them, and every rank sums them in rank order. Every
rank then holds the same bits, so every rank takes the same stop
decision and none waits alone in a collective. A double-float pair
travels as one [2, ...] tensor; the pairs are summed with df_sum in rank
order and renormalised, as the JAX package's psum of a pair is.

Comm.seq / serialize (the reference's *_nooverlap A/B) are not ported
yet: ROADMAP queue 1 item 8b.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import blas
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_renorm, df_sum,
                                                  is_df)


class Comm:
    """Collectives over one process group (or none: a single device).

    group: a torch.distributed process group, size its ranks, rank this
    process's index in it (the JAX axis_index)."""

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        self.group = group
        self.size = size
        self.rank = rank

    def _gather(self, t: torch.Tensor) -> list:
        """Every rank's t, in rank order (one all_gather)."""
        import torch.distributed as dist
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def _gather_pairs(self, x) -> tuple[list, bool]:
        """Every rank's x as [2, ...] (hi, lo) tensors for a pair, else
        as x; and whether x is a pair."""
        if is_df(x):
            return self._gather(torch.stack([x.hi, x.lo])), True
        return self._gather(x), False

    # -- reductions -----------------------------------------------------
    def allreduce(self, x):
        """MPI_Iallreduce(SUM) (reference solver.c:79 etc.): the ranks'
        values summed in rank order; pairs by df_sum, renormalised."""
        if self.group is None:
            return x
        parts, df = self._gather_pairs(x)
        if df:
            st = torch.stack(parts)                  # [P, 2, ...]
            return df_renorm(df_sum(DF(st[:, 0], st[:, 1]), axis=0))
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def sum_over_ranks(self, x):
        """The ranks' values summed in rank order, a pair's halves apart
        and not renormalised: exact when one rank holds x and the others
        zeros (SigmaComm.take_row)."""
        if self.group is None:
            return x
        parts, df = self._gather_pairs(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return DF(acc[0], acc[1]) if df else acc

    def dot(self, u, v):
        """One global dot product."""
        return self.allreduce(blas.dot(u, v))

    def dots(self, *pairs):
        """Several global dot products as ONE stacked reduction — the
        batched-Iallreduce of the reference (solver.c:240-247)."""
        return self.allreduce(blas.dots(*pairs))

    def max(self, x):
        if self.group is None:
            return x
        return torch.stack(self._gather(x)).amax(dim=0)

    # -- gathers ---------------------------------------------------------
    def allgather(self, x_loc, axis: int = 0):
        """MPI_Iallgatherv (reference matrix.c:432): the full vector from
        the ranks' equal shards, concatenated along `axis` in rank order
        (the partition pads the rows so that shards are equal; the
        reference gave the remainder rows to the first ranks,
        matrix.c:295-298). A pair gathers both halves in one
        collective."""
        if self.group is None:
            return x_loc
        parts, df = self._gather_pairs(x_loc)
        if df:
            return DF(torch.cat([p[0] for p in parts], axis),
                      torch.cat([p[1] for p in parts], axis))
        return torch.cat(parts, axis)

    def axis_index(self) -> int:
        return self.rank
