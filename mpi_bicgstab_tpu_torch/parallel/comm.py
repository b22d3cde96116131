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
ranks gather them as one flat [P, m] tensor (one all_gather_single /
all_gather_into_tensor), and every rank sums them in rank order. Every
rank then holds the same bits, so every rank takes the same stop
decision and none waits alone in a collective. A double-float pair
travels in the same tensor as its [2, ...] halves; the pairs are summed
with df_sum in rank order and renormalised, as the JAX package's psum
of a pair is.

Split phase (the reference's MPI_Iallreduce ... MPI_Wait): `start(x)`
issues the gather with async_op=True and returns a Pending; its `wait()`
waits on the collective and sums. With NCCL the wait makes the current
stream wait on NCCL's stream, so the host does not block and kernels
issued between start and wait run beside the collective; with gloo the
collective runs on gloo's thread. A Pending holds its input and output
buffers until the wait. `allreduce`, `dot`, `dots` and `allgather` are
start(...).wait().

Comm(serialize=True) is the reference's *_nooverlap mode, the A/B that
measures what the overlap buys: every collective (the reductions, the
gathers and the halo exchanges of parallel/dist_spmv.py) is waited on
right after it is issued, before any compute that could hide it, and
`seq` marks the points where the JAX package places its barriers. Both
modes run the same operations in the same order and give the same bits;
only where the waits stand differs.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import blas
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_renorm, df_sum,
                                                  is_df)
from mpi_bicgstab_tpu_torch.utils.timing import span


def _gather_into(out, t, group):
    """One all-gather of t into the flat `out`, async (the API's name
    differs across torch versions)."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, t, group=group, async_op=True)


class Pending:
    """A collective in flight: wait() waits on it (once) and returns
    finish(its gathered buffer). The input and output buffers live here
    until the wait."""

    def __init__(self, work, buf, finish, keep=None):
        self._work, self._buf, self._finish = work, buf, finish
        self._keep = keep
        self._value = None

    def complete(self) -> None:
        """Wait on the collective without finishing it."""
        if self._work is not None:
            self._work.wait()
            self._work = self._keep = None

    def wait(self):
        if self._finish is not None:
            self.complete()
            self._value = self._finish(self._buf)
            self._finish = self._buf = None
        return self._value


def ready(value) -> Pending:
    """A Pending that holds its value already (a collective over one
    device)."""
    return Pending(None, value, lambda v: v)


def _rank_sum(parts):
    """parts[0] + parts[1] + ... in rank order (parts [P, ...])."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def counted(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the collectives Comm issued in it on this
    rank): a task for parallel/launch.py that shows how many reductions
    and gathers a solve makes."""
    before = Comm.issued
    out = fn(*args, **kwargs)
    return out, Comm.issued - before


class Comm:
    """Collectives over one process group (or none: a single device).

    group: a torch.distributed process group, size its ranks, rank this
    process's index in it (the JAX axis_index). serialize: the no-overlap
    mode (module doc). Comm.issued counts the collectives every Comm of
    this process issued (counted)."""

    issued = 0

    def __init__(self, group=None, size: int = 1, rank: int = 0,
                 serialize: bool = False):
        self.group = group
        self.size = size
        self.rank = rank
        self.serialize = serialize

    def with_serialize(self, serialize: bool) -> "Comm":
        """This Comm in the given mode (itself when the mode matches)."""
        if bool(serialize) == self.serialize:
            return self
        return Comm(self.group, self.size, self.rank, bool(serialize))

    def seq(self, *xs):
        """Identity by default; under serialize, every collective in
        flight among xs (a Pending, a dist_spmv.Exchange) is waited on
        here (the JAX package's optimization barrier, which
        forces the Wait where the reference placed one). Returns xs (one
        value as itself)."""
        if self.serialize:
            for x in xs:
                if hasattr(x, "complete"):
                    x.complete()
        return xs if len(xs) > 1 else xs[0]

    def _issued(self, p: Pending) -> Pending:
        if self.serialize:
            p.complete()
        return p

    def _start_gather(self, x, finish) -> Pending:
        """Gather x from every rank as [P, ...] (a pair as [P, 2, ...]) in
        one collective, then finish(the [P, ...] tensor, is x a pair)."""
        df = is_df(x)
        t = (torch.stack([x.hi, x.lo]) if df else x).contiguous()
        out = t.new_empty((self.size,) + tuple(t.shape))
        work = _gather_into(out.view(-1), t.view(-1), self.group)
        Comm.issued += 1
        return self._issued(Pending(work, out, lambda g: finish(g, df),
                                    keep=t))

    # -- reductions -----------------------------------------------------
    def start(self, x) -> Pending:
        """MPI_Iallreduce(SUM) (reference solver.c:79 etc.), split phase:
        the Pending's wait() gives the ranks' values summed in rank
        order; pairs by df_sum, renormalised."""
        if self.group is None:
            return ready(x)

        def finish(g, df):
            if df:
                return df_renorm(df_sum(DF(g[:, 0], g[:, 1]), axis=0))
            return _rank_sum(g)
        return self._start_gather(x, finish)

    def allreduce(self, x):
        """start(x).wait()."""
        return self.start(x).wait()

    def sum_over_ranks(self, x):
        """The ranks' values summed in rank order, a pair's halves apart
        and not renormalised: exact when one rank holds x and the others
        zeros (SigmaComm.take_row)."""
        if self.group is None:
            return x

        def finish(g, df):
            acc = _rank_sum(g)
            return DF(acc[0], acc[1]) if df else acc
        return self._start_gather(x, finish).wait()

    def start_dots(self, *pairs) -> Pending:
        """Several global dot products as ONE stacked reduction, split
        phase; over no group, dots(*pairs) at once."""
        if self.group is None:
            return ready(self.dots(*pairs))
        return self.start(blas.dots(*pairs))

    def dot(self, u, v):
        """One global dot product."""
        with span("mbt.dot"):
            return self.allreduce(blas.dot(u, v))

    def dots(self, *pairs):
        """Several global dot products as ONE stacked reduction — the
        batched-Iallreduce of the reference (solver.c:240-247)."""
        with span("mbt.dot"):
            return self.allreduce(blas.dots(*pairs))

    def max(self, x):
        if self.group is None:
            return x
        return self._start_gather(x, lambda g, df: g.amax(dim=0)).wait()

    # -- gathers ---------------------------------------------------------
    def start_allgather(self, x_loc, axis: int = 0) -> Pending:
        """MPI_Iallgatherv (reference matrix.c:432), split phase: the full
        vector from the ranks' equal shards, concatenated along `axis`
        in rank order (the partition pads the rows so that shards are
        equal; the reference gave the remainder rows to the first ranks,
        matrix.c:295-298). A pair gathers both halves in one
        collective."""
        if self.group is None:
            return ready(x_loc)

        def cat(g):            # [P, ...] -> the shards along axis
            return torch.cat(g.unbind(0), axis)

        def finish(g, df):
            if df:
                return DF(cat(g[:, 0]), cat(g[:, 1]))
            return cat(g)
        return self._start_gather(x_loc, finish)

    def allgather(self, x_loc, axis: int = 0):
        """start_allgather(x_loc, axis).wait()."""
        return self.start_allgather(x_loc, axis).wait()

    def axis_index(self) -> int:
        return self.rank
