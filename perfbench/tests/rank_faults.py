"""Faults planted in every rank of a cell run across ranks, for
test_perfbench_ranks.py: `faulty_task(kind, ...)` runs ranks.rank_task
with one part of the program's distributed route broken underneath, and
puts the route back after it.

  halo             each halo exchange drops the next rank's rows: the
                   halo after a rank's own rows keeps zeros
  local_reduction  the reduction behind alpha (the step along p) is left
                   to each rank's own rows: the halo-fused route's lone
                   dot (r^, s) a pass reduces, the unfused route's dot of
                   two different vectors; the stop test's and the exit's
                   reductions stay global, so the ranks stay in step
  rank0_rows       the answer is rank 0's own rows, the rest zeros
"""
import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class _Dropped:
    """An exchange whose wait leaves the upper halo at zero."""

    def __init__(self, ex, halo: int, targets):
        self.ex, self.halo, self.targets = ex, halo, targets

    def complete(self):
        self.ex.complete()

    def wait(self):
        self.ex.wait()
        for xh in self.targets:
            for t in ((xh.hi, xh.lo) if hasattr(xh, "hi") else (xh,)):
                t[t.shape[0] - self.halo:] = 0


def _plant(kind, stack):
    from mpi_bicgstab_tpu_torch.ops import blas
    from mpi_bicgstab_tpu_torch.parallel import comm, dist_spmv, driver
    from mpi_bicgstab_tpu_torch.solvers import fused_dist
    if kind == "halo":
        real = dist_spmv.exchange_halo

        def exchange(c, halo, vecs):
            return _Dropped(real(c, halo, vecs), halo, [v for _, v in vecs])
        stack.enter_context(_patched(dist_spmv, "exchange_halo", exchange))
        stack.enter_context(_patched(fused_dist, "exchange_halo", exchange))
    elif kind == "local_reduction":
        real_reduce, real_dot = fused_dist._Rows.reduce, comm.Comm.dot

        def reduce(self, *dots):
            return list(dots) if len(dots) == 1 else real_reduce(self, *dots)

        def dot(self, u, v):
            return blas.dot(u, v) if u is not v else real_dot(self, u, v)
        stack.enter_context(_patched(fused_dist._Rows, "reduce", reduce))
        stack.enter_context(_patched(comm.Comm, "dot", dot))
    elif kind == "rank0_rows":
        real = driver.solve_distributed

        def solve(part, b, *a, **kw):
            res = real(part, b, *a, **kw)
            x = res.x
            halves = (x.hi.clone(), x.lo.clone()) if hasattr(x, "hi") \
                else (x.clone(),)
            for t in halves:
                t[part.n_loc:] = 0
            x = type(x)(*halves) if hasattr(x, "hi") else halves[0]
            return dataclasses.replace(res, x=x)
        stack.enter_context(_patched(driver, "solve_distributed", solve))
    else:
        raise ValueError(f"unknown fault {kind!r}")


def faulty_task(kind, *args):
    from perfbench import ranks
    with contextlib.ExitStack() as stack:
        _plant(kind, stack)
        return ranks.rank_task(*args)
