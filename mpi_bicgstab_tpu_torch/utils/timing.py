"""The port's tracing: named spans on the profiler's clock and the one
helper through which the solver loops read from the card.

`span(name)` opens a profiler range (a RecordFunction, what
`torch.profiler.record_function` opens) only while a torch profiler is
enabled, so that a trace of a solve shows which part of the program the
host was in at every instant, on the same clock as the card's kernels.
With no profiler it costs one check and returns a shared no-op context;
nothing is recorded or kept. `host_read(x)` runs a
read from the card (or any call that waits for it) inside span
`mbt.sync`, so that a trace counts the host's syncs.

The spans, one at each layer boundary of the single-device routes:

  mbt.solve           api.solve, api.solve_shifted: one a call
  mbt.segment         api._solve_once: the first pass and each restart
  mbt.iter            one iteration of the fused float32 and df32
                      classic drivers, the unfused classic BiCGStab and
                      the seed-switching loop, its stop test included
  mbt.seed_step       switching.seed_step: the seed's LOP step
  mbt.shift_recur     switching.seed_step: the [S] shift recurrences
  mbt.spmv            ops/layout.spmv (the chain inside it for a
                      Chebyshev operator)
  mbt.dot             Comm.dot, Comm.dots
  mbt.launch.<what>   a kernel wrapper's host work (checks, allocations,
                      the launch; on the CPU its plain twin): band_pass
                      and df_pass by their `what` (the classic DF
                      bodies: classic_df_p, _a, _q, _o), dia_spmv,
                      dia_spmv_df, cheby_chain, cheby_chain_df,
                      fused_shift_update_df
  mbt.sync            host_read
"""
from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler


class _Off:
    """The no-op context (contextlib.nullcontext's __exit__ takes
    *args, which costs a tuple on every exit)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_OFF = _Off()
# torch's C++ range: under a profiler it adds 0-3 us to a span where
# torch.profiler.record_function, a TorchScript op, adds 7-12 (an H100's
# host), and a profiled loop of small launches stretches with that cost.
# Its events are `cpu_op`s, record_function's `user_annotation`s.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


def span(name: str):
    """A context that records `name` as a range in the running torch
    profiler's trace; a shared no-op context when no profiler runs. The
    check reads the flag torch's profilers set while they run, a module
    attribute (a call into the profiler's C++ state costs more)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RANGE(name)


def _read(x):
    return x() if callable(x) else x.item()


def host_read(x):
    """x() for a callable (a read such as `t.cpu`), else x.item() (the
    value of a 0-d tensor or DF pair), inside span mbt.sync. With no
    profiler the read runs outside any context."""
    if not _profiler._is_profiler_enabled:
        return _read(x)
    with _RANGE("mbt.sync"):
        return _read(x)
