"""Wall-clock and per-phase timing (counterpart of
mpi_bicgstab_tpu/utils/timing.py).

The reference hand-rolls section timers behind its MEASURE_TIME /
MEASURE_SECTION_TIME compile flags (solver.c:6,129-140;
shifted_switching_solver.c:9,338-342,994-1005). Here they are a small
runtime utility. A timer stopped with a result first waits for the card
to finish the work behind it (torch.cuda.synchronize on each CUDA
device the result's tensors live on), which plays the role MPI_Wtime
and the reference's implicit synchronisation played there; a result on
the CPU needs no wait.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name, None))


def sync(x):
    """Wait for the card to finish the work that produces x (a tensor, a
    DF pair, a result dataclass, or a list, tuple or dict of them)."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class Timer:
    """Fenced wall-clock timer (reference MPI_Wtime, solver.c:70,130)."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None):
        if result is not None:
            sync(result)
        self.elapsed += time.perf_counter() - self._t0
        return self.elapsed


class PhaseTimer:
    """Accumulating per-phase timer (reference MEASURE_SECTION_TIME,
    shifted_switching_solver.c:678-695,884-892).

    Usage::

        pt = PhaseTimer()
        with pt.phase("spmv"):
            sync(spmv(A, x))
        pt.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def csv_row(self):
        keys = sorted(self.totals)
        return ",".join(f"{self.totals[k]:.6e}" for k in keys), keys

    def report(self, println=print):
        for k in sorted(self.totals):
            avg = self.totals[k] / max(1, self.counts[k])
            println(f"{k:>16s}: total {self.totals[k]:.6e} s, "
                    f"calls {self.counts[k]}, avg {avg:.6e} s")
