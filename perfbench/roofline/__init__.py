"""Kernel groups: the bytes and operations of each launch, computed from
the cell's shapes (each input byte read once, each output written once),
one module per group, and the share of the roofline a trace shows.

A group module defines KERNELS: a list of (regex over the kernel's name
in the profiler's trace, work(shapes) -> (bytes, flops, kind)). shapes
holds n, n_diags, band_entries and, where the cell has them, n_shifts
and degree.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

from perfbench.peaks import least_seconds

HERE = Path(__file__).resolve().parent
# operations of one double-float operation in float32 arithmetic
DF_FMA_FLOPS, DF_DOT_FLOPS, DF_MUL_FLOPS, DF_ADD_FLOPS = 18, 15, 10, 20


def load(group: str):
    path = HERE / f"{group}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_roofline_{group}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel(name: str) -> str:
    """A regex for a kernel of this exact name (no longer name that
    contains it)."""
    return rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])"


def share_pct(group: str, shapes: dict, device_events) -> float | None:
    """100 x (least time of every traced launch of the group) / (their
    traced time), from (name, start_us, dur_us) device events; None when
    no launch of the group is in the trace."""
    kernels = [(re.compile(rx), work) for rx, work in load(group).KERNELS]
    least = spent = 0.0
    for name, _, dur in device_events:
        for rx, work in kernels:
            if rx.search(name):
                least += least_seconds(*work(shapes))
                spent += dur * 1e-6
                break
    if spent <= 0.0:
        return None
    return 100.0 * least / spent
