"""Batched DIA SpMV Y[l] = A X[l] over k right-hand-side lanes, float32
(counterpart of mpi_bicgstab_tpu/ops/pallas_batched_spmv.py; kernel
source csrc/batched_spmv.cu).

`batched_dia_spmv(vals, offsets, X)` takes X as [k, n] with 1 <= k <= 8
and reads the band once for all k lanes. It runs the plain version for
tensors on the CPU and launches the kernel for tensors on the card; a
CUDA tensor the kernel does not take raises. `.launches` counts kernel
launches. `check_planes` and `lanes_pass` check and launch the fused
batched passes of ops/cuda_fused_batched.py.

Unlike the JAX kernel this one needs no padding to the 8192-row grid: it
skips out-of-range columns.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (check_band, check_cuda,
                                                  grid_blocks, offsets_arg,
                                                  stream_arg)

_P = ctypes.c_void_p
MAX_LANES = 8      # csrc/batched_core.cuh MBT_MAX_LANES
MAX_DIAGS = 64     # csrc/dia_core.cuh MBT_MAX_DIAGS (the card tests hold
                   # both to the libraries' own values)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("batched_spmv")
    fn = lib.mbt_batched_dia_spmv_f32
    fn.argtypes = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    lib.mbt_max_lanes.restype = ctypes.c_int
    return lib


def format_ok(A, dtype, k: int) -> bool:
    """Does the batched route take this operator at this solver dtype for
    k lanes? A float32 square DiaMatrix of 1 to MAX_DIAGS diagonals, and
    1 <= k <= MAX_LANES. The JAX package's VMEM budgets
    (pallas_batched_spmv.py:47-75) do not apply on the card: a thread
    holds its k accumulators in registers and nothing is staged."""
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    return (isinstance(A, DiaMatrix) and dtype == torch.float32
            and torch.is_tensor(A.vals) and A.vals.dtype == torch.float32
            and A.n_rows == A.n_cols and 1 <= A.n_diags <= MAX_DIAGS
            and 1 <= k <= MAX_LANES)


def check_planes(what: str, k: int, n: int, **planes) -> None:
    """Every plane must be [k, n] with 1 <= k <= MAX_LANES."""
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"{what}: {k} lanes, the kernel takes 1 to "
                         f"{MAX_LANES}")
    for name, t in planes.items():
        if t.shape != (k, n):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected ({k}, {n})")


def lanes_pass(lib, symbol: str, what: str, vals, offsets, planes: dict,
               scalars: dict, n_out: int, n_dots: int):
    """Check and launch a fused batched pass whose C launcher takes
    ([offsets, n_diags,] n, k, [vals,] *planes, *scalars, *outputs,
    partials, dots, stream), in the dicts' order; vals None is a
    pointwise pass. Every plane is [k, n], every scalar [k]. Returns
    (outputs, dots): n_out fresh [k, n] planes (never aliasing an input)
    and n_dots per-lane dots, each a [k] view."""
    first = next(iter(planes.values()))
    if first.dim() != 2:
        raise ValueError(f"{what}: planes must be [k, n], got "
                         f"{tuple(first.shape)}")
    k, n = first.shape
    check_planes(what, k, n, **planes)
    for name, t in scalars.items():
        if t.shape != (k,):
            raise ValueError(f"{what}: scalar {name} has shape "
                             f"{tuple(t.shape)}, expected ({k},)")
    band = {} if vals is None else {"vals": vals}
    check_cuda(what, torch.float32, **band, **planes, **scalars)
    head = [n, k]
    if vals is not None:
        check_band(what, vals, offsets, n)
        head = [offsets_arg(offsets), len(offsets), n, k, vals.data_ptr()]
    outs = [torch.empty_like(first) for _ in range(n_out)]
    partials = first.new_empty((grid_blocks(n), n_dots * k))
    dots = first.new_empty((n_dots, k))
    err = getattr(lib, symbol)(
        *head, *(t.data_ptr() for t in (*planes.values(), *scalars.values(),
                                        *outs, partials, dots)),
        stream_arg())
    _build.check(lib, err, what)
    return outs, list(dots)


def batched_dia_spmv_plain(vals: torch.Tensor, offsets: tuple,
                           X: torch.Tensor) -> torch.Tensor:
    """Y = A X per lane as pad-plus-slice: X padded with zeros along its
    rows, one shifted slice per diagonal (the batched form of
    cuda_spmv.dia_spmv_plain)."""
    n = X.shape[1]
    lo = -min(0, min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    xp = F.pad(X, (lo, hi))
    acc = torch.zeros_like(X)
    for w, o in enumerate(offsets):
        acc = acc + vals[w] * xp[:, lo + o:lo + o + n]
    return acc


def batched_dia_spmv(vals: torch.Tensor, offsets: tuple,
                     X: torch.Tensor) -> torch.Tensor:
    """Y = A X for every lane of X [k, n] (vals [W, n], offsets), float32.
    CPU tensors take the plain version; CUDA tensors the kernel, which
    reads the band once for all lanes."""
    if X.device.type == "cpu":
        return batched_dia_spmv_plain(vals, offsets, X)
    what = "batched_dia_spmv"
    if X.dim() != 2:
        raise ValueError(f"{what}: X must be [k, n], got {tuple(X.shape)}")
    k, n = X.shape
    check_planes(what, k, n, X=X)
    check_cuda(what, torch.float32, vals=vals, X=X)
    check_band(what, vals, offsets, n)
    Y = torch.empty_like(X)
    lib = _lib()
    err = lib.mbt_batched_dia_spmv_f32(
        offsets_arg(offsets), len(offsets), n, k, vals.data_ptr(),
        X.data_ptr(), Y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    batched_dia_spmv.launches += 1
    return Y


batched_dia_spmv.launches = 0
