"""Windowed-ELL SpMV kernels' wrappers (kernel source csrc/window_spmv.cu;
counterpart of the Pallas kernels of mpi_bicgstab_tpu/ops/
pallas_window_spmv.py and the COO tail the JAX package adds after them).

`window_rows(A, x)` (float32, float64) and `window_rows_df(A, x)`
(double-float pairs) launch the kernel that computes the whole y = A x
for a WindowEllMatrix on the card, over its row-compacted copy (rc_off,
rc_col, rc_val); each `.launches` counts its launches. They take CUDA
tensors only and raise on anything the kernel does not take:
ops/window_spmv.py routes CPU tensors to the plain twins
(window_rows_plain, window_rows_df_plain).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_cuda, stream_arg
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df

_P = ctypes.c_void_p
_KERNELS = {torch.float32: "mbt_window_rows_f32",
            torch.float64: "mbt_window_rows_f64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_spmv")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_longlong] + [_P] * 6
        fn.restype = ctypes.c_int
    lib.mbt_window_rows_df.argtypes = [ctypes.c_longlong] + [_P] * 9
    lib.mbt_window_rows_df.restype = ctypes.c_int
    return lib


def _check_copy(what: str, A, vals_halves, x_halves) -> None:
    """The compacted copy and x as the kernel takes them: int64 rc_off of
    n_rows / 32 + 1 entries, int32 rc_col and value planes of one length,
    x of n_cols entries, all on the current CUDA device and contiguous."""
    n_off = A.n_rows // 32 + 1
    if A.n_rows % 32 or tuple(A.rc_off.shape) != (n_off,):
        raise ValueError(f"{what}: rc_off has shape {tuple(A.rc_off.shape)} "
                         f"for {A.n_rows} rows, expected ({n_off},)")
    slots = tuple(A.rc_col.shape)
    if len(slots) != 1:
        raise ValueError(f"{what}: rc_col has shape {slots}, expected 1-D")
    for name, t in vals_halves:
        if tuple(t.shape) != slots:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {slots}")
    for name, t in x_halves:
        if tuple(t.shape) != (A.n_cols,):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected ({A.n_cols},)")
    check_cuda(what, torch.int64, rc_off=A.rc_off)
    check_cuda(what, torch.int32, rc_col=A.rc_col)


def window_rows(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a WindowEllMatrix A with float32 or float64 values and
    x of the same dtype, on the card; bit-equal to window_rows_plain."""
    what = "window_rows"
    if x.dtype not in _KERNELS:
        raise TypeError(f"{what}: dtype {x.dtype}, the kernel takes "
                        f"float32 or float64")
    _check_copy(what, A, (("rc_val", A.rc_val),), (("x", x),))
    check_cuda(what, x.dtype, rc_val=A.rc_val, x=x)
    y = x.new_empty(A.n_rows)
    lib = _lib()
    err = getattr(lib, _KERNELS[x.dtype])(
        A.n_rows, A.rc_off.data_ptr(), A.rc_col.data_ptr(),
        A.rc_val.data_ptr(), x.data_ptr(), y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    window_rows.launches += 1
    return y


window_rows.launches = 0


def window_rows_df(A, x: DF) -> DF:
    """Double-float y = A x (A's values and x DF pairs), on the card;
    bit-equal to window_rows_df_plain."""
    what = "window_rows_df"
    if not (is_df(A.rc_val) and is_df(x)):
        raise TypeError(f"{what}: A's values and x must be DF pairs")
    _check_copy(what, A, (("rc_val.hi", A.rc_val.hi),
                          ("rc_val.lo", A.rc_val.lo)),
                (("x.hi", x.hi), ("x.lo", x.lo)))
    check_cuda(what, torch.float32, rc_val_hi=A.rc_val.hi,
               rc_val_lo=A.rc_val.lo, x_hi=x.hi, x_lo=x.lo)
    y = DF(x.hi.new_empty(A.n_rows), x.hi.new_empty(A.n_rows))
    lib = _lib()
    err = lib.mbt_window_rows_df(
        A.n_rows, A.rc_off.data_ptr(), A.rc_col.data_ptr(),
        A.rc_val.hi.data_ptr(), A.rc_val.lo.data_ptr(), x.hi.data_ptr(),
        x.lo.data_ptr(), y.hi.data_ptr(), y.lo.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    window_rows_df.launches += 1
    return y


window_rows_df.launches = 0
