"""Windowed-ELL SpMV kernels' wrappers (kernel source csrc/window_spmv.cu;
counterpart of the Pallas kernels of mpi_bicgstab_tpu/ops/
pallas_window_spmv.py).

`window_slabs(A, x)` (float32, float64) and `window_slabs_df(A, x)`
(double-float pairs) launch the kernel that computes the slab part of
y = A x for a WindowEllMatrix on the card; each `.launches` counts its
launches. They take CUDA tensors only and raise on anything the kernel
does not take: ops/window_spmv.py routes CPU tensors to the plain twins
(window_slabs_plain, window_slabs_df_plain) and adds the COO tail.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_cuda, stream_arg
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df

_P = ctypes.c_void_p
_KERNELS = {torch.float32: "mbt_window_spmv_f32",
            torch.float64: "mbt_window_spmv_f64"}
_HEAD = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_spmv")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = _HEAD + [_P] * 7
        fn.restype = ctypes.c_int
    lib.mbt_window_spmv_df.argtypes = _HEAD + [_P] * 10
    lib.mbt_window_spmv_df.restype = ctypes.c_int
    return lib


def _check_layout(what: str, A, vals_halves, x_halves) -> None:
    """The layout's arrays and x as the kernel takes them: [W, T, 8, 128]
    index planes of int8 and value planes, int32 window bases [T], x of
    n_cols entries, all on the current CUDA device and contiguous."""
    shape = (A.width, A.n_tiles, 8, 128)
    for name, t in (("sub_sel", A.sub_sel), ("lane_idx", A.lane_idx),
                    *vals_halves):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if A.n_rows != A.n_tiles * 1024:
        raise ValueError(f"{what}: n_rows {A.n_rows} is not 1024 x "
                         f"{A.n_tiles} tiles")
    for name, t in x_halves:
        if tuple(t.shape) != (A.n_cols,):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected ({A.n_cols},)")
    check_cuda(what, torch.int8, sub_sel=A.sub_sel, lane_idx=A.lane_idx)
    check_cuda(what, torch.int32, window_base=A.window_base)


def window_slabs(A, x: torch.Tensor) -> torch.Tensor:
    """The slab part of y = A x (no tail) for a WindowEllMatrix A with
    float32 or float64 values and x of the same dtype, on the card."""
    what = "window_slabs"
    if x.dtype not in _KERNELS:
        raise TypeError(f"{what}: dtype {x.dtype}, the kernel takes "
                        f"float32 or float64")
    _check_layout(what, A, (("vals", A.vals),), (("x", x),))
    check_cuda(what, x.dtype, vals=A.vals, x=x)
    y = x.new_empty(A.n_rows)
    lib = _lib()
    err = getattr(lib, _KERNELS[x.dtype])(
        A.n_tiles, A.width, A.n_cols, A.sub_sel.data_ptr(),
        A.lane_idx.data_ptr(), A.vals.data_ptr(), A.window_base.data_ptr(),
        x.data_ptr(), y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    window_slabs.launches += 1
    return y


window_slabs.launches = 0


def window_slabs_df(A, x: DF) -> DF:
    """Double-float slab part of y = A x (A.vals and x DF pairs), on the
    card; bit-equal to window_slabs_df_plain."""
    what = "window_slabs_df"
    if not (is_df(A.vals) and is_df(x)):
        raise TypeError(f"{what}: A.vals and x must be DF pairs")
    _check_layout(what, A, (("vals.hi", A.vals.hi), ("vals.lo", A.vals.lo)),
                  (("x.hi", x.hi), ("x.lo", x.lo)))
    check_cuda(what, torch.float32, vals_hi=A.vals.hi, vals_lo=A.vals.lo,
               x_hi=x.hi, x_lo=x.lo)
    y = DF(x.hi.new_empty(A.n_rows), x.hi.new_empty(A.n_rows))
    lib = _lib()
    err = lib.mbt_window_spmv_df(
        A.n_tiles, A.width, A.n_cols, A.sub_sel.data_ptr(),
        A.lane_idx.data_ptr(), A.vals.hi.data_ptr(), A.vals.lo.data_ptr(),
        A.window_base.data_ptr(), x.hi.data_ptr(), x.lo.data_ptr(),
        y.hi.data_ptr(), y.lo.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    window_slabs_df.launches += 1
    return y


window_slabs_df.launches = 0
