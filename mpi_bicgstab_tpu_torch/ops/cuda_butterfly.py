"""Butterfly SpMV kernels' wrappers (kernel source csrc/butterfly.cu;
counterpart of the Pallas kernels of mpi_bicgstab_tpu/ops/
pallas_butterfly.py).

`butterfly_k1(A, x)` and `butterfly_k2(A, mid)` route a vector of 4- or
8-byte elements (int32, float32, float64, or int64: any element's bits),
each writing its output in the transposed order (JAX's K1 followed by its
transpose T1, K2 by T2); `butterfly_decode(A, z)` turns the routed int32
iota z into the column table. The layout's column table is the iota
routed through K1 and K2 and decoded, once per layout
(ops/butterfly_spmv.column_table). `butterfly_k3(A, x)` (float32,
float64) and `butterfly_k3_df(A, x)` (DF values and x) multiply x,
gathered through A.k3_col, by the slab values: one launch per SpMV (a
thread owns 1 row in float32, 2 in float64 and DF: csrc/butterfly.cu).
Each `.launches` counts its launches. They take CUDA tensors only and
raise on anything the kernel does not take: ops/butterfly_spmv.py sends
CPU tensors to the plain twins and runs the tail.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_cuda, stream_arg
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df

_P = ctypes.c_void_p
_LL, _I = ctypes.c_longlong, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# K1 and K2 move bits: the element size picks the kernel
_MOVE = {torch.int32: "b32", torch.float32: "b32", torch.float64: "b64",
         torch.int64: "b64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("butterfly")
    for name, argtypes in (("k1_b32", [_LL, _LL] + [_P] * 6),
                           ("k1_b64", [_LL, _LL] + [_P] * 6),
                           ("k2_b32", [_LL] + [_P] * 5),
                           ("k2_b64", [_LL] + [_P] * 5),
                           ("decode", [_LL, _I, _I, _I] + [_P] * 5),
                           ("k3_f32", [_LL, _I] + [_P] * 5),
                           ("k3_f64", [_LL, _I] + [_P] * 5),
                           ("k3_df", [_LL, _I] + [_P] * 7)):
        fn = getattr(lib, f"mbt_bfly_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _kind(what: str, t: torch.Tensor, kinds: dict) -> str:
    if t.dtype not in kinds:
        raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes "
                        f"{', '.join(str(d) for d in kinds)}")
    return kinds[t.dtype]


def _shape(what: str, name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _route_tables(what: str, A, sub, lane) -> None:
    for name, t in (("sub", sub), ("lane", lane)):
        _shape(what, name, t, (A.P, 8, 128))
    check_cuda(what, torch.int8, sub=sub, lane=lane)


def _aligned(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def butterfly_k1(A, x: torch.Tensor) -> torch.Tensor:
    """mid [P * 1024], mid[e * P + a] = slot e of u1's window a, which
    copies the element of x's window k1_src[a] the slot names (0 past the
    last column): K1 and T1, on the card."""
    what = "butterfly_k1"
    sfx = _kind(what, x, _MOVE)
    _shape(what, "x", x, (A.n_cols,))
    _shape(what, "k1_src", A.k1_src, (A.P,))
    _route_tables(what, A, A.k1_sub, A.k1_lane)
    check_cuda(what, torch.int32, k1_src=A.k1_src)
    check_cuda(what, x.dtype, x=x)
    _aligned(what, x=x, k1_sub=A.k1_sub, k1_lane=A.k1_lane)
    mid = x.new_empty(A.P * 1024)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k1_{sfx}")(
        A.P, A.n_cols, A.k1_src.data_ptr(), A.k1_sub.data_ptr(),
        A.k1_lane.data_ptr(), x.data_ptr(), mid.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k1.launches += 1
    return mid


butterfly_k1.launches = 0


def butterfly_k2(A, mid: torch.Tensor) -> torch.Tensor:
    """z [P * 1024], z[e * P + m] = slot e of mid's window m permuted:
    K2 and T2, on the card."""
    what = "butterfly_k2"
    sfx = _kind(what, mid, _MOVE)
    _shape(what, "mid", mid, (A.P * 1024,))
    _route_tables(what, A, A.k2_sub, A.k2_lane)
    check_cuda(what, mid.dtype, mid=mid)
    _aligned(what, mid=mid, k2_sub=A.k2_sub, k2_lane=A.k2_lane)
    z = torch.empty_like(mid)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k2_{sfx}")(
        A.P, A.k2_sub.data_ptr(), A.k2_lane.data_ptr(), mid.data_ptr(),
        z.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k2.launches += 1
    return z


butterfly_k2.launches = 0


def butterfly_decode(A, z: torch.Tensor) -> torch.Tensor:
    """k3_col, int32 [W//8, 8, NR, 128]: for each K3 slot the z element
    its lane and stacked sublane name (z: the int32 iota 1..n_cols routed
    by K1 and K2), less 1, on the card."""
    what = "butterfly_decode"
    _shape(what, "z", z, (A.P * 1024,))
    shape = (A.width // 8, 8, A.n_pad // 128, 128)
    for name, t in (("k3_sub", A.k3_sub), ("k3_lane", A.k3_lane)):
        _shape(what, name, t, shape)
    check_cuda(what, torch.int8, k3_sub=A.k3_sub, k3_lane=A.k3_lane)
    check_cuda(what, torch.int32, z=z)
    _aligned(what, k3_sub=A.k3_sub, k3_lane=A.k3_lane, z=z)
    col = torch.empty(shape, dtype=torch.int32, device=z.device)
    lib = _lib()
    err = lib.mbt_bfly_decode(
        A.n_pad, A.width, A.stack, A.rb, A.k3_sub.data_ptr(),
        A.k3_lane.data_ptr(), z.data_ptr(), col.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_decode.launches += 1
    return col


butterfly_decode.launches = 0


def _k3_tables(what: str, A, x_halves, vals_halves) -> None:
    """The column table and the values [W//8, 8, NR, 128], x [n_cols], as
    the kernel takes them."""
    shape = (A.width // 8, 8, A.n_pad // 128, 128)
    for name, t in (("k3_col", A.k3_col), *vals_halves):
        _shape(what, name, t, shape)
    for name, t in x_halves:
        _shape(what, name, t, (A.n_cols,))
    check_cuda(what, torch.int32, k3_col=A.k3_col)


def butterfly_k3(A, x: torch.Tensor) -> torch.Tensor:
    """y [n_pad] = the slab part of A x (float32 or float64 values and x
    [n_cols] of the same dtype), on the card."""
    what = "butterfly_k3"
    if is_df(A.k3_vals):
        raise TypeError(f"{what}: DF values take butterfly_k3_df")
    sfx = _kind(what, x, _SUFFIX)
    _k3_tables(what, A, (("x", x),), (("k3_vals", A.k3_vals),))
    check_cuda(what, x.dtype, k3_vals=A.k3_vals, x=x)
    y = x.new_empty(A.n_pad)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k3_{sfx}")(
        A.n_pad, A.width, A.k3_col.data_ptr(), A.k3_vals.data_ptr(),
        x.data_ptr(), y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k3.launches += 1
    return y


butterfly_k3.launches = 0


def butterfly_k3_df(A, x: DF) -> DF:
    """The DF slab part of A x [n_pad] (A.k3_vals and x [n_cols] DF
    pairs), on the card; x's pairs are packed side by side (one 8-byte
    gather a slot) before the launch. Bit-equal to its twin."""
    what = "butterfly_k3_df"
    if not is_df(A.k3_vals):
        raise TypeError(f"{what}: A.k3_vals must be a DF pair")
    if not is_df(x):
        raise TypeError(f"{what}: x must be a DF pair")
    v = A.k3_vals
    _k3_tables(what, A, (("x.hi", x.hi), ("x.lo", x.lo)),
               (("k3_vals.hi", v.hi), ("k3_vals.lo", v.lo)))
    packed = torch.stack((x.hi, x.lo), dim=-1)
    check_cuda(what, torch.float32, vals_hi=v.hi, vals_lo=v.lo,
               x_packed=packed)
    y = DF(v.hi.new_empty(A.n_pad), v.hi.new_empty(A.n_pad))
    lib = _lib()
    err = lib.mbt_bfly_k3_df(
        A.n_pad, A.width, A.k3_col.data_ptr(), v.hi.data_ptr(),
        v.lo.data_ptr(), packed.data_ptr(), y.hi.data_ptr(), y.lo.data_ptr(),
        stream_arg())
    _build.check(lib, err, what)
    butterfly_k3_df.launches += 1
    return y


butterfly_k3_df.launches = 0
