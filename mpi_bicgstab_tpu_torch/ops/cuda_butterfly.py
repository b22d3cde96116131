"""Butterfly SpMV kernels' wrappers (kernel source csrc/butterfly.cu;
counterpart of the Pallas kernels of mpi_bicgstab_tpu/ops/
pallas_butterfly.py).

`butterfly_k1(A, x)` and `butterfly_k2(A, mid)` route a vector of 4- or
8-byte elements (float32, float64, or int64: a DF vector's (hi, lo) pairs
packed by ops/butterfly_spmv.pack_df, so both planes move in one launch);
`butterfly_k3(A, z)` (float32, float64) and `butterfly_k3_df(A, z)` (DF
values, z the packed pairs) multiply the routed vector by the slab
values. Each `.launches`
counts its launches. They take CUDA tensors only and raise on anything
the kernel does not take: ops/butterfly_spmv.py routes CPU tensors to the
plain twins and runs the transposes and the tail.
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
_MOVE = {torch.float32: "b32", torch.float64: "b64", torch.int64: "b64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("butterfly")
    for name, argtypes in (("k1_b32", [_LL, _LL] + [_P] * 6),
                           ("k1_b64", [_LL, _LL] + [_P] * 6),
                           ("k2_b32", [_LL] + [_P] * 5),
                           ("k2_b64", [_LL] + [_P] * 5),
                           ("k3_f32", [_LL, _I, _I] + [_P] * 6),
                           ("k3_f64", [_LL, _I, _I] + [_P] * 6),
                           ("k3_df", [_LL, _I, _I] + [_P] * 8)):
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


def butterfly_k1(A, x: torch.Tensor) -> torch.Tensor:
    """u1 [P * 1024]: window a copies the elements of x's window
    k1_src[a] its slots name (0 past the last column), on the card."""
    what = "butterfly_k1"
    sfx = _kind(what, x, _MOVE)
    _shape(what, "x", x, (A.n_cols,))
    _shape(what, "k1_src", A.k1_src, (A.P,))
    _route_tables(what, A, A.k1_sub, A.k1_lane)
    check_cuda(what, torch.int32, k1_src=A.k1_src)
    check_cuda(what, x.dtype, x=x)
    u1 = x.new_empty(A.P * 1024)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k1_{sfx}")(
        A.P, A.n_cols, A.k1_src.data_ptr(), A.k1_sub.data_ptr(),
        A.k1_lane.data_ptr(), x.data_ptr(), u1.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k1.launches += 1
    return u1


butterfly_k1.launches = 0


def butterfly_k2(A, mid: torch.Tensor) -> torch.Tensor:
    """z1 [P * 1024]: mid permuted inside each window, on the card."""
    what = "butterfly_k2"
    sfx = _kind(what, mid, _MOVE)
    _shape(what, "mid", mid, (A.P * 1024,))
    _route_tables(what, A, A.k2_sub, A.k2_lane)
    check_cuda(what, mid.dtype, mid=mid)
    z1 = torch.empty_like(mid)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k2_{sfx}")(
        A.P, A.k2_sub.data_ptr(), A.k2_lane.data_ptr(), mid.data_ptr(),
        z1.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k2.launches += 1
    return z1


butterfly_k2.launches = 0


def _k3_tables(what: str, A, vals_halves, z_halves) -> None:
    """The slab tables [W//8, 8, NR, 128] and z [P * 1024] (covering every
    row tile's stacked windows) as the kernel takes them."""
    shape = (A.width // 8, 8, A.n_pad // 128, 128)
    for name, t in (("k3_sub", A.k3_sub), ("k3_lane", A.k3_lane),
                    *vals_halves):
        _shape(what, name, t, shape)
    for name, t in z_halves:
        _shape(what, name, t, (A.P * 1024,))
    if A.n_pad // A.rb > A.P:
        raise ValueError(f"{what}: {A.n_pad // A.rb} destination windows "
                         f"but P = {A.P}")
    check_cuda(what, torch.int8, k3_sub=A.k3_sub, k3_lane=A.k3_lane)


def butterfly_k3(A, z: torch.Tensor) -> torch.Tensor:
    """y [n_pad] = the slab part of A x from the routed vector z (float32
    or float64 values and z of the same dtype), on the card."""
    what = "butterfly_k3"
    if is_df(A.k3_vals):
        raise TypeError(f"{what}: DF values take butterfly_k3_df")
    sfx = _kind(what, z, _SUFFIX)
    _k3_tables(what, A, (("k3_vals", A.k3_vals),), (("z", z),))
    check_cuda(what, z.dtype, k3_vals=A.k3_vals, z=z)
    y = z.new_empty(A.n_pad)
    lib = _lib()
    err = getattr(lib, f"mbt_bfly_k3_{sfx}")(
        A.n_pad, A.width, A.rb, A.k3_sub.data_ptr(), A.k3_lane.data_ptr(),
        A.k3_vals.data_ptr(), z.data_ptr(), y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k3.launches += 1
    return y


butterfly_k3.launches = 0


def butterfly_k3_df(A, z: torch.Tensor) -> DF:
    """The DF slab part of A x [n_pad] from the routed pairs z (int64
    [P * 1024], each a packed (hi, lo); A.k3_vals a DF pair), on the
    card; bit-equal to its twin."""
    what = "butterfly_k3_df"
    if not is_df(A.k3_vals):
        raise TypeError(f"{what}: A.k3_vals must be a DF pair")
    v = A.k3_vals
    _k3_tables(what, A, (("k3_vals.hi", v.hi), ("k3_vals.lo", v.lo)),
               (("z", z),))
    check_cuda(what, torch.float32, vals_hi=v.hi, vals_lo=v.lo)
    check_cuda(what, torch.int64, z=z)
    y = DF(v.hi.new_empty(A.n_pad), v.hi.new_empty(A.n_pad))
    lib = _lib()
    err = lib.mbt_bfly_k3_df(
        A.n_pad, A.width, A.rb, A.k3_sub.data_ptr(), A.k3_lane.data_ptr(),
        v.hi.data_ptr(), v.lo.data_ptr(), z.data_ptr(), y.hi.data_ptr(),
        y.lo.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    butterfly_k3_df.launches += 1
    return y


butterfly_k3_df.launches = 0
