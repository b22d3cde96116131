"""The Chebyshev chain x = p(A) v as one kernel launch, float32 and
double-float (counterpart of mpi_bicgstab_tpu/ops/pallas_cheby.py and
pallas_cheby_df.py; kernel source csrc/cheby.cu).

`cheby_chain(vals, v, offsets, degree, lo, hi)` and `cheby_chain_df(...)`
run their plain twin, ops/cheby.cheby_apply over dia_spmv_plain /
dia_spmv_df_plain, for tensors on the CPU and launch the kernel for
tensors on the card; a CUDA tensor the kernel does not take raises.
`.launches` counts kernel launches. The coefficients come from
ops/cheby._coeffs in host float64 and travel by value in the launch (DF:
split into full-precision pairs), so nothing is copied to the device.

The kernel runs the chain's steps as tasks (step, row tile), each waiting
only for the previous step on the tiles within its reach (the design is
in csrc/cheby.cu). `chain_plan` is its schedule, computed here and passed
by value: the tile (the most rows a task can take while every resident
block still gets a task at each step) and the reach, the tiles each side
whose previous step a task needs. `kernel_info` reads the kernel's
registers and resident blocks per SM, `resident_blocks` the grid.

`format_ok` takes every square DiaMatrix with float32 values (DF values
for the DF chain) at degree 1..MAX_DEGREE. Deliberately, it has no copy of
the JAX kernels' VMEM budget and 2x window-efficiency gate
(pallas_cheby.py:68-102, pallas_cheby_df.py:41-66): those describe a TPU
chunk window, and on the 1.6M-row generators at degree 8 they would
refuse every operator and leave the kernels unreachable.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cheby import _coeffs, cheby_apply, split_const
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (check_band, check_cuda,
                                                  check_vectors,
                                                  dia_spmv_df_plain,
                                                  dia_spmv_plain,
                                                  offsets_arg, stream_arg)
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df
from mpi_bicgstab_tpu_torch.utils.timing import span

MAX_DEGREE = 64      # MBT_MAX_CHEBY_DEGREE of csrc/cheby.cu
_P = ctypes.c_void_p

# the rows a task may take, largest first: on an H100 the largest that
# filled the grid was the fastest, 1,024 at 1.6M rows (512 within 2%) and
# 256 at 300K (chip_smoke.py --chain-times; PERF.md §6)
TILES = (1024, 512, 256)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cheby")
    head = [_P, ctypes.c_int, ctypes.c_longlong]
    lib.mbt_cheby_chain_f32.argtypes = head + [_P] * 3 + [ctypes.c_int] \
        + [_P] * 5
    lib.mbt_cheby_chain_df.argtypes = head + [_P] * 5 + [ctypes.c_int] \
        + [_P] * 6
    lib.mbt_cheby_kernel_info.argtypes = [ctypes.c_int] + [_P] * 3
    for fn in (lib.mbt_cheby_chain_f32, lib.mbt_cheby_chain_df,
               lib.mbt_cheby_kernel_info):
        fn.restype = ctypes.c_int
    return lib


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """The chain kernel's schedule (csrc/cheby.cu, struct ChainPlan).

    tile: rows of a task; n_tiles: ceil(n / tile); reach: tiles each side
    of a task whose previous step it needs."""

    tile: int
    n_tiles: int
    reach: int

    def arg(self) -> ctypes.Array:
        return (ctypes.c_int * 3)(self.tile, self.n_tiles, self.reach)


@functools.cache
def chain_plan(n: int, offsets: tuple, grid: int,
               tiles: tuple = TILES) -> ChainPlan:
    """The schedule of a chain over an n-row band with these offsets on a
    grid of `grid` resident blocks: the largest tile of `tiles` that cuts
    the rows into at least `grid` tiles (the smallest when none does), and
    reach = ceil(widest in-range |offset| / tile)."""
    tile = next((t for t in tiles if -(-n // t) >= grid), tiles[-1])
    widest = max((abs(o) for o in offsets if abs(o) < n), default=0)
    return ChainPlan(tile, -(-n // tile), -(-widest // tile))


def kernel_info(df: bool) -> dict:
    """The chain kernel's registers a thread, resident blocks per SM and
    the card's SM count (cudaFuncGetAttributes and the occupancy query
    the launcher uses)."""
    lib = _lib()
    regs, per_sm, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.mbt_cheby_kernel_info(int(df), ctypes.byref(regs),
                                    ctypes.byref(per_sm), ctypes.byref(sms))
    _build.check(lib, err, "cheby kernel_info")
    return {"regs": regs.value, "blocks_per_sm": per_sm.value,
            "sms": sms.value}


@functools.cache
def resident_blocks(index: int, df: bool) -> int:
    """Blocks of the chain kernel resident at once on card `index`."""
    with torch.cuda.device(index):
        info = kernel_info(df)
    return info["blocks_per_sm"] * info["sms"]


def format_ok(A, dtype, degree: int) -> bool:
    """Does a chain kernel take this operator at this dtype and degree?
    A square DiaMatrix with float32 values or DF values (whose config
    dtype is float32 too), 1 <= degree <= MAX_DEGREE."""
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    return (isinstance(A, DiaMatrix) and dtype == torch.float32
            and (is_df(A.vals) or A.vals.dtype == torch.float32)
            and A.n_rows == A.n_cols and A.n_diags >= 1
            and 1 <= degree <= MAX_DEGREE)


@functools.cache
def _coeff_arg(degree: int, lo: float, hi: float, df: bool) -> ctypes.Array:
    """The launch's host coefficients: inv_theta, then (c_d, c_r) per
    step, as floats (each a (hi, lo) pair for DF)."""
    inv_theta, pairs = _coeffs(degree, lo, hi)
    flat = [inv_theta] + [c for pair in pairs for c in pair]
    if df:
        flat = [h for c in flat for h in split_const(c)]
    return (ctypes.c_float * len(flat))(*flat)


def _check(what: str, vals, v, offsets, degree: int) -> int:
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"{what}: degree {degree}, the kernel takes 1 to "
                         f"{MAX_DEGREE}")
    n = v.shape[0]
    if len(v.shape) != 1:
        raise ValueError(f"{what}: v must be 1-D, got {tuple(v.shape)}")
    for band in ((vals.hi, vals.lo) if is_df(vals) else (vals,)):
        check_band(what, band, offsets, n)
    return n


def cheby_chain_plain(vals, v, offsets: tuple, degree: int, lo: float,
                      hi: float):
    return cheby_apply(lambda u: dia_spmv_plain(vals, offsets, u), v,
                       degree, lo, hi)


def cheby_chain(vals, v, offsets: tuple, degree: int, lo: float,
                hi: float):
    """x = p(A) v, float32: the degree-`degree` Chebyshev iteration on
    [lo, hi] over the DIA band (vals [W, n], offsets)."""
    with span("mbt.launch.cheby_chain"):
        if v.device.type == "cpu":
            return cheby_chain_plain(vals, v, offsets, degree, lo, hi)
        what = "cheby_chain"
        if is_df(vals) or is_df(v):
            raise TypeError(f"{what}: float32 tensors expected; DF pairs "
                            f"take cheby_chain_df")
        check_cuda(what, torch.float32, vals=vals, v=v)
        n = _check(what, vals, v, offsets, degree)
        p = chain_plan(n, tuple(offsets),
                       resident_blocks(v.device.index, False))
        x = torch.empty_like(v)
        scratch = v.new_empty((3, n))
        work = torch.zeros(p.n_tiles + 1, dtype=torch.int32, device=v.device)
        lib = _lib()
        err = lib.mbt_cheby_chain_f32(
            offsets_arg(offsets), len(offsets), n, vals.data_ptr(),
            v.data_ptr(), _coeff_arg(degree, lo, hi, False), degree, p.arg(),
            x.data_ptr(), scratch.data_ptr(), work.data_ptr(), stream_arg())
        _build.check(lib, err, what)
        cheby_chain.launches += 1
        return x


cheby_chain.launches = 0


def cheby_chain_df_plain(vals: DF, v: DF, offsets: tuple, degree: int,
                         lo: float, hi: float) -> DF:
    return cheby_apply(lambda u: dia_spmv_df_plain(vals, offsets, u), v,
                       degree, lo, hi)


def cheby_chain_df(vals: DF, v: DF, offsets: tuple, degree: int,
                   lo: float, hi: float) -> DF:
    """x = p(A) v in double-float, with full-precision DF coefficients;
    the kernel agrees with its twin bit for bit."""
    with span("mbt.launch.cheby_chain_df"):
        if v.device.type == "cpu":
            return cheby_chain_df_plain(vals, v, offsets, degree, lo, hi)
        what = "cheby_chain_df"
        if not (is_df(vals) and is_df(v)):
            raise TypeError(f"{what}: vals and v must be DF pairs")
        check_cuda(what, torch.float32, vals_hi=vals.hi, vals_lo=vals.lo,
                   v_hi=v.hi, v_lo=v.lo)
        n = _check(what, vals, v, offsets, degree)
        check_vectors(what, n, v_lo=v.lo)
        p = chain_plan(n, tuple(offsets),
                       resident_blocks(v.hi.device.index, True))
        x = DF(torch.empty_like(v.hi), torch.empty_like(v.hi))
        scratch = v.hi.new_empty((6, n))
        work = torch.zeros(p.n_tiles + 1, dtype=torch.int32,
                           device=v.hi.device)
        lib = _lib()
        err = lib.mbt_cheby_chain_df(
            offsets_arg(offsets), len(offsets), n, vals.hi.data_ptr(),
            vals.lo.data_ptr(), v.hi.data_ptr(), v.lo.data_ptr(),
            _coeff_arg(degree, lo, hi, True), degree, p.arg(),
            x.hi.data_ptr(), x.lo.data_ptr(), scratch.data_ptr(),
            work.data_ptr(), stream_arg())
        _build.check(lib, err, what)
        cheby_chain_df.launches += 1
        return x


cheby_chain_df.launches = 0
