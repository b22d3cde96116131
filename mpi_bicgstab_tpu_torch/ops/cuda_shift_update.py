"""Fused df32 shift update of the seed-switching solver: the CUDA kernel's
wrapper and its plain PyTorch twin (counterpart of
mpi_bicgstab_tpu/ops/pallas_shift_update.py; kernel source
csrc/shift_update_df.cu).

One pass over the double-float [S, n] x_set / p_set state applies the
three update stages of one iteration (shifted_switching_solver.c:429-445):

    x'    = x + df_fma(cxp p, cxq, q)
    p_mid = p + df_fma(cpq q, cpr, r_old)
    p'    = df_fma(m1 p_mid, m2, r_new)

with six DF [S] coefficients into which the caller folded the active
mask (stopped and seed rows: 0, 0, 0, 0, 1, 0, which leave them
bit-unchanged). The association is the JAX package's XLA branch of
solvers/switching._switching_loop, so the twin, the kernel and that
branch compute the same pairs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_cuda, stream_arg
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_add, df_fma, df_mul, is_df
from mpi_bicgstab_tpu_torch.utils.timing import span

_P = ctypes.c_void_p
_COEFS = ("cxp", "cxq", "cpq", "cpr", "m1", "m2")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("shift_update_df")
    lib.mbt_shift_update_df.argtypes = [ctypes.c_longlong,
                                        ctypes.c_longlong] + [_P] * 12
    lib.mbt_shift_update_df.restype = ctypes.c_int
    return lib


def fused_shift_update_df_plain(x_set: DF, p_set: DF, q: DF, r_old: DF,
                                r_new: DF, cxp: DF, cxq: DF, cpq: DF,
                                cpr: DF, m1: DF, m2: DF):
    """The three stages as DF operators on fresh pairs (the twin); returns
    (x_set', p_set'). The function is independent per shift row, so it
    may be applied to slices of rows."""
    col = lambda c: c[:, None]                              # noqa: E731
    row = lambda v: v[None, :]                              # noqa: E731
    x2 = df_add(x_set, df_fma(df_mul(col(cxp), p_set), col(cxq), row(q)))
    pm = df_add(p_set, df_fma(df_mul(col(cpq), row(q)), col(cpr),
                              row(r_old)))
    p2 = df_fma(df_mul(col(m1), pm), col(m2), row(r_new))
    return x2, p2


def _check(what, state: dict, vecs: dict, coefs: dict) -> tuple[int, int]:
    """Every argument a DF pair of float32 CUDA tensors on one device,
    contiguous, the state [S, n], the vectors [n], the coefficients [S].
    Returns (S, n)."""
    if not all(is_df(v) for d in (state, vecs, coefs) for v in d.values()):
        raise TypeError(f"{what}: every argument must be a DF pair")
    if state["x_set"].hi.dim() != 2:
        raise ValueError(f"{what}: x_set must be [S, n], got "
                         f"{tuple(state['x_set'].shape)}")
    S, n = state["x_set"].hi.shape
    parts = {}
    for d, want in ((state, (S, n)), (vecs, (n,)), (coefs, (S,))):
        for name, v in d.items():
            for half, t in (("hi", v.hi), ("lo", v.lo)):
                if tuple(t.shape) != want:
                    raise ValueError(f"{what}: {name}.{half} has shape "
                                     f"{tuple(t.shape)}, expected {want}")
                parts[f"{name}.{half}"] = t
    check_cuda(what, torch.float32, **parts)
    return S, n


def fused_shift_update_df(x_set: DF, p_set: DF, q: DF, r_old: DF, r_new: DF,
                          cxp: DF, cxq: DF, cpq: DF, cpr: DF, m1: DF,
                          m2: DF):
    """Apply one iteration's masked shift updates to the DF [S, n] state
    IN PLACE and return (x_set, p_set), the same pairs. The update is in
    place on either device, as the Pallas kernel's is through
    input_output_aliases: at S = 512 and n = 1,602,112 the state is
    13.1 GB, so no copy is made, and the caller (the switching loop owns
    its state) must clone what it wants to keep. CPU tensors take the
    plain twin (written back into the state); CUDA tensors the kernel,
    which computes the twin's bits, or raise."""
    with span("mbt.launch.fused_shift_update_df"):
        what = "fused_shift_update_df"
        if x_set.device.type == "cpu":
            x2, p2 = fused_shift_update_df_plain(x_set, p_set, q, r_old,
                                                 r_new, cxp, cxq, cpq, cpr,
                                                 m1, m2)
            for dst, src in ((x_set, x2), (p_set, p2)):
                dst.hi.copy_(src.hi)
                dst.lo.copy_(src.lo)
            return x_set, p_set
        coefs = dict(zip(_COEFS, (cxp, cxq, cpq, cpr, m1, m2)))
        S, n = _check(what, {"x_set": x_set, "p_set": p_set},
                      {"q": q, "r_old": r_old, "r_new": r_new}, coefs)
        coef_ptrs = (_P * 12)(*(t.data_ptr() for c in coefs.values()
                                for t in (c.hi, c.lo)))
        lib = _lib()
        err = lib.mbt_shift_update_df(
            S, n, *(t.data_ptr() for t in (x_set.hi, x_set.lo, p_set.hi,
                                           p_set.lo, q.hi, q.lo, r_old.hi,
                                           r_old.lo, r_new.hi, r_new.lo)),
            coef_ptrs, stream_arg())
        _build.check(lib, err, what)
        fused_shift_update_df.launches += 1
        return x_set, p_set


fused_shift_update_df.launches = 0
