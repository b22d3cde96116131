"""Fused batched classic-BiCGStab passes over k right-hand-side lanes,
float32, DIA operators (counterpart of
mpi_bicgstab_tpu/ops/pallas_fused_batched.py; kernel source
csrc/fused_batched.cu).

The three passes of ops/cuda_fused_classic.py, lane by lane, with the
band read once per pass for all lanes. Planes are [k, n] (1 <= k <= 8),
per-lane scalars [k] tensors on the device of the planes:

  K1b: p'_l = r_l + beta_l (p_l - omega_l s_l),  s'_l = A p'_l
       dots (r^_l, s'_l)
  K2b: q_l = r_l - alpha_l s'_l,  y_l = A q_l
       dots (q_l, y_l), (y_l, y_l)
  K3b: x'_l = x_l + alpha_l p'_l + omega_l q_l,  r'_l = q_l - omega_l y_l
       dots (r'_l, r'_l), (r^_l, r'_l)

K1b and K3b take a per-lane `active` flag (1.0 or 0.0): a frozen lane
gets its old values back, bit for bit (p' = p, s' = s in K1b; x' = x,
r' = q in K3b). K2b takes none: the solver loop runs a frozen lane with
alpha = 0, so that q = r exactly. The dots are those of the unmasked
values, as in the JAX kernels.

Each of fused_k1b / fused_k2b / fused_k3b runs its plain PyTorch twin for
CPU tensors and launches the kernel for CUDA tensors, or raises; its
`.launches` counts kernel launches. They take the operators and lane
counts of cuda_batched_spmv.format_ok. The JAX package's padded carry,
VMEM chunking and in-place outputs are TPU devices with no counterpart
here: the kernels skip out-of-range neighbours and write fresh outputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv import (
    batched_dia_spmv_plain, lanes_pass)

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_batched")
    band = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    sigs = {"mbt_fused_k1b_f32": band + [_P] * 13,
            "mbt_fused_k2b_f32": band + [_P] * 9,
            "mbt_fused_k3b_f32": [ctypes.c_longlong, ctypes.c_int]
            + [_P] * 13}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _named(what: str, names: tuple, scalars) -> dict:
    if len(scalars) != len(names):
        raise ValueError(f"{what}: expected scalars {names}, got "
                         f"{len(scalars)}")
    return dict(zip(names, scalars))


def _keep(active, new, old):
    """new on the active lanes, old (bit for bit) on the frozen ones."""
    return torch.where((active != 0)[:, None], new, old)


# --- K1b --------------------------------------------------------------------

def fused_k1b_plain(vals, R, P, S, R_hat, scalars, offsets):
    beta, omega, active = scalars
    P2 = R + beta[:, None] * (P - omega[:, None] * S)
    S2 = batched_dia_spmv_plain(vals, offsets, P2)
    return (_keep(active, P2, P), _keep(active, S2, S),
            (R_hat * S2).sum(1))


def fused_k1b(vals, R, P, S, R_hat, scalars, offsets: tuple):
    """scalars = (beta, omega, active), each [k]. Returns (P2, S2, rhTs):
    P2 = R + beta (P - omega S) and S2 = A P2 on the active lanes, P and S
    on the frozen ones; rhTs [k] = (r^_l, A p'_l)."""
    if R.device.type == "cpu":
        return fused_k1b_plain(vals, R, P, S, R_hat, scalars, offsets)
    what = "fused_k1b"
    (P2, S2), (rhTs,) = lanes_pass(
        _lib(), "mbt_fused_k1b_f32", what, vals, offsets,
        dict(r=R, p=P, s=S, r_hat=R_hat),
        _named(what, ("beta", "omega", "active"), scalars), 2, 1)
    fused_k1b.launches += 1
    return P2, S2, rhTs


fused_k1b.launches = 0


# --- K2b --------------------------------------------------------------------

def fused_k2b_plain(vals, R, S2, scalars, offsets):
    (alpha,) = scalars
    Q = R - alpha[:, None] * S2
    Y = batched_dia_spmv_plain(vals, offsets, Q)
    return Q, Y, (Q * Y).sum(1), (Y * Y).sum(1)


def fused_k2b(vals, R, S2, scalars, offsets: tuple):
    """scalars = (alpha,), [k]. Returns (Q, Y, qTy, yTy) with
    Q = R - alpha S2, Y = A Q and the per-lane dots [k]."""
    if R.device.type == "cpu":
        return fused_k2b_plain(vals, R, S2, scalars, offsets)
    what = "fused_k2b"
    (Q, Y), (qTy, yTy) = lanes_pass(
        _lib(), "mbt_fused_k2b_f32", what, vals, offsets,
        dict(r=R, s2=S2), _named(what, ("alpha",), scalars), 2, 2)
    fused_k2b.launches += 1
    return Q, Y, qTy, yTy


fused_k2b.launches = 0


# --- K3b --------------------------------------------------------------------

def fused_k3b_plain(X, P2, Q, Y, R_hat, scalars):
    alpha, omega, active = scalars
    X2 = X + alpha[:, None] * P2 + omega[:, None] * Q
    R2 = Q - omega[:, None] * Y
    return (_keep(active, X2, X), _keep(active, R2, Q), (R2 * R2).sum(1),
            (R_hat * R2).sum(1))


def fused_k3b(X, P2, Q, Y, R_hat, scalars):
    """scalars = (alpha, omega, active), each [k]. Returns (X2, R2, dot_r,
    rTr_new): X2 = X + alpha P2 + omega Q and R2 = Q - omega Y on the
    active lanes, X and Q on the frozen ones; dot_r [k] = (r'_l, r'_l),
    rTr_new [k] = (r^_l, r'_l)."""
    if X.device.type == "cpu":
        return fused_k3b_plain(X, P2, Q, Y, R_hat, scalars)
    what = "fused_k3b"
    (X2, R2), (dot_r, rTr_new) = lanes_pass(
        _lib(), "mbt_fused_k3b_f32", what, None, (),
        dict(x=X, p2=P2, q=Q, y=Y, r_hat=R_hat),
        _named(what, ("alpha", "omega", "active"), scalars), 2, 2)
    fused_k3b.launches += 1
    return X2, R2, dot_r, rTr_new


fused_k3b.launches = 0
