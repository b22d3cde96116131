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

On the card K1b and K2b each run in two stages: stage 0 forms p' (or q)
once per row and lane and stores it in P2 (or Q); stage 1 multiplies
from the stored plane, so no row recomputes a neighbour's value. A
frozen lane's unmasked p' (its beta and omega may be NaN or inf) goes to
a scratch plane, from which stage 1 takes that lane's neighbours and
forms its dot, while P2 gets p. No shared-memory halo: on
transport_like(1602112) a row reaches 13,807 rows each side, and one
plane's halo (884 KB) outgrows an SM's 228 KB. The design floor is the
pass's bytes plus one re-read of the stored plane.

With `halo=Halo(h, prev, next)` (ops/cuda_spmv.Halo) each pass runs its
halo form for the row-partitioned batch (solvers/batched_dist.py): every
plane is [k, n + 2h], the rank's rows with h rows of each neighbour
around them. K1b's and K2b's stage 0 forms p' (or q) over the halo rows
too, from inputs whose edges were exchanged before the pass (so P2, Q and
the scratch plane hold them); stage 1 multiplies the rank's rows,
reading the columns halo.bounds(n); K3b runs on the rank's rows (offset
pointers, no band). The dots are the rank's rows' partial sums; output
rows no stage writes are unspecified. The twins take the same halo.

Each of fused_k1b / fused_k2b / fused_k3b runs its plain PyTorch twin for
CPU tensors and launches its kernels for CUDA tensors, or raises; its
`.launches` counts calls that launched (one per pass). They take the
operators and lane counts of cuda_batched_spmv.format_ok. The JAX
package's padded carry, VMEM chunking and in-place outputs are TPU
devices with no counterpart here: the kernels skip out-of-range
neighbours and write fresh outputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv import (band_lanes_plain,
                                                          lanes_pass)
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_batched")
    band = [_P, ctypes.c_int] + [ctypes.c_longlong] * 4 + [ctypes.c_int]
    sigs = {"mbt_fused_k1b_f32": band + [_P] * 14,
            "mbt_fused_k2b_f32": band + [_P] * 9,
            "mbt_fused_k3b_f32": [ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_int] + [_P] * 13}
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


def _rows(X, halo: Halo | None):
    """The rank's rows of [k, n + 2h] planes (X itself without a halo)."""
    if halo is None:
        return X
    return X[:, halo.h:X.shape[1] - halo.h]


# --- K1b --------------------------------------------------------------------

def fused_k1b_plain(vals, R, P, S, R_hat, scalars, offsets, halo=None):
    beta, omega, active = scalars
    P2 = R + beta[:, None] * (P - omega[:, None] * S)
    S2 = band_lanes_plain(vals, offsets, P2, halo)
    return (_keep(active, P2, P), _keep(active, S2, S),
            (_rows(R_hat, halo) * _rows(S2, halo)).sum(1))


def fused_k1b(vals, R, P, S, R_hat, scalars, offsets: tuple,
              halo: Halo | None = None):
    """scalars = (beta, omega, active), each [k]. Returns (P2, S2, rhTs):
    P2 = R + beta (P - omega S) and S2 = A P2 on the active lanes, P and S
    on the frozen ones; rhTs [k] = (r^_l, A p'_l) of the unmasked p'.
    On the card a third [k, n] plane is scratch for the frozen lanes'
    unmasked p'."""
    if R.device.type == "cpu":
        return fused_k1b_plain(vals, R, P, S, R_hat, scalars, offsets, halo)
    what = "fused_k1b"
    (P2, S2, _), (rhTs,) = lanes_pass(
        _lib(), "mbt_fused_k1b_f32", what, vals, offsets,
        dict(r=R, p=P, s=S, r_hat=R_hat),
        _named(what, ("beta", "omega", "active"), scalars), 3, 1, halo)
    fused_k1b.launches += 1
    return P2, S2, rhTs


fused_k1b.launches = 0


# --- K2b --------------------------------------------------------------------

def fused_k2b_plain(vals, R, S2, scalars, offsets, halo=None):
    (alpha,) = scalars
    Q = R - alpha[:, None] * S2
    Y = band_lanes_plain(vals, offsets, Q, halo)
    Qr, Yr = _rows(Q, halo), _rows(Y, halo)
    return Q, Y, (Qr * Yr).sum(1), (Yr * Yr).sum(1)


def fused_k2b(vals, R, S2, scalars, offsets: tuple,
              halo: Halo | None = None):
    """scalars = (alpha,), [k]. Returns (Q, Y, qTy, yTy) with
    Q = R - alpha S2, Y = A Q and the per-lane dots [k]."""
    if R.device.type == "cpu":
        return fused_k2b_plain(vals, R, S2, scalars, offsets, halo)
    what = "fused_k2b"
    (Q, Y), (qTy, yTy) = lanes_pass(
        _lib(), "mbt_fused_k2b_f32", what, vals, offsets,
        dict(r=R, s2=S2), _named(what, ("alpha",), scalars), 2, 2, halo)
    fused_k2b.launches += 1
    return Q, Y, qTy, yTy


fused_k2b.launches = 0


# --- K3b --------------------------------------------------------------------

def fused_k3b_plain(X, P2, Q, Y, R_hat, scalars, halo=None):
    alpha, omega, active = scalars
    X2 = X + alpha[:, None] * P2 + omega[:, None] * Q
    R2 = Q - omega[:, None] * Y
    R2r = _rows(R2, halo)
    return (_keep(active, X2, X), _keep(active, R2, Q), (R2r * R2r).sum(1),
            (_rows(R_hat, halo) * R2r).sum(1))


def fused_k3b(X, P2, Q, Y, R_hat, scalars, halo: Halo | None = None):
    """scalars = (alpha, omega, active), each [k]. Returns (X2, R2, dot_r,
    rTr_new): X2 = X + alpha P2 + omega Q and R2 = Q - omega Y on the
    active lanes, X and Q on the frozen ones; dot_r [k] = (r'_l, r'_l),
    rTr_new [k] = (r^_l, r'_l)."""
    if X.device.type == "cpu":
        return fused_k3b_plain(X, P2, Q, Y, R_hat, scalars, halo)
    what = "fused_k3b"
    (X2, R2), (dot_r, rTr_new) = lanes_pass(
        _lib(), "mbt_fused_k3b_f32", what, None, (),
        dict(x=X, p2=P2, q=Q, y=Y, r_hat=R_hat),
        _named(what, ("alpha", "omega", "active"), scalars), 2, 2, halo)
    fused_k3b.launches += 1
    return X2, R2, dot_r, rTr_new


fused_k3b.launches = 0
