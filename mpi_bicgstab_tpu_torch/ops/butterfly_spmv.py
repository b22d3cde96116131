"""SpMV over the butterfly-routed layout (counterpart of
mpi_bicgstab_tpu/ops/pallas_butterfly.py: butterfly_spmv,
butterfly_spmv_df, the pipelines _pipeline / _pipeline_df).

    x --K1--> u1 --T1--> mid --K2--> z1 --T2--> z --K3--> y (+ the tail)

K1, K2 and K3 are CUDA kernels on the card (ops/cuda_butterfly.py,
csrc/butterfly.cu) and the plain twins below on the CPU; T1 and T2 are
PyTorch transposes on both (XLA code in the JAX package too). A DF
vector is routed as one vector of 8-byte elements, each its (hi, lo)
pair (pack_df): the movement copies bits, so both planes arrive exact in
one pass through K1, T1, K2 and T2 (JAX routes the planes one after the
other); K3's DF form multiplies and accumulates.

The twins compute what the kernels compute, operation for operation:

- K1: u1[a, i, j] = x[k1_src[a] * 1024 + k1_sub[a, i, lam] * 128 + lam],
  lam = k1_lane[a, i, j], 0 for a column >= n_cols (the JAX pipeline's
  zero-padded x).
- K2: z1[m, i, j] = mid[m, k2_sub[m, i, lam], lam], lam = k2_lane[m, i, j].
- K3: output row r = R * 128 + j reads, in slab w, the z element
  ((R * F + j // rb) * 8 + (s & 7)) * 128 + lam of its row tile's stacked
  windows, lam = k3_lane[w, r], s = k3_sub[w, R, lam] (the Pallas 'lane'
  form); accumulator w % 8 adds v * xg chunk by chunk (rounded product,
  rounded sum), then the 8 sums combine by halving, a[i] + a[i + h] for
  h = 4, 2, 1. DF: acc = df_fma(acc, v, xg) and the compensated halving
  of pallas_butterfly.py:342-352, the pair left unnormalised.

The tail (ops/butterfly.py) goes level by level: within a level a real
row appears at most once and the padding entries (row 0, value 0) add
exact zeros, so each level's index_add has the same result in any order
of its atomics on the card. A float level adds to y (JAX adds one flat
segment sum, which rounds differently); a DF level is a df_mul of its
entries, scattered into zero planes and added to the whole of y with
df_add, as the JAX DF pipeline does. y has n_pad entries; ops/layout.spmv
takes the first n_rows.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
from mpi_bicgstab_tpu_torch.ops.butterfly import LANES, SUB, WIN
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_add, df_fma,
                                                  df_mul, df_zeros, two_sum)


def _lane_and_sublane(sub: torch.Tensor, lane: torch.Tensor):
    """(lam, s), int32 [rows, 128] over the tables' 128-entry rows: each
    slot's lane lam = lane[i, j] and sublane s = sub[i, lam] (int32
    indices and index_select: the fastest gather on the CPU)."""
    lam = lane.reshape(-1, LANES).int()
    row = torch.arange(lam.shape[0], dtype=torch.int32,
                       device=lam.device).mul_(LANES)
    s = sub.reshape(-1).index_select(0, (lam + row[:, None]).view(-1))
    return lam, s.view_as(lam).int()


def _slot_elem(sub: torch.Tensor, lane: torch.Tensor,
               base: torch.Tensor) -> torch.Tensor:
    """Flat [P * 1024] int32: each slot's element base[a] * 1024 +
    s * 128 + lam (base: [P] window numbers)."""
    lam, s = _lane_and_sublane(sub, lane)
    e = s.mul_(LANES).add_(lam).view(-1, WIN)
    return e.add_(base.int().mul(WIN)[:, None]).view(-1)


def k1_plain(A, x: torch.Tensor) -> torch.Tensor:
    """K1's twin: u1 [P * 1024] from x [n_cols]."""
    xp = x.new_zeros(A.nc_pad)
    xp[: A.n_cols] = x
    return xp.index_select(0, _slot_elem(A.k1_sub, A.k1_lane, A.k1_src))


def k2_plain(A, mid: torch.Tensor) -> torch.Tensor:
    """K2's twin: z1 [P * 1024], mid permuted inside each window."""
    base = torch.arange(A.P, device=mid.device)
    return mid.index_select(0, _slot_elem(A.k2_sub, A.k2_lane, base))


def transpose(A, u: torch.Tensor) -> torch.Tensor:
    """T1 and T2: [P, 1024] -> [1024, P], read flat."""
    return u.view(A.P, WIN).t().contiguous().view(-1)


def _k3_elem(A, c: int) -> torch.Tensor:
    """Flat [8 * NR * 128] int32: the z element each row reads in the
    slabs of chunk c (module doc)."""
    NR = A.n_pad // LANES
    lam, s = _lane_and_sublane(A.k3_sub[c], A.k3_lane[c])
    dev = lam.device
    tile = torch.arange(NR, dtype=torch.int32, device=dev).mul_(A.stack)
    win = torch.arange(LANES, dtype=torch.int32, device=dev) // A.rb
    blk = (tile[:, None] + win[None, :]).mul_(SUB)       # [NR, 128]
    e = s.bitwise_and_(SUB - 1).view(SUB, NR, LANES).add_(blk).mul_(LANES)
    return e.add_(lam.view(SUB, NR, LANES)).view(-1)


def k3_plain(A, z: torch.Tensor) -> torch.Tensor:
    """K3's twin (float32 / float64): y [n_pad] from the routed z."""
    C, NR = A.width // SUB, A.n_pad // LANES
    acc = z.new_zeros(SUB, NR, LANES)
    for c in range(C):
        acc = acc + A.k3_vals[c] * z.index_select(0, _k3_elem(A, c)).view(
            SUB, NR, LANES)
    for h in (4, 2, 1):
        acc = acc[:h] + acc[h:2 * h]
    return acc[0].reshape(-1)


def pack_df(x: DF) -> torch.Tensor:
    """x's (hi, lo) pairs as one int64 [n] vector (the bits of each pair
    side by side, hi first)."""
    return torch.stack((x.hi, x.lo), dim=-1).view(torch.int64).view(-1)


def unpack_df(z: torch.Tensor):
    """The (hi, lo) float32 planes of packed pairs (strided views)."""
    zf = z.view(torch.float32).view(-1, 2)
    return zf[:, 0], zf[:, 1]


def k3_df_plain(A, z: torch.Tensor) -> DF:
    """K3's DF twin: the pair y [n_pad] from the routed packed pairs."""
    zh, zl = unpack_df(z)
    C, NR = A.width // SUB, A.n_pad // LANES
    acc = df_zeros((SUB, NR, LANES), zh.device)
    for c in range(C):
        e = _k3_elem(A, c)
        acc = df_fma(acc, A.k3_vals[c],
                     DF(zh.index_select(0, e).view(SUB, NR, LANES),
                        zl.index_select(0, e).view(SUB, NR, LANES)))
    p, lo = acc.hi, acc.lo
    for h in (4, 2, 1):
        s, err = two_sum(p[:h], p[h:2 * h])
        p, lo = s, (lo[:h] + lo[h:2 * h]) + err
    return DF(p[0].reshape(-1), lo[0].reshape(-1))


def _cuda(x) -> bool:
    return x.device.type != "cpu"


def k1(A, x):
    return cbf.butterfly_k1(A, x) if _cuda(x) else k1_plain(A, x)


def k2(A, mid):
    return cbf.butterfly_k2(A, mid) if _cuda(mid) else k2_plain(A, mid)


def route(A, x: torch.Tensor) -> torch.Tensor:
    """z [P * 1024]: x through K1, T1, K2, T2."""
    return transpose(A, k2(A, transpose(A, k1(A, x))))


def butterfly_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x [n_pad] for float32 / float64 values; x: [n_cols]."""
    x = x.to(A.k3_vals.dtype)
    z = route(A, x)
    y = cbf.butterfly_k3(A, z) if _cuda(z) else k3_plain(A, z)
    if A.tail_n:
        for lvl in range(A.tail_rows.shape[0]):
            y.index_add_(0, A.tail_rows[lvl],
                         A.tail_vals[lvl] * x[A.tail_cols[lvl]])
    return y


def butterfly_spmv_df(A, x: DF) -> DF:
    """Double-float y = A x [n_pad] (A.k3_vals and x DF pairs)."""
    z = route(A, pack_df(x))
    y = cbf.butterfly_k3_df(A, z) if _cuda(z) else k3_df_plain(A, z)
    if A.tail_n:
        tv = A.tail_vals
        for lvl in range(A.tail_rows.shape[0]):
            rows, cols = A.tail_rows[lvl], A.tail_cols[lvl]
            t = df_mul(DF(tv.hi[lvl], tv.lo[lvl]),
                       DF(x.hi[cols], x.lo[cols]))
            y = df_add(y, DF(y.hi.new_zeros(A.n_pad).index_add_(0, rows,
                                                                 t.hi),
                             y.hi.new_zeros(A.n_pad).index_add_(0, rows,
                                                                t.lo)))
    return y
