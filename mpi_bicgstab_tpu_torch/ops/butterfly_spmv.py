"""SpMV over the butterfly-routed layout (counterpart of
mpi_bicgstab_tpu/ops/pallas_butterfly.py: butterfly_spmv,
butterfly_spmv_df, the pipelines _pipeline / _pipeline_df).

The JAX pipeline routes x on every SpMV:

    x --K1--> u1 --T1--> mid --K2--> z1 --T2--> z --K3--> y (+ the tail)

Every element of z is one column of x (or K1's zero past the last
column), whatever x holds, so the port routes once per layout, not once
per SpMV: column_table sends the int32 iota 1..n_cols through K1 and K2,
each of which writes its output transposed (T1 and T2 folded into its
stores), and decodes z into ButterflyMatrix.k3_col, the column of x each
K3 slot reads (-1 for K1's zero): the b32 kernels and the decode kernel
on the card, the twins below on the CPU. An SpMV is then one K3 launch
over x (ops/cuda_butterfly.py, csrc/butterfly.cu) and the leveled tail:
the same bits as the routed pipeline, since routing only copies them.

The twins compute what the kernels compute, operation for operation:

- K1: u1[a, i, j] = x[k1_src[a] * 1024 + k1_sub[a, i, lam] * 128 + lam],
  lam = k1_lane[a, i, j], 0 for a column >= n_cols (the JAX pipeline's
  zero-padded x); it returns mid, u1 [P, 1024] transposed, read flat.
- K2: z1[m, i, j] = mid[m, k2_sub[m, i, lam], lam], lam = k2_lane[m, i, j];
  it returns z, z1 [P, 1024] transposed, read flat.
- The decode, K3's slot (w, r): output row r = R * 128 + j reads, in slab
  w, the z element ((R * F + j // rb) * 8 + (s & 7)) * 128 + lam of its
  row tile's stacked windows, lam = k3_lane[w, r], s = k3_sub[w, R, lam]
  (the Pallas 'lane' form): k3_col[w, r] is that element of the routed
  iota, less 1.
- K3: xg = x[k3_col[w, r]] (+0 for -1); accumulator w % 8 adds v * xg
  chunk by chunk (rounded product, rounded sum, the product formed for
  every slot, padding included, so that NaN, inf and the sign of zero
  come out as the routed pipeline gives them), then the 8 sums combine by
  halving, a[i] + a[i + h] for h = 4, 2, 1. DF: acc = df_fma(acc, v, xg)
  and the compensated halving of pallas_butterfly.py:342-352, the pair
  left unnormalised.

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


def _transposed(A, u: torch.Tensor) -> torch.Tensor:
    """[P, 1024] -> [1024, P], read flat (JAX's T1 and T2)."""
    return u.view(A.P, WIN).t().contiguous().view(-1)


def k1_plain(A, x: torch.Tensor) -> torch.Tensor:
    """K1's twin: mid [P * 1024] (u1 transposed) from x [n_cols]."""
    xp = x.new_zeros(A.nc_pad)
    xp[: A.n_cols] = x
    return _transposed(A, xp.index_select(
        0, _slot_elem(A.k1_sub, A.k1_lane, A.k1_src)))


def k2_plain(A, mid: torch.Tensor) -> torch.Tensor:
    """K2's twin: z [P * 1024], mid permuted inside each window and
    transposed."""
    base = torch.arange(A.P, device=mid.device)
    return _transposed(A, mid.index_select(
        0, _slot_elem(A.k2_sub, A.k2_lane, base)))


def k3_elem(A, c: int) -> torch.Tensor:
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


def _zero_padded(x: torch.Tensor) -> torch.Tensor:
    """x with one +0 appended, the element a -1 column reads."""
    return torch.cat((x, x.new_zeros(1)))


def _gather(xz: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """xz[col] (xz zero-padded; -1 reads its last element), in col's
    shape."""
    idx = torch.where(col < 0, xz.shape[0] - 1, col).view(-1)
    return xz.index_select(0, idx).view(col.shape)


def k3_plain(A, x: torch.Tensor) -> torch.Tensor:
    """K3's twin (float32 / float64): the slab part of y [n_pad] from x
    [n_cols], read through A.k3_col."""
    xz = _zero_padded(x)
    acc = x.new_zeros(A.k3_col.shape[1:])
    for c in range(A.width // SUB):
        acc = acc + A.k3_vals[c] * _gather(xz, A.k3_col[c])
    for h in (4, 2, 1):
        acc = acc[:h] + acc[h:2 * h]
    return acc[0].reshape(-1)


def k3_df_plain(A, x: DF) -> DF:
    """K3's DF twin: the slab part of the pair y [n_pad] from x [n_cols]."""
    xh, xl = _zero_padded(x.hi), _zero_padded(x.lo)
    acc = df_zeros(A.k3_col.shape[1:], x.hi.device)
    for c in range(A.width // SUB):
        col = A.k3_col[c]
        acc = df_fma(acc, A.k3_vals[c],
                     DF(_gather(xh, col), _gather(xl, col)))
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


def decode_plain(A, z: torch.Tensor) -> torch.Tensor:
    """The decode's twin: k3_col [W//8, 8, NR, 128] from the routed iota
    z [P * 1024], each slot's z element less 1."""
    zcol = z - 1
    return torch.stack([zcol.index_select(0, k3_elem(A, c))
                        for c in range(A.width // SUB)]).view(
        A.k3_lane.shape)


def decode(A, z):
    return cbf.butterfly_decode(A, z) if _cuda(z) else decode_plain(A, z)


def route(A, x: torch.Tensor) -> torch.Tensor:
    """z [P * 1024]: x through K1 and K2 (JAX's K1, T1, K2, T2)."""
    return k2(A, k1(A, x))


def column_table(A) -> torch.Tensor:
    """k3_col, int32 [W//8, 8, NR, 128] on A's device: the column of x
    each K3 slot reads, -1 where the routed z holds K1's zero (a column
    >= n_cols). The iota 1..n_cols routed and decoded (K1, K2 and the
    decode launched once each on the card)."""
    iota = torch.arange(1, A.n_cols + 1, dtype=torch.int32,
                        device=A.device)
    return decode(A, route(A, iota))


def butterfly_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x [n_pad] for float32 / float64 values; x: [n_cols]."""
    x = x.to(A.k3_vals.dtype)
    y = cbf.butterfly_k3(A, x) if _cuda(x) else k3_plain(A, x)
    if A.tail_n:
        for lvl in range(A.tail_rows.shape[0]):
            y.index_add_(0, A.tail_rows[lvl],
                         A.tail_vals[lvl] * x[A.tail_cols[lvl]])
    return y


def butterfly_spmv_df(A, x: DF) -> DF:
    """Double-float y = A x [n_pad] (A.k3_vals and x DF pairs)."""
    y = cbf.butterfly_k3_df(A, x) if _cuda(x.hi) else k3_df_plain(A, x)
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
