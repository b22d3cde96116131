"""Distributed SpMV bodies (counterpart of
mpi_bicgstab_tpu/parallel/dist_spmv.py), run by every rank on its shard.

* DIA halo mode: two edge exchanges of `halo` elements with each
  neighbour (dist.batch_isend_irecv, an Exchange the caller waits on
  before the band kernel; the ranks at the ends of the matrix take
  zeros), then the local band multiply over the halo-extended vector:
  on the card one launch of the DIA SpMV kernel (csrc/dia_spmv.cu, its
  halo form), float32 / float64, or of the DF SpMV for pairs.
* DIA gather mode (a band wider than a shard): the whole iterate
  gathered, the rank's window of it cut out, the same kernel.
* allgather: MPI_csr_spmv_ovlap (matrix.c:428-441), the diag block over
  the local slice while the gather is in flight, then the off-diagonal
  block over the gathered iterate.
* ring: MPI_csr_spmv_async (matrix.c:450-492), P - 1 hops of send/recv,
  each multiplying the off-diagonal columns of the slice in hand ("slower
  than Allgatherv, unused", matrix.c:448; kept for parity).
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.cuda_spmv import dia_spmv, dia_spmv_df
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_add, df_mul,
                                                  df_zeros, is_df)
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv, ell_spmv_df
from mpi_bicgstab_tpu_torch.parallel.comm import Comm


def _halves(x):
    return (x.hi, x.lo) if is_df(x) else (x,)


def _extended(x_loc, halo: int):
    """Zeros of n_loc + 2 halo entries with x_loc in the middle (halves
    apart for a pair)."""
    n = x_loc.shape[0]
    out = []
    for h in _halves(x_loc):
        e = h.new_zeros(n + 2 * halo)
        e[halo:halo + n] = h
        out.append(e)
    return DF(*out) if is_df(x_loc) else out[0]


def _global_rank(comm: Comm, r: int) -> int:
    import torch.distributed as dist
    return dist.get_global_rank(comm.group, r)


class Exchange:
    """A batch of point-to-point transfers in flight: wait() waits on
    them (once), then runs `after` (the copies out of receive buffers).
    The send and receive buffers live here until the wait."""

    def __init__(self, reqs, keep=(), after=None):
        self._reqs, self._keep, self._after = reqs, keep, after

    def complete(self) -> None:
        for req in self._reqs:
            req.wait()
        self._reqs, self._keep = [], ()

    def wait(self) -> None:
        self.complete()
        if self._after is not None:
            self._after()
            self._after = None


def _issue(comm: Comm, ops, keep=(), after=None) -> Exchange:
    """One dist.batch_isend_irecv of ops, as an Exchange (waited on at
    once under comm.serialize)."""
    import torch.distributed as dist
    ex = Exchange(dist.batch_isend_irecv(ops) if ops else [], keep, after)
    if comm.serialize:
        ex.complete()
    return ex


def exchange_halo(comm: Comm, halo: int, vecs) -> Exchange:
    """Start filling the edges of halo-extended vectors from the
    neighbours, all in one batch: for each (x_loc, xh) of vecs, the last
    `halo` entries of rank r - 1 go before x_loc's rows in xh, the first
    `halo` of rank r + 1 after them (both halves of a pair); the ends of
    the matrix keep what xh holds there. The caller waits on the returned
    Exchange before it reads xh."""
    import torch.distributed as dist
    me, ops = comm.rank, []
    for x_loc, xh in vecs:
        n = x_loc.shape[0]
        for h, e in zip(_halves(x_loc), _halves(xh)):
            if me > 0:
                prev = _global_rank(comm, me - 1)
                ops += [dist.P2POp(dist.isend, h[:halo].contiguous(), prev,
                                   comm.group),
                        dist.P2POp(dist.irecv, e[:halo], prev, comm.group)]
            if me < comm.size - 1:
                nxt = _global_rank(comm, me + 1)
                ops += [dist.P2POp(dist.isend, h[n - halo:].contiguous(),
                                   nxt, comm.group),
                        dist.P2POp(dist.irecv, e[halo + n:], nxt,
                                   comm.group)]
    return _issue(comm, ops, keep=[op.tensor for op in ops])


def exchange_planes(comm: Comm, halo: int, planes) -> Exchange:
    """exchange_halo for [k, n + 2 halo] planes of k lanes (the blocked
    batch, solvers/batched_dist.py): each plane's [k, halo] edge columns
    from the neighbours, one message per plane and neighbour, received
    into buffers and copied into the plane at the wait."""
    import torch.distributed as dist
    me, ops, copies = comm.rank, [], []
    for P in planes:
        n = P.shape[1] - 2 * halo
        for lo_src, lo_dst, peer, there in (
                (halo, 0, me - 1, me > 0),
                (n, halo + n, me + 1, me < comm.size - 1)):
            if not there:
                continue
            rank = _global_rank(comm, peer)
            buf = P.new_empty((P.shape[0], halo))
            ops += [dist.P2POp(dist.isend,
                               P[:, lo_src:lo_src + halo].contiguous(),
                               rank, comm.group),
                    dist.P2POp(dist.irecv, buf, rank, comm.group)]
            copies.append((P[:, lo_dst:lo_dst + halo], buf))

    def after():
        for dst, buf in copies:
            dst.copy_(buf)
    return _issue(comm, ops, keep=[op.tensor for op in ops], after=after)


def _band(vals_loc, offsets: tuple, xh, halo: int):
    if is_df(xh):
        return dia_spmv_df(vals_loc, offsets, xh, halo=halo)
    return dia_spmv(vals_loc, offsets, xh, halo=halo)


def spmv_dia_halo(vals_loc, offsets: tuple, halo: int, comm: Comm, x_loc,
                  n_devices: int):
    """Distributed DIA SpMV with the neighbour halo exchange: per-rank
    traffic O(band width), not the reference's O(n_global)."""
    if halo == 0:
        return _band(vals_loc, offsets, x_loc, 0)
    xh = _extended(x_loc, halo)
    if n_devices > 1 and comm.group is not None:
        # nooverlap: the exchange completes first (JAX dist_spmv.py:54)
        comm.seq(exchange_halo(comm, halo, [(x_loc, xh)])).wait()
    return _band(vals_loc, offsets, xh, halo)


def spmv_dia_gather(vals_loc, offsets: tuple, comm: Comm, x_loc):
    """For bands wider than a shard: gather the iterate and multiply
    over this rank's rows' window of it (zeros beyond the matrix)."""
    x_full = comm.seq(comm.allgather(x_loc))
    n_loc = x_loc.shape[0]
    n_glob = x_full.shape[0]
    reach = max((abs(o) for o in offsets), default=0)
    start = comm.axis_index() * n_loc
    lo, hi = max(start - reach, 0), min(start + n_loc + reach, n_glob)
    out = []
    for h in _halves(x_full):
        e = h.new_zeros(n_loc + 2 * reach)
        e[lo - start + reach:hi - start + reach] = h[lo:hi]
        out.append(e)
    xh = DF(*out) if is_df(x_loc) else out[0]
    return _band(vals_loc, offsets, xh, reach)


def spmv_allgather(diag: EllMatrix, offd: EllMatrix, comm: Comm, x_loc):
    """y_loc = A_diag @ x_loc + A_offd @ allgather(x): the gather is
    started, the diag block multiplied while it is in flight, then the
    off-diagonal block over the gathered x (matrix.c:428-441). Under
    comm.serialize the gather completes before the diag multiply (JAX
    dist_spmv.py:105)."""
    gather = comm.seq(comm.start_allgather(x_loc))
    if is_df(x_loc):
        y = ell_spmv_df(diag, x_loc)
        return df_add(y, ell_spmv_df(offd, gather.wait()))
    y = ell_spmv(diag, x_loc)          # overlaps the gather (matrix.c:437)
    return y + ell_spmv(offd, gather.wait())  # matrix.c:440


def _tail(offd: EllMatrix, x_full, y):
    """y plus the off-diagonal block's COO tail over the gathered x."""
    rows, cols = offd.tail_rows, offd.tail_cols
    if is_df(y):
        t = df_mul(offd.tail_vals, DF(x_full.hi[cols], x_full.lo[cols]))
        z = torch.zeros_like(y.hi)
        return df_add(y, DF(z.index_add(0, rows, t.hi),
                            z.index_add(0, rows, t.lo)))
    return y.index_add(0, rows, offd.tail_vals * x_full[cols])


def spmv_ring(diag: EllMatrix, offd: EllMatrix, comm: Comm, x_loc,
              n_devices: int):
    """Ring exchange: at hop h each rank holds the slice of rank
    (me + h) % P and multiplies the off-diagonal columns in it; a hop
    passes the slice to rank me - 1. The COO tail (rare) takes one
    gather."""
    import torch.distributed as dist
    df = is_df(x_loc)
    n_loc = x_loc.shape[0]
    me = comm.rank
    y = ell_spmv_df(diag, x_loc) if df else ell_spmv(diag, x_loc)
    src_block = (offd.cols // n_loc).long()   # source rank of each column
    local_col = (offd.cols % n_loc).long()
    buf = x_loc
    for h in range(n_devices):
        src = (me + h) % n_devices
        if df:
            vals = DF(torch.where(src_block == src, offd.vals.hi, 0.0),
                      torch.where(src_block == src, offd.vals.lo, 0.0))
            acc = df_zeros(y.shape, y.device)
            for w in range(offd.width):
                c = local_col[w]
                acc = df_add(acc, df_mul(vals[w], DF(buf.hi[c],
                                                     buf.lo[c])))
            y = df_add(y, acc)
        else:
            vals = torch.where(src_block == src, offd.vals,
                               torch.zeros_like(offd.vals))
            acc = torch.zeros_like(y)
            for w in range(offd.width):
                acc = acc + vals[w] * buf[local_col[w]]
            y = y + acc
        if h == n_devices - 1:
            break
        nxt = [t.new_empty(t.shape) for t in _halves(buf)]
        ops = []
        for t, r in zip(_halves(buf), nxt):
            ops += [dist.P2POp(dist.isend, t.contiguous(),
                               _global_rank(comm, (me - 1) % n_devices),
                               comm.group),
                    dist.P2POp(dist.irecv, r,
                               _global_rank(comm, (me + 1) % n_devices),
                               comm.group)]
        _issue(comm, ops, keep=[op.tensor for op in ops]).wait()
        buf = DF(*nxt) if df else nxt[0]
    if offd.tail_size:
        y = _tail(offd, comm.allgather(x_loc), y)
    return y

