"""Double-float (DF) extended precision (counterpart of
mpi_bicgstab_tpu/ops/precision.py).

Every value is an unevaluated pair hi + lo of float32 tensors with
|lo| <= ulp(hi)/2 when normalised: about 48 significant bits (unit
roundoff ~2^-49), the precision mode `dtype="df32"` of the solvers. The
arithmetic is the classic set of error-free transformations (Dekker
1971, Knuth TAOCP v2, Ogita-Rump-Oishi 2005; the QD library's float-float
flavour). DF has operator overloads, so solver code written for tensors
(`r - alpha * s`, `rTr / rTs`, `dot_r > thresh`) runs unchanged on DF
operands, and the plain tensor code here is the twin that the DF CUDA
kernels (csrc/df_core.cuh) are held bit-equal to.

Exactness: the EFTs need every float32 operation rounded on its own,
with no contraction into an FMA and no reassociation. Each PyTorch
elementwise operation rounds its own result and nothing contracts
across two operations, on the CPU and on the card alike, so this module
computes the EFTs directly on both devices (the JAX package routes its
CPU path through float64 instead, because XLA:CPU contracts inside
fusions). That holds only while the DF code calls no fused operation:
no torch.addcmul, torch.addcdiv, torch.lerp or `alpha=` argument, whose
vectorised kernels may use an FMA. two_prod's Veltkamp split is an
integer mask on the float bits, which nothing can contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Mask zeroing the low 12 mantissa bits of a float32: a = hi + lo with
# both halves exact in 12 significand bits, so their pairwise products
# are exact in float32 (the bit-level Veltkamp split; the arithmetic form
# t = 4097 a; hi = t - (t - a) breaks as soon as a compiler contracts it).
_HI_MASK = int(np.uint32(0xFFFFF000).view(np.int32))


# --- error-free transformations (float32 in, exact pairs out) ---------------

def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum for |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor):
    """a == hi + lo exactly, each half exact in 12 significand bits."""
    hi = (a.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, bitmask split). The
    exact error of a product is unique, so the card's FMA form
    e = fma(a, b, -p) gives the same bits."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# --- the pair type ----------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DF:
    """Unevaluated float32 sum hi + lo, elementwise over tensors of any
    shape (scalars are 0-d). The operators take DF pairs, float32 tensors
    or Python numbers on either side."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self) -> int:
        return self.hi.dim()

    @property
    def device(self) -> torch.device:
        return self.hi.device

    def __getitem__(self, idx) -> "DF":
        return DF(self.hi[idx], self.lo[idx])

    def __len__(self) -> int:
        return self.hi.shape[0]

    def __iter__(self):
        # unpack along the leading axis (`qTy, yTy = comm.dots(...)`)
        return (self[i] for i in range(len(self)))

    def to(self, device) -> "DF":
        return DF(self.hi.to(device), self.lo.to(device))

    def value(self) -> torch.Tensor:
        """The nearest float32 (hi absorbs lo)."""
        return self.hi + self.lo

    def __float__(self) -> float:
        """The pair's exact value (hi + lo is exact in float64): one host
        read, for the unfused solvers' stop test."""
        return float(self.hi.double() + self.lo.double())

    item = __float__     # a 0-d tensor's read (utils/timing.host_read)

    def __add__(self, o):
        return df_add(self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return df_add(self, df_neg(_as_df(o, self)))

    def __rsub__(self, o):
        return df_add(_as_df(o, self), df_neg(self))

    def __mul__(self, o):
        return df_mul(self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return df_div(self, _as_df(o, self))

    def __rtruediv__(self, o):
        return df_div(_as_df(o, self), self)

    def __neg__(self):
        return df_neg(self)

    # comparisons on the normalised difference, elementwise
    def _cmp(self, o) -> torch.Tensor:
        d = self - o
        return d.hi + d.lo

    def __eq__(self, o):
        return self._cmp(o) == 0

    def __ne__(self, o):
        return self._cmp(o) != 0

    __hash__ = None

    def __gt__(self, o):
        return self._cmp(o) > 0

    def __ge__(self, o):
        return self._cmp(o) >= 0

    def __lt__(self, o):
        return self._cmp(o) < 0

    def __le__(self, o):
        return self._cmp(o) <= 0


def is_df(x) -> bool:
    return isinstance(x, DF)


def _as_df(x, like=None) -> DF:
    """x as a pair: a DF as it is, a tensor with a zero lo, a Python
    number as a 0-d pair on `like`'s device (made there with a fill, not
    copied from the host, so that a CUDA graph can capture it)."""
    if isinstance(x, DF):
        return x
    if not torch.is_tensor(x):
        dev = like.device if like is not None else None
        x = torch.full((), float(x), dtype=torch.float32, device=dev)
    return DF(x, torch.zeros_like(x))


# --- arithmetic ---------------------------------------------------------------

def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_add(a, b) -> DF:
    """Accurate (IEEE-style) double-float addition."""
    a = _as_df(a, b if is_df(b) else None)
    b = _as_df(b, a)
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return DF(s1, s2)


def df_mul(a, b) -> DF:
    a = _as_df(a, b if is_df(b) else None)
    b = _as_df(b, a)
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = p2 + (a.hi * b.lo + a.lo * b.hi)
    return DF(*quick_two_sum(p1, p2))


def df_div(a: DF, b: DF) -> DF:
    """Long division, three quotient terms (QD style)."""
    q1 = a.hi / b.hi
    r = df_add(a, df_neg(df_mul(b, q1)))
    q2 = r.hi / b.hi
    r = df_add(r, df_neg(df_mul(b, q2)))
    q3 = r.hi / b.hi
    s1, s2 = quick_two_sum(q1, q2)
    return DF(*quick_two_sum(s1, s2 + q3))


def df_fma(y, a, b) -> DF:
    """y + a*b with one compensation step: p, e = two_prod(a.hi, b.hi);
    e += cross terms; hi, e2 = two_sum(y.hi, p); lo = y.lo + (e + e2);
    quick renormalisation. ~2^-48 relative per call; the workhorse of
    the DF SpMV and of the solver vector updates."""
    like = next((t for t in (y, a, b) if is_df(t) or torch.is_tensor(t)),
                None)
    a, b, y = _as_df(a, like), _as_df(b, like), _as_df(y, like)
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, e2 = two_sum(y.hi, p)
    lo = y.lo + (e + e2)
    return DF(*quick_two_sum(hi, lo))


def df_abs(a: DF) -> DF:
    neg = a.hi < 0
    return DF(torch.where(neg, -a.hi, a.hi), torch.where(neg, -a.lo, a.lo))


def df_where(pred, a, b) -> DF:
    a, b = _as_df(a, b if is_df(b) else None), _as_df(b, a)
    return DF(torch.where(pred, a.hi, b.hi), torch.where(pred, a.lo, b.lo))


def df_zeros(shape, device=None) -> DF:
    """A zero pair whose halves are distinct tensors (the shifted solvers
    update their state in place)."""
    return DF(torch.zeros(shape, dtype=torch.float32, device=device),
              torch.zeros(shape, dtype=torch.float32, device=device))


# --- dtype-generic helpers (tensors as they are, DF-aware otherwise) ---------

def vfma(y, a, b):
    """y + a*b: df_fma when any operand is a pair, tensor arithmetic
    otherwise."""
    if is_df(y) or is_df(a) or is_df(b):
        return df_fma(y, a, b)
    return y + a * b


def vvalue(x):
    """The float32 value of a pair (identity on tensors): for stop tests
    and history, which need no extended precision."""
    return x.value() if is_df(x) else x


def vwhere(pred, a, b):
    if is_df(a) or is_df(b):
        return df_where(pred, a, b)
    return torch.where(pred, a, b)


def vzeros(shape, like):
    """Zeros of `like`'s kind: a pair for a pair, else a tensor of its
    dtype, on its device."""
    if is_df(like):
        return df_zeros(shape, like.device)
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def vones(shape, like):
    if is_df(like):
        return DF(torch.ones(shape, dtype=torch.float32, device=like.device),
                  torch.zeros(shape, dtype=torch.float32,
                              device=like.device))
    return torch.ones(shape, dtype=like.dtype, device=like.device)


def vzeros_like(v):
    return vzeros(v.shape, v)


def vabs(x):
    return df_abs(x) if is_df(x) else x.abs()


def vbroadcast_rows(v, S: int):
    """[n] -> [S, n], a materialised copy."""
    if is_df(v):
        return DF(v.hi.expand(S, -1).clone(), v.lo.expand(S, -1).clone())
    return v.expand(S, -1).clone()


def vcat(parts, axis: int = 0):
    if any(is_df(p) for p in parts):
        parts = [_as_df(p) for p in parts]
        return DF(torch.cat([p.hi for p in parts], axis),
                  torch.cat([p.lo for p in parts], axis))
    return torch.cat(parts, axis)


# --- reductions: pairwise DF summation and compensated dot -------------------

def df_sum(a, axis: int = -1) -> DF:
    """Pairwise (halving) DF summation along `axis`: two_sum of the hi
    halves, the lo halves and the errors added, the halves contiguous;
    one renormalisation at the end."""
    a = _as_df(a)
    hi = a.hi.movedim(axis, -1)
    lo = a.lo.movedim(axis, -1)
    n = hi.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()        # next power of two
    if m != n:
        hi, lo = F.pad(hi, (0, m - n)), F.pad(lo, (0, m - n))
    while m > 1:
        h = m // 2
        s, e = two_sum(hi[..., :h], hi[..., h:])
        lo = (lo[..., :h] + lo[..., h:]) + e
        hi = s
        m = h
    return DF(*quick_two_sum(hi[..., 0], lo[..., 0]))


def df_dot(u, v, axis: int = -1) -> DF:
    """Compensated dot product (Ogita-Rump-Oishi Dot2 family): exact
    products of the hi parts, the cross terms added to the error, then
    the pairwise DF sum. float32 tensors are pairs with a zero lo."""
    if not (is_df(u) or is_df(v)):
        p, e = two_prod(u, v)
        return df_sum(DF(p, e), axis=axis)
    u = _as_df(u, v if is_df(v) else None)
    v = _as_df(v, u)
    p, e = two_prod(u.hi, v.hi)
    e = e + (u.hi * v.lo + u.lo * v.hi)
    return df_sum(DF(p, e), axis=axis)


def df_stack(items) -> DF:
    items = [_as_df(x) for x in items]
    return DF(torch.stack([x.hi for x in items]),
              torch.stack([x.lo for x in items]))


def df_renorm(a: DF) -> DF:
    """Re-establish |lo| <= ulp(hi)/2."""
    return DF(*two_sum(a.hi, a.lo))


# --- host conversions -----------------------------------------------------------

def df_split_f64_host(a):
    """Split host float64 data into NumPy (hi, lo) float32 arrays, exact
    to ~2^-48."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_from_f64(a, device="cpu") -> DF:
    """Host float64 data as a pair on `device`."""
    hi, lo = df_split_f64_host(a)
    return DF(torch.from_numpy(np.array(hi, order="C")).to(device),
              torch.from_numpy(np.array(lo, order="C")).to(device))


def df_to_f64(a: DF) -> np.ndarray:
    """The pair's values as host float64 (exact)."""
    return (a.hi.detach().cpu().numpy().astype(np.float64)
            + a.lo.detach().cpu().numpy().astype(np.float64))
