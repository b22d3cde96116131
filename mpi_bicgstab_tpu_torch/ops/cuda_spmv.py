"""DIA SpMV: the CUDA kernels' wrappers and their plain PyTorch twins
(counterpart of mpi_bicgstab_tpu/ops/pallas_spmv.py and of the XLA DF
SpMV mpi_bicgstab_tpu/ops/dia.py::dia_spmv_df; kernel source
csrc/dia_spmv.cu).

`dia_spmv(vals, offsets, x)` (float32, float64) and
`dia_spmv_df(vals, offsets, x)` (double-float pairs, ops/precision.DF)
run the plain version for tensors on the CPU and launch the kernel for
tensors on the card; a CUDA tensor the kernel does not take raises.
With `halo=H` both take the halo-extended x of n + 2H entries that the
row-partitioned SpMV assembles (parallel/dist_spmv.spmv_dia_halo): row i
reads column i + o at x[H + i + o].
Each wrapper's `.launches` counts its kernel launches. `band_pass` and
`df_pass` check and launch the fused float32 and DF passes of the other
ops/cuda_fused_*.py modules; with a `Halo` they launch a pass's halo form
(solvers/fused_dist.py), whose plain twins take the helpers `center`,
`band_plain` and `band_df_plain` below.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_fma, df_zeros, is_df
from mpi_bicgstab_tpu_torch.utils.timing import span

_P = ctypes.c_void_p
_KERNELS = {torch.float32: "mbt_dia_spmv_f32",
            torch.float64: "mbt_dia_spmv_f64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dia_spmv")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    lib.mbt_dia_spmv_df.argtypes = [_P, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_longlong] + [_P] * 7
    lib.mbt_dia_spmv_df.restype = ctypes.c_int
    return lib


@functools.cache
def max_diags() -> int:
    return _lib().mbt_max_diags()


@functools.cache
def offsets_arg(offsets: tuple) -> ctypes.Array:
    """The offsets as a host int32 array; the launcher copies them into
    the kernel's parameter block, so nothing goes to device memory."""
    return (ctypes.c_int * max(len(offsets), 1))(*offsets)


def check_cuda(what: str, want: torch.dtype, **tensors) -> None:
    """Validate that every tensor lies on the current CUDA device, is
    contiguous and has the dtype the kernel takes."""
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"a CUDA tensor like the others")
        if dev is None:
            dev = t.device
            if dev.index != torch.cuda.current_device():
                raise ValueError(
                    f"{what}: tensors are on {dev} but the current CUDA "
                    f"device is {torch.cuda.current_device()}")
        elif t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if t.dtype != want:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, the "
                            f"kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def stream_arg() -> int:
    """PyTorch's current stream on the current device (where check_cuda
    found the tensors), as the integer handle the launchers take."""
    return torch.cuda.current_stream().cuda_stream


def check_band(what: str, vals: torch.Tensor, offsets: tuple, n: int):
    if vals.dim() != 2 or vals.shape[1] != n \
            or vals.shape[0] < len(offsets):
        raise ValueError(f"{what}: vals has shape {tuple(vals.shape)}, "
                         f"expected [{len(offsets)}, {n}]")
    if len(offsets) > max_diags():
        raise ValueError(f"{what}: {len(offsets)} diagonals, the kernel "
                         f"takes at most {max_diags()}")


def check_vectors(what: str, n: int, **vecs) -> None:
    for name, v in vecs.items():
        if v.shape != (n,):
            raise ValueError(f"{what}: {name} has shape {tuple(v.shape)}, "
                             f"expected ({n},)")


def check_scalars(what: str, names: tuple, scalars) -> dict:
    """The fused kernels' scalars by name; each must hold one value (a
    DF scalar in each half)."""
    if len(scalars) != len(names):
        raise ValueError(f"{what}: expected scalars {names}, got "
                         f"{len(scalars)}")
    for name, t in zip(names, scalars):
        halves = (t.hi, t.lo) if is_df(t) else (t,)
        if any(h.numel() != 1 for h in halves):
            raise ValueError(f"{what}: scalar {name} has shape "
                             f"{tuple(t.shape)}")
    return dict(zip(names, scalars))


@functools.cache
def _block_rows() -> int:
    return _lib().mbt_block_rows()


def grid_blocks(n: int) -> int:
    """Blocks of a row pass over n rows (every kernel library uses the
    same block size)."""
    return -(-n // _block_rows())


class Halo(NamedTuple):
    """The halo form of a fused pass in a row-partitioned solve
    (solvers/fused_dist.py): every vector holds the rank's n rows with h
    entries on each side, the previous rank's last h rows before them and
    the next rank's first h after (exchanged before the pass); prev and
    next say whether those ranks exist. A band row reads the columns
    [lo, hi) only: -h or 0, n + h or n (the ends of the matrix). Outputs
    have the same layout; their halo entries are unspecified."""
    h: int
    prev: bool
    next: bool

    def bounds(self, n: int) -> tuple[int, int]:
        return (-self.h if self.prev else 0, n + self.h if self.next else n)


def _halves(v):
    return (v.hi, v.lo) if is_df(v) else (v,)


def _like(v, halves):
    return DF(*halves) if is_df(v) else halves[0]


def center(v, halo: Halo | None):
    """The rank's own n rows of a halo-form vector (v itself without a
    halo)."""
    if halo is None:
        return v
    n = _halves(v)[0].shape[0] - 2 * halo.h
    return _like(v, [t[halo.h:halo.h + n] for t in _halves(v)])


def _readable(x, halo: Halo, n: int):
    """x with its entries outside the columns [lo, hi) set to zero: the
    band values there are zero and the kernels never read them."""
    lo, hi = halo.bounds(n)
    out = []
    for t in _halves(x):
        t = t.clone()
        t[:halo.h + lo] = 0.0
        t[halo.h + hi:] = 0.0
        out.append(t)
    return _like(x, out)


def _widen(y, halo: Halo):
    """An [n] result as a halo-form vector (zeros in the halo)."""
    out = []
    for t in _halves(y):
        e = t.new_zeros(t.shape[0] + 2 * halo.h)
        e[halo.h:halo.h + t.shape[0]] = t
        out.append(e)
    return _like(y, out)


def band_plain(vals, offsets: tuple, x, halo: Halo | None = None):
    """A twin's y = A x: dia_spmv_plain, or for a halo-form x the band
    multiply over its readable columns, returned in the halo form."""
    if halo is None:
        return dia_spmv_plain(vals, offsets, x)
    n = vals.shape[1]
    return _widen(dia_spmv_plain(vals, offsets, _readable(x, halo, n),
                                 halo.h), halo)


def band_df_plain(vals: DF, offsets: tuple, x: DF, halo: Halo | None = None):
    """band_plain in double-float (dia_spmv_df_plain)."""
    if halo is None:
        return dia_spmv_df_plain(vals, offsets, x)
    n = vals.hi.shape[1]
    return _widen(dia_spmv_df_plain(vals, offsets, _readable(x, halo, n),
                                    halo.h), halo)


def _pass_shape(what: str, first, vals, halo: Halo | None) -> tuple:
    """(n, the length of every vector, the element offset of the rank's
    first row) of a pass; a halo form takes n from the band (a pointwise
    pass from its vectors)."""
    if halo is None:
        return first.shape[0], first.shape[0], 0
    n = vals.shape[1] if vals is not None else first.shape[0] - 2 * halo.h
    if halo.h < 0:
        raise ValueError(f"{what}: halo {halo.h} < 0")
    return n, n + 2 * halo.h, halo.h


def _ptr(t: torch.Tensor, at: int) -> int:
    return t.data_ptr() + at * t.element_size()


def band_pass(lib, symbol: str, what: str, vals, offsets: tuple,
              vecs: dict, scalars: dict, n_out: int, n_dots: int,
              halo: Halo | None = None):
    """Check and launch a fused float32 pass over the DIA band whose C
    launcher takes (offsets, n_diags, n, lo, hi, vals, *vecs, *scalars,
    *outputs, partials, dots, stream), in the dicts' order. Returns
    (outputs, dots): n_out fresh vectors (never aliasing an input) and the
    [n_dots] dot products. With a halo every vector, output too, is in
    its halo form, and the kernel reads the columns halo.bounds(n)."""
    with span("mbt.launch." + what):
        first = next(iter(vecs.values()))
        n, length, at = _pass_shape(what, first, vals, halo)
        if halo is not None:
            _check_halo(what, halo.h, offsets)
        check_vectors(what, length, **vecs)
        check_cuda(what, torch.float32, vals=vals, **vecs, **scalars)
        check_band(what, vals, offsets, n)
        outs = [torch.empty_like(first) for _ in range(n_out)]
        partials, dots = first.new_empty((grid_blocks(n), n_dots)), \
            first.new_empty(n_dots)
        lo, hi = halo.bounds(n) if halo is not None else (0, n)
        err = getattr(lib, symbol)(
            offsets_arg(offsets), len(offsets), n, lo, hi, vals.data_ptr(),
            *(_ptr(t, at) for t in vecs.values()),
            *(t.data_ptr() for t in scalars.values()),
            *(_ptr(t, at) for t in outs),
            partials.data_ptr(), dots.data_ptr(), stream_arg())
        _build.check(lib, err, what)
        return outs, dots


def df_pass(lib, symbol: str, what: str, vals, offsets, vecs: dict,
            scalars: dict, n_out: int, n_dots: int, n_fold: int = 1,
            halo: Halo | None = None):
    """Check and launch a DF pass whose C launcher takes ([offsets,
    n_diags,] n, [lo, hi, vals hi, lo,] then (hi, lo) of every vector and
    scalar in the dicts' order (scalars from check_scalars), of n_out
    fresh output vectors, then partials, dots, the folded scalars and the
    stream; no partials and dots when n_dots is 0, no folded scalars when
    n_fold is 0). vals None: a pointwise pass. Returns (outputs, dots,
    folded scalars), all DF: the dots a DF [n_dots] (rows of one
    [2, n_dots] tensor, row 0 hi) that unpacks into 0-d pairs (None when
    n_dots is 0), the scalars 0-d views of a [2, n_fold] tensor. A halo
    as for band_pass."""
    with span("mbt.launch." + what):
        first = next(iter(vecs.values()))
        for name, v in (*vecs.items(), *scalars.items()):
            if not is_df(v):
                raise TypeError(f"{what}: {name} must be a DF pair")
        n, length, at = _pass_shape(what, first.hi,
                                    None if vals is None else vals.hi, halo)
        if halo is not None and vals is not None:
            _check_halo(what, halo.h, offsets)
        vec_parts, sc_parts = {}, {}
        for name, v in vecs.items():
            check_vectors(what, length, **{f"{name}.hi": v.hi,
                                           f"{name}.lo": v.lo})
            vec_parts[f"{name}.hi"], vec_parts[f"{name}.lo"] = v.hi, v.lo
        for name, v in scalars.items():
            sc_parts[f"{name}.hi"], sc_parts[f"{name}.lo"] = v.hi, v.lo
        head = [n]
        if vals is not None:
            if not is_df(vals):
                raise TypeError(f"{what}: vals must be a DF pair")
            check_cuda(what, torch.float32, vals_hi=vals.hi, vals_lo=vals.lo,
                       **vec_parts, **sc_parts)
            check_band(what, vals.hi, offsets, n)
            check_band(what, vals.lo, offsets, n)
            lo, hi = halo.bounds(n) if halo is not None else (0, n)
            head = [offsets_arg(offsets), len(offsets), n, lo, hi,
                    vals.hi.data_ptr(), vals.lo.data_ptr()]
        else:
            check_cuda(what, torch.float32, **vec_parts, **sc_parts)
        outs = [DF(torch.empty_like(first.hi), torch.empty_like(first.hi))
                for _ in range(n_out)]
        tail, dots = [], None
        if n_dots:
            partials = first.hi.new_empty((grid_blocks(n), n_dots, 2))
            dots = first.hi.new_empty((2, n_dots))
            tail += [partials.data_ptr(), dots.data_ptr()]
        folded = first.hi.new_empty((2, n_fold))
        if n_fold:
            tail.append(folded.data_ptr())
        # the vectors' (hi, lo) pointers, then the scalars', in the dicts'
        # order: the scalars follow every vector in each launcher
        err = getattr(lib, symbol)(
            *head, *(_ptr(t, at) for t in vec_parts.values()),
            *(t.data_ptr() for t in sc_parts.values()),
            *(_ptr(t, at) for o in outs for t in (o.hi, o.lo)), *tail,
            stream_arg())
        _build.check(lib, err, what)
        return (outs, None if dots is None else DF(dots[0], dots[1]),
                [DF(folded[0, k], folded[1, k]) for k in range(n_fold)])


def band_pass_argtypes(n_pointers: int) -> list:
    """ctypes argtypes of a band_pass or df_pass launcher with n_pointers
    pointer arguments after (offsets, n_diags, n, lo, hi), the stream
    included."""
    return [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong] + [_P] * n_pointers


def _check_halo(what: str, halo: int, offsets: tuple) -> None:
    """A halo form's x must hold every column its rows read."""
    reach = max((abs(o) for o in offsets), default=0)
    if halo < 0 or 0 < halo < reach:
        raise ValueError(f"{what}: halo {halo} does not cover offsets up "
                         f"to {reach}")


def dia_spmv_plain(vals: torch.Tensor, offsets: tuple, x: torch.Tensor,
                   halo: int = 0) -> torch.Tensor:
    """y = A @ x as pad-plus-slice: x padded with zeros, one shifted
    slice per diagonal (ops/dia.py dia_spmv of the JAX package). With
    halo=H, x is already extended by H entries at each end and row i
    reads x[H + i + o] (the JAX package's spmv_dia_halo slices)."""
    n = vals.shape[1] if halo else x.shape[0]
    if halo:
        lo, xp = halo, x
    else:
        lo = -min(0, min(offsets)) if offsets else 0
        hi = max(0, max(offsets)) if offsets else 0
        xp = F.pad(x, (lo, hi))
    acc = torch.zeros(n, dtype=torch.promote_types(vals.dtype, x.dtype),
                      device=x.device)
    for w, o in enumerate(offsets):
        acc = acc + vals[w] * xp[lo + o:lo + o + n]
    return acc


def dia_spmv(vals: torch.Tensor, offsets: tuple, x: torch.Tensor,
             halo: int = 0) -> torch.Tensor:
    """y = A @ x for the DIA matrix (vals [W, n], offsets); x has n
    entries, or n + 2 halo for the halo form. CPU tensors take the plain
    version; CUDA tensors the kernel, float32 or float64."""
    with span("mbt.launch.dia_spmv"):
        if x.device.type == "cpu":
            return dia_spmv_plain(vals, offsets, x, halo)
        what = "dia_spmv"
        if x.dtype not in _KERNELS:
            raise TypeError(f"{what}: dtype {x.dtype}, the kernel takes "
                            f"float32 or float64")
        if x.dim() != 1:
            raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
        check_cuda(what, x.dtype, vals=vals, x=x)
        n = x.shape[0] - 2 * halo
        _check_halo(what, halo, offsets)
        check_band(what, vals, offsets, n)
        y = x.new_empty(n)
        lib = _lib()
        err = getattr(lib, _KERNELS[x.dtype])(
            offsets_arg(offsets), len(offsets), n, halo, vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), stream_arg())
        _build.check(lib, err, what)
        dia_spmv.launches += 1
        return y


dia_spmv.launches = 0


def dia_spmv_df_plain(vals: DF, offsets: tuple, x: DF,
                      halo: int = 0) -> DF:
    """Double-float y = A @ x as pad-plus-slice, accumulated with df_fma
    from zero, diagonal by diagonal in offset order (ops/dia.py
    dia_spmv_df of the JAX package); halo as for dia_spmv_plain."""
    n = vals.hi.shape[1] if halo else x.hi.shape[0]
    if halo:
        lo, xh, xl = halo, x.hi, x.lo
    else:
        lo = -min(0, min(offsets)) if offsets else 0
        hi = max(0, max(offsets)) if offsets else 0
        xh, xl = F.pad(x.hi, (lo, hi)), F.pad(x.lo, (lo, hi))
    acc = df_zeros(n, x.device)
    for w, o in enumerate(offsets):
        acc = df_fma(acc, vals[w], DF(xh[lo + o:lo + o + n],
                                      xl[lo + o:lo + o + n]))
    return acc


def dia_spmv_df(vals: DF, offsets: tuple, x: DF, halo: int = 0) -> DF:
    """Double-float y = A @ x for the DIA matrix (vals a DF [W, n] pair,
    offsets; x of n entries, or n + 2 halo). CPU tensors take the plain
    version; CUDA tensors the kernel, which agrees with it bit for bit."""
    with span("mbt.launch.dia_spmv_df"):
        if x.device.type == "cpu":
            return dia_spmv_df_plain(vals, offsets, x, halo)
        what = "dia_spmv_df"
        if not (is_df(vals) and is_df(x)):
            raise TypeError(f"{what}: vals and x must be DF pairs")
        if x.hi.dim() != 1:
            raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
        check_cuda(what, torch.float32, vals_hi=vals.hi, vals_lo=vals.lo,
                   x_hi=x.hi, x_lo=x.lo)
        check_vectors(what, x.hi.shape[0], x_lo=x.lo)
        n = x.hi.shape[0] - 2 * halo
        _check_halo(what, halo, offsets)
        check_band(what, vals.hi, offsets, n)
        check_band(what, vals.lo, offsets, n)
        y = DF(x.hi.new_empty(n), x.hi.new_empty(n))
        lib = _lib()
        err = lib.mbt_dia_spmv_df(
            offsets_arg(offsets), len(offsets), n, halo, vals.hi.data_ptr(),
            vals.lo.data_ptr(), x.hi.data_ptr(), x.lo.data_ptr(),
            y.hi.data_ptr(), y.lo.data_ptr(), stream_arg())
        _build.check(lib, err, what)
        dia_spmv_df.launches += 1
        return y


dia_spmv_df.launches = 0
