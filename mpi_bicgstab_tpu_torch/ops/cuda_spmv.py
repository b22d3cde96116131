"""DIA SpMV: the CUDA kernels' wrappers and their plain PyTorch twins
(counterpart of mpi_bicgstab_tpu/ops/pallas_spmv.py and of the XLA DF
SpMV mpi_bicgstab_tpu/ops/dia.py::dia_spmv_df; kernel source
csrc/dia_spmv.cu).

`dia_spmv(vals, offsets, x)` (float32, float64) and
`dia_spmv_df(vals, offsets, x)` (double-float pairs, ops/precision.DF)
run the plain version for tensors on the CPU and launch the kernel for
tensors on the card; a CUDA tensor the kernel does not take raises.
Each wrapper's `.launches` counts its kernel launches. `band_pass` and
`df_pass` check and launch the fused float32 and DF passes of the other
ops/cuda_fused_*.py modules.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_fma, df_zeros, is_df

_P = ctypes.c_void_p
_KERNELS = {torch.float32: "mbt_dia_spmv_f32",
            torch.float64: "mbt_dia_spmv_f64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dia_spmv")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    lib.mbt_dia_spmv_df.argtypes = band_pass_argtypes(7)
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


def partials_scratch(like: torch.Tensor, k: int):
    """A fused pass's [G, k] per-block partials and its [k] dots."""
    return like.new_empty((grid_blocks(like.shape[0]), k)), like.new_empty(k)


def band_pass(lib, symbol: str, what: str, vals, offsets: tuple,
              vecs: dict, scalars: dict, n_out: int, n_dots: int):
    """Check and launch a fused float32 pass over the DIA band whose C
    launcher takes (offsets, n_diags, n, vals, *vecs, *scalars,
    *outputs, partials, dots, stream), in the dicts' order. Returns
    (outputs, dots): n_out fresh [n] vectors (never aliasing an input)
    and the [n_dots] dot products."""
    first = next(iter(vecs.values()))
    n = first.shape[0]
    check_vectors(what, n, **vecs)
    check_cuda(what, torch.float32, vals=vals, **vecs, **scalars)
    check_band(what, vals, offsets, n)
    outs = [torch.empty_like(first) for _ in range(n_out)]
    partials, dots = partials_scratch(first, n_dots)
    err = getattr(lib, symbol)(
        offsets_arg(offsets), len(offsets), n, vals.data_ptr(),
        *(t.data_ptr() for t in (*vecs.values(), *scalars.values(), *outs,
                                 partials, dots)),
        stream_arg())
    _build.check(lib, err, what)
    return outs, dots


def df_pass(lib, symbol: str, what: str, vals, offsets, vecs: dict,
            scalars: dict, n_out: int, n_dots: int, n_fold: int = 1):
    """Check and launch a DF pass whose C launcher takes ([offsets,
    n_diags,] n, [vals hi, lo,] then (hi, lo) of every vector and scalar
    in the dicts' order (scalars from check_scalars), of n_out fresh
    output vectors, then partials, dots, the folded scalars and the
    stream; no folded scalars when n_fold is 0). vals None: a pointwise
    pass. Returns (outputs, dots, folded scalars), all DF: the dots a
    DF [n_dots] (rows of one [2, n_dots] tensor, row 0 hi) that unpacks
    into 0-d pairs, the scalars 0-d views of a [2, n_fold] tensor."""
    first = next(iter(vecs.values()))
    for name, v in (*vecs.items(), *scalars.items()):
        if not is_df(v):
            raise TypeError(f"{what}: {name} must be a DF pair")
    n = first.hi.shape[0]
    parts = {}
    for name, v in vecs.items():
        check_vectors(what, n, **{f"{name}.hi": v.hi, f"{name}.lo": v.lo})
    for name, v in (*vecs.items(), *scalars.items()):
        parts[f"{name}.hi"], parts[f"{name}.lo"] = v.hi, v.lo
    head = [n]
    if vals is not None:
        if not is_df(vals):
            raise TypeError(f"{what}: vals must be a DF pair")
        check_cuda(what, torch.float32, vals_hi=vals.hi, vals_lo=vals.lo,
                   **parts)
        check_band(what, vals.hi, offsets, n)
        check_band(what, vals.lo, offsets, n)
        head = [offsets_arg(offsets), len(offsets), n, vals.hi.data_ptr(),
                vals.lo.data_ptr()]
    else:
        check_cuda(what, torch.float32, **parts)
    outs = [DF(torch.empty_like(first.hi), torch.empty_like(first.hi))
            for _ in range(n_out)]
    partials = first.hi.new_empty((grid_blocks(n), n_dots, 2))
    dots = first.hi.new_empty((2, n_dots))
    folded = first.hi.new_empty((2, n_fold))
    err = getattr(lib, symbol)(
        *head, *(t.data_ptr() for t in parts.values()),
        *(t.data_ptr() for o in outs for t in (o.hi, o.lo)),
        partials.data_ptr(), dots.data_ptr(),
        *((folded.data_ptr(),) if n_fold else ()), stream_arg())
    _build.check(lib, err, what)
    return (outs, DF(dots[0], dots[1]),
            [DF(folded[0, k], folded[1, k]) for k in range(n_fold)])


def band_pass_argtypes(n_pointers: int) -> list:
    """ctypes argtypes of a band_pass launcher with n_pointers pointer
    arguments after (offsets, n_diags, n), the stream included."""
    return [_P, ctypes.c_int, ctypes.c_longlong] + [_P] * n_pointers


def dia_spmv_plain(vals: torch.Tensor, offsets: tuple,
                   x: torch.Tensor) -> torch.Tensor:
    """y = A @ x as pad-plus-slice: x padded with zeros, one shifted
    slice per diagonal (ops/dia.py dia_spmv of the JAX package)."""
    n = x.shape[0]
    lo = -min(0, min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    xp = F.pad(x, (lo, hi))
    acc = torch.zeros(n, dtype=torch.promote_types(vals.dtype, x.dtype),
                      device=x.device)
    for w, o in enumerate(offsets):
        acc = acc + vals[w] * xp[lo + o:lo + o + n]
    return acc


def dia_spmv(vals: torch.Tensor, offsets: tuple,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the DIA matrix (vals [W, n], offsets). CPU tensors
    take the plain version; CUDA tensors the kernel, float32 or float64."""
    if x.device.type == "cpu":
        return dia_spmv_plain(vals, offsets, x)
    what = "dia_spmv"
    if x.dtype not in _KERNELS:
        raise TypeError(f"{what}: dtype {x.dtype}, the kernel takes "
                        f"float32 or float64")
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
    check_cuda(what, x.dtype, vals=vals, x=x)
    n = x.shape[0]
    check_band(what, vals, offsets, n)
    y = torch.empty_like(x)
    lib = _lib()
    err = getattr(lib, _KERNELS[x.dtype])(
        offsets_arg(offsets), len(offsets), n, vals.data_ptr(),
        x.data_ptr(), y.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_spmv_df_plain(vals: DF, offsets: tuple, x: DF) -> DF:
    """Double-float y = A @ x as pad-plus-slice, accumulated with df_fma
    from zero, diagonal by diagonal in offset order (ops/dia.py
    dia_spmv_df of the JAX package)."""
    n = x.hi.shape[0]
    lo = -min(0, min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    xh, xl = F.pad(x.hi, (lo, hi)), F.pad(x.lo, (lo, hi))
    acc = df_zeros(n, x.device)
    for w, o in enumerate(offsets):
        acc = df_fma(acc, vals[w], DF(xh[lo + o:lo + o + n],
                                      xl[lo + o:lo + o + n]))
    return acc


def dia_spmv_df(vals: DF, offsets: tuple, x: DF) -> DF:
    """Double-float y = A @ x for the DIA matrix (vals a DF [W, n] pair,
    offsets). CPU tensors take the plain version; CUDA tensors the
    kernel, which agrees with it bit for bit."""
    if x.device.type == "cpu":
        return dia_spmv_df_plain(vals, offsets, x)
    what = "dia_spmv_df"
    if not (is_df(vals) and is_df(x)):
        raise TypeError(f"{what}: vals and x must be DF pairs")
    if x.hi.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
    check_cuda(what, torch.float32, vals_hi=vals.hi, vals_lo=vals.lo,
               x_hi=x.hi, x_lo=x.lo)
    n = x.hi.shape[0]
    check_vectors(what, n, x_lo=x.lo)
    check_band(what, vals.hi, offsets, n)
    check_band(what, vals.lo, offsets, n)
    y = DF(torch.empty_like(x.hi), torch.empty_like(x.hi))
    lib = _lib()
    err = lib.mbt_dia_spmv_df(
        offsets_arg(offsets), len(offsets), n, vals.hi.data_ptr(),
        vals.lo.data_ptr(), x.hi.data_ptr(), x.lo.data_ptr(),
        y.hi.data_ptr(), y.lo.data_ptr(), stream_arg())
    _build.check(lib, err, what)
    dia_spmv_df.launches += 1
    return y


dia_spmv_df.launches = 0
