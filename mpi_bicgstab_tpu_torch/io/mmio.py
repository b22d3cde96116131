"""Matrix Market (.mtx) reader / writer (counterpart of
mpi_bicgstab_tpu/io/mmio.py).

The reference's NIST mmio layer (mm_read_banner mmio.c:96,
mm_read_mtx_crd_size mmio.c:189) plus the COO load fixups of
matrix.c:26-94: 1-based -> 0-based indices, val = 1.0 for `pattern`
files, and symmetric / skew-symmetric storage expanded to general COO
(or refused with expand_symmetric=False). A coordinate body read as
bytes is parsed by the C++ parser (io/native.py) on all host threads;
a body it cannot count, a text body, or use_native=False takes the
NumPy path, which parses it in one shot.
"""
from __future__ import annotations

import dataclasses
import functools
import gzip
import io as _io
import warnings

import numpy as np

_VALID_OBJECTS = ("matrix",)
_VALID_FORMATS = ("coordinate", "array")
_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclasses.dataclass(frozen=True)
class MMHeader:
    """Parsed banner + size line (reference MM_typecode, mmio.h:19-29)."""

    object: str
    format: str
    field: str
    symmetry: str
    nrows: int
    ncols: int
    nnz: int  # stored entries (before symmetric expansion)

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry in ("symmetric", "skew-symmetric", "hermitian")


def _open(path_or_file, mode="rb"):
    if hasattr(path_or_file, "read"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, mode), True
    return open(p, mode), True


def _text(line) -> str:
    return line.decode("latin-1") if isinstance(line, bytes) else line


def read_banner(path_or_file) -> MMHeader:
    """Parse the %%MatrixMarket banner and size line, raising ValueError
    where the reference returns MM_* error codes."""
    f, close = _open(path_or_file)
    try:
        banner = _text(f.readline())
        parts = banner.strip().split()
        if len(parts) != 5 or parts[0] != "%%MatrixMarket":
            raise ValueError(f"not a Matrix Market file (banner: {banner!r})")
        _, obj, fmt, field, sym = (p.lower() for p in parts)
        if obj not in _VALID_OBJECTS:
            raise ValueError(f"unsupported MM object {obj!r}")
        if fmt not in _VALID_FORMATS:
            raise ValueError(f"unsupported MM format {fmt!r}")
        if field not in _VALID_FIELDS:
            raise ValueError(f"unsupported MM field {field!r}")
        if sym not in _VALID_SYMMETRIES:
            raise ValueError(f"unsupported MM symmetry {sym!r}")

        # size line: first non-comment, non-blank line (mmio.c:196-204)
        while True:
            line = _text(f.readline())
            if not line:
                raise ValueError("premature EOF before MM size line")
            s = line.strip()
            if s and not s.startswith("%"):
                break
        dims = s.split()
        if fmt == "coordinate":
            if len(dims) != 3:
                raise ValueError(f"bad coordinate size line {s!r}")
            nrows, ncols, nnz = (int(d) for d in dims)
        else:
            if len(dims) != 2:
                raise ValueError(f"bad array size line {s!r}")
            nrows, ncols = (int(d) for d in dims)
            nnz = nrows * ncols
        return MMHeader(obj, fmt, field, sym, nrows, ncols, nnz)
    finally:
        if close:
            f.close()


@functools.cache
def _fromstring_ok() -> bool:
    """np.fromstring(text, sep=' ') is deprecated but far faster than
    str.split(); use it only where it still parses correctly."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = np.fromstring("1 2.5", sep=" ")
        return bool(out.shape == (2,) and out[1] == 2.5)
    except (ValueError, TypeError, AttributeError):
        return False


def _parse_numbers(body: str) -> np.ndarray:
    if _fromstring_ok():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.fromstring(body, sep=" ")
    return np.array(body.split(), dtype=np.float64)


def read_matrix_market(path_or_file, expand_symmetric: bool = True,
                       dtype=np.float64, use_native: bool = True):
    """Read a .mtx file into COO arrays (rows, cols, vals, (nrows, ncols))
    — coo_load_matrix (matrix.c:26-94) with the fixups in the module
    docstring. Complex matrices are rejected (the reference is
    real-only). use_native=False takes the NumPy path; a missing g++ or
    a failed build of the native parser raises (io/native.py)."""
    f, close = _open(path_or_file)
    try:
        hdr = read_banner(f)   # leaves the cursor at the body
        body = f.read()
    finally:
        if close:
            f.close()

    if hdr.field == "complex":
        raise ValueError("complex Matrix Market files are not supported "
                         "(reference is real-only, matrix.c:26)")
    if hdr.format != "coordinate":
        return _read_array_body(hdr, _text(body), dtype)

    out = None
    if use_native and isinstance(body, bytes):
        from mpi_bicgstab_tpu_torch.io.native import parse_body_native
        try:
            out = parse_body_native(body, hdr.nnz, hdr.is_pattern)
        except ValueError:
            out = None   # a body the native scan cannot count: NumPy path
    if out is not None:
        rows, cols, vals = out
        vals = vals.astype(dtype, copy=False)
    else:
        rows, cols, vals = _parse_body(hdr, _text(body), dtype)

    if (rows < 0).any() or (rows >= hdr.nrows).any() \
            or (cols < 0).any() or (cols >= hdr.ncols).any():
        raise ValueError("MM entry index out of range")

    if hdr.is_symmetric:
        if not expand_symmetric:
            raise ValueError(
                "symmetric .mtx storage requires expand_symmetric=True "
                "(the reference silently dropped the upper triangle)")
        rows, cols, vals = _expand_symmetry(hdr, rows, cols, vals)
    return rows, cols, vals, (hdr.nrows, hdr.ncols)


def _parse_body(hdr: MMHeader, body: str, dtype):
    """(rows, cols, vals) of a coordinate body by NumPy."""
    # comment lines may legally appear mid-body
    if "%" in body:
        body = "\n".join(ln for ln in body.splitlines()
                         if not ln.lstrip().startswith("%"))
    flat = _parse_numbers(body)
    per = 2 if hdr.is_pattern else 3
    if flat.size != hdr.nnz * per:
        raise ValueError(
            f"MM body has {flat.size} numbers, expected {hdr.nnz * per} "
            f"({hdr.nnz} entries x {per})")
    flat = flat.reshape(hdr.nnz, per)
    rows = flat[:, 0].astype(np.int64) - 1  # 1-based fixup (matrix.c:76-77)
    cols = flat[:, 1].astype(np.int64) - 1
    if hdr.is_pattern:
        vals = np.ones(hdr.nnz, dtype=dtype)  # matrix.c:68-73
    else:
        vals = flat[:, 2].astype(dtype)
    return rows, cols, vals


def _expand_symmetry(hdr: MMHeader, rows, cols, vals):
    off = rows != cols
    mr, mc, mv = rows[off], cols[off], vals[off]
    if hdr.symmetry == "skew-symmetric":
        mv = -mv
    return (np.concatenate([rows, mc]), np.concatenate([cols, mr]),
            np.concatenate([vals, mv]))


def _read_array_body(hdr: MMHeader, body: str, dtype):
    flat = _parse_numbers(body).astype(dtype)
    if flat.size != hdr.nrows * hdr.ncols:
        raise ValueError("MM array body size mismatch")
    if hdr.is_symmetric:
        raise ValueError("symmetric dense MM files are not supported")
    dense = flat.reshape(hdr.ncols, hdr.nrows).T  # column-major on disk
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    return (rows.astype(np.int64), cols.astype(np.int64), vals,
            (hdr.nrows, hdr.ncols))


def write_matrix_market(path, rows, cols, vals, shape, comment: str = ""):
    """Write a general real coordinate .mtx file."""
    nrows, ncols = shape
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        for ln in comment.splitlines():
            f.write(f"% {ln}\n")
        f.write(f"{nrows} {ncols} {len(vals)}\n")
        buf = _io.StringIO()
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")
        f.write(buf.getvalue())
