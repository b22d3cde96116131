"""ctypes binding to the C++ Matrix Market body parser (counterpart of
mpi_bicgstab_tpu/io/native.py; source csrc/mmio_fast.cpp, the port's own
copy of the JAX package's io/csrc/mmio_fast.cpp).

The reference fscanf's every entry of the .mtx on every rank, twice
(matrix.c:315-393); csrc/mmio_fast.cpp parses the body in one pass over
chunks on all host threads. The source is built at first use by
utils/host_build.py into build/host/<hash>/ (not beside the source, as
the JAX package does). A missing g++ or a failed build raises, where the
JAX package quietly takes its NumPy path; a body the native scan cannot
count raises ValueError, which io/mmio.read_matrix_market answers with
the NumPy path, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from mpi_bicgstab_tpu_torch.utils import host_build

SRC = host_build.CSRC / "mmio_fast.cpp"
LIBS = ("-lpthread",)


def lib_path():
    return host_build.lib_path(SRC, LIBS)


@functools.cache
def library() -> ctypes.CDLL:
    """The parser's library, built first if it is not on disk."""
    lib = ctypes.CDLL(str(host_build.build(SRC, LIBS)))
    lib.mmio_parse_body.restype = ctypes.c_int64
    lib.mmio_parse_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    return lib


def parse_body_native(body: bytes, nnz: int, is_pattern: bool,
                      nthreads: int = 0):
    """(rows, cols, vals): int64, int64 and float64 arrays of the nnz
    entries of a coordinate body (0-based; vals 1.0 for a pattern file).
    nthreads 0 takes every host thread. Raises ValueError when the body
    does not hold nnz entries the scan can read."""
    lib = library()
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    # strtod may read past a chunk's end: the buffer ends in a NUL
    buf = body if body.endswith(b"\0") else body + b"\0"
    got = lib.mmio_parse_body(
        buf, len(body), nnz, 2 if is_pattern else 3,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nthreads)
    if got != nnz:
        raise ValueError(
            f"native MM parse failed (code {got}, expected {nnz} entries)")
    if is_pattern:
        vals.fill(1.0)
    return rows, cols, vals
