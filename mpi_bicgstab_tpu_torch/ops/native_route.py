"""ctypes binding to the butterfly route assigner (counterpart of
mpi_bicgstab_tpu/ops/native_route.py; source csrc/butterfly_route.cpp).

The assigner is one sequential pass with immediate claims: an element
that finds its option taken retries on the spot with a fresh random
option, where the NumPy router (ops/butterfly.py) waits for the next
global round. Both give valid layouts; the native one spills far less.

native_enabled() reads MBT_NATIVE_ROUTE at every call: '0' or 'off'
switches the assigner off, and then the library is not built at all.
assign_native and color_native return None when the switch is off, and
when the library cannot allocate its claim tables (it returns -1): the
caller then routes with the NumPy rounds, as the JAX package does. With
the switch on, the source is built at first use by utils/host_build.py
into build/host/<hash>/ at the repository root; a missing g++ or a
failed build raises (the JAX package falls back to NumPy silently).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from mpi_bicgstab_tpu_torch.utils import host_build

SRC = host_build.CSRC / "butterfly_route.cpp"
TRIES = 64          # random options an element tries before it spills

_I64P = ctypes.POINTER(ctypes.c_int64)


def native_enabled() -> bool:
    """False when MBT_NATIVE_ROUTE is '0' or 'off' (read at each call)."""
    return os.environ.get("MBT_NATIVE_ROUTE", "").lower() not in ("0",
                                                                 "off")


def router() -> str:
    """The router a build would try first: 'native' or 'numpy'."""
    return "native" if native_enabled() else "numpy"


def lib_path():
    return host_build.lib_path(SRC)


@functools.cache
def library() -> ctypes.CDLL:
    """The assigner's library, built first if it is not on disk."""
    lib = ctypes.CDLL(str(host_build.build(SRC)))
    lib.bfly_assign.restype = ctypes.c_int64
    lib.bfly_assign.argtypes = ([ctypes.c_int64] + [_I64P] * 7
                                + [ctypes.c_int64] * 5
                                + [ctypes.c_uint64, ctypes.c_int64, _I64P,
                                   _I64P])
    lib.bfly_color.restype = ctypes.c_int64
    lib.bfly_color.argtypes = ([ctypes.c_int64] + [_I64P] * 4
                               + [ctypes.c_int64] * 3
                               + [ctypes.c_uint64, ctypes.c_int64, _I64P])
    return lib


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def assign_native(d, u_col, m_hi, q, src_lane, win_a, n_opts, max_k,
                  Ts, G, P, Td, seed):
    """(a_sel, m_sel): each element's u1 window and middle window, -1
    where it spills (bfly_assign); None when the switch is off or the
    library could not allocate."""
    if not native_enabled():
        return None
    E = d.size
    a_sel = np.empty(E, np.int64)
    m_sel = np.empty(E, np.int64)
    d, u_col, m_hi, q, src_lane, win_a, n_opts = (
        _c64(a) for a in (d, u_col, m_hi, q, src_lane, win_a, n_opts))
    n = library().bfly_assign(
        E, _p(d), _p(u_col), _p(m_hi), _p(q), _p(src_lane), _p(win_a),
        _p(n_opts), int(max_k), int(Ts), int(G), int(P), int(Td),
        int(seed) & (2**64 - 1), TRIES, _p(a_sel), _p(m_sel))
    return None if n < 0 else (a_sel, m_sel)


def color_native(rows, grp, lane, sub, n_pad, NR, W3, seed):
    """Each K3 entry's slab, -1 where it spills (bfly_color); None when
    the switch is off or the library could not allocate."""
    if not native_enabled():
        return None
    NE = rows.size
    w_sel = np.empty(NE, np.int64)
    rows, grp, lane, sub = (_c64(a) for a in (rows, grp, lane, sub))
    n = library().bfly_color(
        NE, _p(rows), _p(grp), _p(lane), _p(sub), int(n_pad), int(NR),
        int(W3), int(seed) & (2**64 - 1), TRIES, _p(w_sel))
    return None if n < 0 else w_sel
