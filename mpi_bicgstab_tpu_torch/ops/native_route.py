"""ctypes binding to the butterfly route assigner (counterpart of
mpi_bicgstab_tpu/ops/native_route.py; source csrc/butterfly_route.cpp).

The source is host C++, built at first use with

    g++ -O3 -march=native -shared -fPIC -o libbutterfly_route.so
        csrc/butterfly_route.cpp

into build/host/<hash>/ at the repository root, keyed by a hash of the
source, the flags and the host CPU (a library built for one CPU's
instruction set is not loaded on another). The build writes a temporary
file and renames it into place, so processes that build at once each
see a whole library or none. A missing g++ or a failed build raises:
the port has no NumPy router to fall back on.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "butterfly_route.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
TRIES = 64          # random options an element tries before it spills

_I64P = ctypes.POINTER(ctypes.c_int64)


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the butterfly route "
                           "assigner (csrc/butterfly_route.cpp) cannot be "
                           "built")
    return found


def _cpu_signature() -> bytes:
    """The host CPU's model and feature flags (what -march=native
    compiles for)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))).encode()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu_signature())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbutterfly_route.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The assigner's library, built first if it is not on disk."""
    path = lib_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx_path(), *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
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


def _check(n: int, what: str) -> None:
    if n < 0:
        raise MemoryError(f"{what}: the route assigner could not allocate "
                          f"its claim tables")


def assign_native(d, u_col, m_hi, q, src_lane, win_a, n_opts, max_k,
                  Ts, G, P, Td, seed):
    """(a_sel, m_sel): each element's u1 window and middle window, -1
    where it spills (bfly_assign)."""
    E = d.size
    a_sel = np.empty(E, np.int64)
    m_sel = np.empty(E, np.int64)
    d, u_col, m_hi, q, src_lane, win_a, n_opts = (
        _c64(a) for a in (d, u_col, m_hi, q, src_lane, win_a, n_opts))
    _check(library().bfly_assign(
        E, _p(d), _p(u_col), _p(m_hi), _p(q), _p(src_lane), _p(win_a),
        _p(n_opts), int(max_k), int(Ts), int(G), int(P), int(Td),
        int(seed) & (2**64 - 1), TRIES, _p(a_sel), _p(m_sel)),
        "bfly_assign")
    return a_sel, m_sel


def color_native(rows, grp, lane, sub, n_pad, NR, W3, seed):
    """Each K3 entry's slab, -1 where it spills (bfly_color)."""
    NE = rows.size
    w_sel = np.empty(NE, np.int64)
    rows, grp, lane, sub = (_c64(a) for a in (rows, grp, lane, sub))
    _check(library().bfly_color(
        NE, _p(rows), _p(grp), _p(lane), _p(sub), int(n_pad), int(NR),
        int(W3), int(seed) & (2**64 - 1), TRIES, _p(w_sel)), "bfly_color")
    return w_sel
