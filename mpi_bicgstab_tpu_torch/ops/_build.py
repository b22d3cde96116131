"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each csrc/*.cu file becomes its own shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

The libraries go to build/kernels/<hash>/ at the repository root, keyed
by a hash of every csrc/ file and the flags, so an edit rebuilds and an
unchanged tree reuses what is there. The build happens at first use;
build_all() compiles every source in parallel (one nvcc each) and is
what `python3 chip_smoke.py` calls first. A missing nvcc or a failed
build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("dia_spmv", "fused_classic", "fused_ca", "fused_pipe",
           "fused_classic_df", "fused_ca_df", "fused_pipe_df",
           "shift_update_df", "batched_spmv", "fused_batched", "cheby",
           "pipe_df_bodies", "window_spmv", "butterfly",
           "classic_df_bodies")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _paths(name: str) -> tuple[Path, Path]:
    d = build_dir()
    return d / f"lib{name}.so", d / f"{name}.ptxas.txt"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: ptxas report} for every source (the report
    of the build that produced the library on disk)."""
    pending = []
    for name in names:
        lib, log = _paths(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, lib, log, tmp, proc))
    failed = []
    for name, lib, log, tmp, proc in pending:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _paths(name)[1].read_text() for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it if needed."""
    lib_path, _ = _paths(name)
    if not lib_path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(lib_path))
    lib.mbt_error_string.argtypes = [ctypes.c_int]
    lib.mbt_error_string.restype = ctypes.c_char_p
    lib.mbt_max_diags.restype = ctypes.c_int
    lib.mbt_block_rows.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned an error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.mbt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
