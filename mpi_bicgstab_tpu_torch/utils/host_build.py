"""Build of the port's host C++ libraries (csrc/*.cpp) with g++ at first
use.

    g++ -O3 -march=native -shared -fPIC -o lib<name>.so csrc/<name>.cpp

Each library lands in build/host/<hash>/ at the repository root, keyed
by a hash of its source, the flags and the host CPU (a library built for
one CPU's instruction set is not loaded on another), never beside its
source. The build writes a temporary file and renames it into place, so
processes that build at once each see a whole library or none. A
missing g++ or a failed build raises: the port has no fallback for a
library it cannot build.
"""
from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def gxx_path(what: str) -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(f"g++ not found on PATH: {what} cannot be built")
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


def lib_path(src: Path, libs: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(FLAGS + libs).encode())
    h.update(src.read_bytes())
    h.update(_cpu_signature())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{src.stem}.so"


def build(src: Path, libs: tuple = ()) -> Path:
    """The library of `src`, built first if it is not on disk (libs:
    linker arguments after the source, such as -lpthread)."""
    path = lib_path(src, libs)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [gxx_path(f"csrc/{src.name}"), *FLAGS, "-o", str(tmp), str(src),
             *libs], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return path
