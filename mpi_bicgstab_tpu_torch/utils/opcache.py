"""Persistent operator-layout cache (counterpart of
mpi_bicgstab_tpu/utils/opcache.py: operator_key, save_operator,
load_operator).

Building a layout on the host is the costly part of starting a solve:
the butterfly route takes ~15 s at the reference's Transport size, the
windowed-ELL build ~6 s, and the DIA analysis scans the whole matrix.
This cache removes that rebuild from repeat solves of the same matrix:
the built operator goes into one .npz keyed by a content hash of the
CSR it was built from (padded and reordered, as the build saw it) and
every build option, the layout's route included, so a stale or
mismatched entry cannot be hit: a changed value, shape, option or
LAYOUT_VERSION changes the key.

Serialisation walks the operator dataclasses on a whitelist (DiaMatrix,
EllMatrix, HybridMatrix, WindowEllMatrix, ButterflyMatrix, the row
partition's PartitionedMatrix, and DF pairs for df32): tensors go into
the npz, the rest into a JSON entry; no pickle. Only a dataclass's init fields are stored. Derived fields
(WindowEllMatrix.rc_*, ButterflyMatrix.k3_col) are rebuilt by the
class's __post_init__ on load, on the loading caller's device, which is
where every tensor lands (on the card the butterfly's column table is
routed anew there: one K1, one K2 and one decode launch).

The JAX package's entries share the directory when both packages read
MBT_LAYOUT_CACHE: this package's files are named torch_layout_<key>.npz
and carry their own format tag, and its keys hash their own version, so
neither package ever loads the other's entry. A failed save warns and
the solve runs uncached; a missing or unreadable entry is rebuilt.

The JAX package also points XLA's persistent compilation cache at a
directory (enable_compile_cache); that has no counterpart here: the
nvcc and g++ products already persist under build/ (ops/_build.py,
utils/host_build.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
import zipfile

import numpy as np
import torch

# bump when a layout's build output changes (fields, padding, routing):
# old entries then miss
LAYOUT_VERSION = 1
FORMAT = "mpi_bicgstab_tpu_torch.layout"
PREFIX = "torch_layout_"


def _registry() -> dict:
    """name -> class of everything the cache may rebuild (imported late:
    the layouts import the kernel wrappers)."""
    from mpi_bicgstab_tpu_torch.ops.butterfly import ButterflyMatrix
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix
    from mpi_bicgstab_tpu_torch.ops.layout import HybridMatrix
    from mpi_bicgstab_tpu_torch.ops.precision import DF
    from mpi_bicgstab_tpu_torch.ops.window_ell import WindowEllMatrix
    from mpi_bicgstab_tpu_torch.parallel.partition import PartitionedMatrix
    return {c.__name__: c for c in (DiaMatrix, EllMatrix, HybridMatrix,
                                    WindowEllMatrix, ButterflyMatrix,
                                    PartitionedMatrix, DF)}


def operator_key(csr, **options) -> str:
    """Content hash of the CSR (shape, and each array's dtype and bytes),
    the build options (sorted) and LAYOUT_VERSION."""
    h = hashlib.blake2b(digest_size=20)
    h.update(f"torch-v{LAYOUT_VERSION};{tuple(csr.shape)};".encode())
    for arr in (csr.ptr, csr.col, csr.val):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(json.dumps(options, sort_keys=True, default=str).encode())
    return h.hexdigest()


def entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{PREFIX}{key}.npz")


def _walk_save(obj, path: str, arrays: dict, registry: dict):
    """obj -> a JSON-able node; tensors land in `arrays` under `path`."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if registry.get(name) is not type(obj):
            raise TypeError(f"layout cache: unsupported class {name}")
        return {"__class__": name, "fields": {
            f.name: _walk_save(getattr(obj, f.name), f"{path}.{f.name}",
                               arrays, registry)
            for f in dataclasses.fields(obj) if f.init}}
    if torch.is_tensor(obj):
        arrays[path] = obj.detach().cpu().numpy()
        return {"__tensor__": path}
    if isinstance(obj, tuple):
        return {"__tuple__": [_walk_save(v, f"{path}[{i}]", arrays,
                                         registry)
                              for i, v in enumerate(obj)]}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"layout cache: unsupported value at {path}: "
                    f"{type(obj).__name__}")


def _walk_load(node, arrays: dict, registry: dict, device):
    if isinstance(node, dict):
        if "__class__" in node:
            kw = {k: _walk_load(v, arrays, registry, device)
                  for k, v in node["fields"].items()}
            return registry[node["__class__"]](**kw)
        if "__tensor__" in node:
            return torch.from_numpy(arrays[node["__tensor__"]]).to(device)
        if "__tuple__" in node:
            return tuple(_walk_load(v, arrays, registry, device)
                         for v in node["__tuple__"])
    return node


def save_operator(cache_dir: str, key: str, op) -> str | None:
    """Write op as the entry `key`; returns its path. A failed save (a
    read-only directory, a full disk, a class the walk does not know)
    warns and returns None: the operator is already built, and the solve
    runs uncached."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        arrays: dict[str, np.ndarray] = {}
        meta = {"format": FORMAT, "version": LAYOUT_VERSION,
                "op": _walk_save(op, "op", arrays, _registry())}
        path = entry_path(cache_dir, key)
        # published by a rename: a crashed or concurrent writer never
        # leaves a torn entry
        tmp = os.path.join(cache_dir, f".tmp_{PREFIX}{key}_{os.getpid()}.npz")
        np.savez(tmp, __meta__=np.asarray(json.dumps(meta)), **arrays)
        os.replace(tmp, path)
        return path
    except Exception as e:  # noqa: BLE001 — any failure: run uncached
        warnings.warn(f"layout cache write failed ({e}); continuing "
                      f"uncached", stacklevel=2)
        return None


def load_operator(cache_dir: str, key: str, device="cpu"):
    """The cached operator of `key` with its tensors on `device`, or None
    when the entry is missing, unreadable, or not this package's."""
    path = entry_path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("format") != FORMAT \
                    or meta.get("version") != LAYOUT_VERSION:
                return None
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return _walk_load(meta["op"], arrays, _registry(), device)
    except (OSError, ValueError, KeyError, TypeError, EOFError,
            zipfile.BadZipFile):
        return None      # a corrupt entry: the caller rebuilds it
