"""Full-carry checkpoint and resume of the seed-switching shifted solver
(counterpart of save_carry / load_carry / solve_switching_with_checkpoints
in mpi_bicgstab_tpu/utils/checkpoint.py).

The solver's whole loop state (solvers/switching.init_switching_carry:
x_set, p_set, r, the scalar archives, the stop flags, the seed, the
iteration index) is written to one .npz every segment; resuming from it
reproduces the uninterrupted solve BIT-EXACTLY. The file holds the
carry's leaves in the JAX package's order (`leaf_0`, `leaf_1`, ...: the
16 slots in turn, a double-float slot as its hi then its lo array, the
iteration index and the seed as int32 scalars) and a JSON header with
the metadata, so a carry saved by either package has the same leaves
(convert.switching_carry_from_arrays turns the JAX package's into the
port's). The JAX package also records its pytree's treedef; here a
structure tag (the kind of each slot) takes its place. A file the JAX
package wrote has no tag: its slot kinds follow from its leaf count, so
load_carry resumes it too.

The iterate checkpoint of the classic family (`solve --checkpoint`) is
ROADMAP slice 9.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df

_FORMAT = 2
_STRUCTURE = "mpi_bicgstab_tpu_torch.switching_carry/"
# the seed-switching carry's 16 slots (solvers/switching.init_switching_carry):
# "i" an int32 scalar, "v" a value slot (a DF pair in df32), "t" a tensor
SWITCHING_SLOTS = "iivvvvvvvvvvtvvt"


def switching_kinds(n_leaves: int) -> str | None:
    """The slot kinds ("i", "t", "d" as in structure()) of a switching
    carry of n_leaves leaves: 16 for a float32 / float64 solve, 28 for
    df32 (each of its 12 value slots a hi, lo pair); None for any other
    count."""
    df = {16: False, 28: True}.get(n_leaves)
    if df is None:
        return None
    return SWITCHING_SLOTS.replace("v", "d" if df else "t")


def _slot_kind(v) -> str:
    if is_df(v):
        return "d"
    return "t" if torch.is_tensor(v) else "i"


def structure(carry) -> str:
    """The carry's structure tag: one letter per slot (i int, t tensor,
    d double-float pair)."""
    return _STRUCTURE + "".join(_slot_kind(v) for v in carry)


def carry_leaves(carry) -> list:
    """The carry's leaves as host NumPy arrays, in the JAX package's
    order."""
    out = []
    for v in carry:
        if is_df(v):
            out += [v.hi.detach().cpu().numpy(), v.lo.detach().cpu().numpy()]
        elif torch.is_tensor(v):
            out.append(v.detach().cpu().numpy())
        else:
            out.append(np.asarray(v, np.int32))
    return out


def _leaf_specs(carry) -> list:
    """(shape, NumPy dtype) of each leaf, without copying any to the
    host."""
    out = []
    for v in carry:
        if torch.is_tensor(v) or is_df(v):
            for t in ((v.hi, v.lo) if is_df(v) else (v,)):
                dt = torch.empty(0, dtype=t.dtype).numpy().dtype
                out.append((tuple(t.shape), dt))
        else:
            out.append(((), np.dtype(np.int32)))
    return out


def _atomic_savez(path: str, **arrays):
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_carry(path: str, carry, meta: dict):
    """Atomically write a switching carry and its metadata."""
    leaves = carry_leaves(carry)
    header = dict(format=_FORMAT, kind="carry", n_leaves=len(leaves),
                  structure=structure(carry), **meta)
    _atomic_savez(path, header=json.dumps(header),
                  **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def load_carry(path: str, template, expect: dict | None = None):
    """The carry saved at `path` on the devices of `template` (e.g.
    solvers.switching.init_switching_carry(...)), or None when the file
    is absent. Raises on any metadata, structure, shape or dtype mismatch
    rather than resume the wrong run."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        saved = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]
    if header.get("format") != _FORMAT or header.get("kind") != "carry":
        raise ValueError(f"{path} is not a carry checkpoint")
    for k, v in (expect or {}).items():
        if header.get(k) != v:
            raise ValueError(
                f"carry checkpoint {path} was written for "
                f"{k}={header.get(k)!r}, refusing to resume a run with "
                f"{k}={v!r}")
    want = _leaf_specs(template)
    tag = header.get("structure")
    if tag is None and "treedef" in header:
        # written by the JAX package: the kinds follow from the leaf count
        kinds = switching_kinds(len(saved))
        tag = kinds and _STRUCTURE + kinds
    if tag != structure(template) or len(saved) != len(want):
        raise ValueError(f"carry checkpoint {path} has a different "
                         "solver-state structure (solver version or "
                         "configuration changed)")
    for i, (s, (shape, dt)) in enumerate(zip(saved, want)):
        if s.shape != shape or s.dtype != dt:
            raise ValueError(
                f"carry leaf {i}: checkpoint has {s.shape}/{s.dtype}, "
                f"solver expects {shape}/{dt}")
    return unflatten(template, saved)


def unflatten(template, leaves):
    """A carry shaped like `template` (kinds and devices) from its leaves
    in order."""
    out, i = [], 0
    for v in template:
        if is_df(v):
            out.append(DF(torch.from_numpy(np.array(leaves[i])).to(v.device),
                          torch.from_numpy(np.array(leaves[i + 1])).to(
                              v.device)))
            i += 2
        elif torch.is_tensor(v):
            out.append(torch.from_numpy(np.array(leaves[i])).to(v.device))
            i += 1
        else:
            out.append(int(leaves[i]))
            i += 1
    return tuple(out)


def solve_switching_with_checkpoints(segment_runner, init_carry, path: str,
                                     segment_iters: int, max_iter: int,
                                     meta: dict):
    """Run the seed-switching solver in segments of `segment_iters`
    iterations, saving the FULL carry after each; resumes from `path`
    when present. segment_runner(carry, k_stop) -> (ShiftedResult,
    carry). The segmented run is bit-identical to an uninterrupted one.

    Returns (result, total_iters)."""
    from mpi_bicgstab_tpu_torch.solvers.switching import (carry_k,
                                                          carry_stop_flags)
    if segment_iters < 1:
        raise ValueError("segment_iters must be >= 1")
    carry = load_carry(path, init_carry, expect=meta)
    if carry is None:
        carry = init_carry
    res = None
    while True:
        k = carry_k(carry)                      # next iteration index
        done = k - 1                            # :559 reports k-1
        if bool(carry_stop_flags(carry).all()) or done >= max_iter:
            if res is None:
                # the checkpoint alone satisfies the run: a zero-length
                # segment produces the result
                res, carry = segment_runner(carry, k)
            break
        res, carry = segment_runner(carry, k + segment_iters)
        save_carry(path, carry, meta)
    return res, carry_k(carry) - 1
