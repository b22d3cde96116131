"""Checkpoint and resume of long solves (counterpart of
mpi_bicgstab_tpu/utils/checkpoint.py). The reference has none: a failure
aborts the whole job. Two mechanisms:

* The classic family's ITERATE checkpoint (save_checkpoint,
  load_checkpoint, solve_with_checkpoints; `solve [--devices N]
  --checkpoint`; over a distributed runner rank 0 alone reads and writes
  the file and broadcasts a resume to the group, so the ranks need no
  shared file system): a
  BiCGStab restart from x0 = the saved iterate (r recomputed as b - A x0)
  is exact mathematically; the Krylov space is rebuilt, costing a few
  iterations, for a checkpoint of one vector, valid across methods,
  dtypes and versions. The file is one .npz with the iterate (a DF
  iterate as its float64 value, so a df32 run resumes losslessly, as DF
  pairs again) and a JSON header, in the JAX package's format: each
  package resumes the other's file. Not for the shifted family, whose
  recurrences need x0 = 0 for every shift.

* The seed-switching shifted solver's FULL-CARRY checkpoint (save_carry,
  load_carry, solve_switching_with_checkpoints; `solve-shifted
  --checkpoint`): the solver's whole loop state
  (solvers/switching.init_switching_carry: x_set, p_set, r, the scalar
  archives, the stop flags, the seed, the iteration index) is written to
  one .npz every segment; resuming from it reproduces the uninterrupted
  solve BIT-EXACTLY. The file holds the carry's leaves in the JAX
  package's order (`leaf_0`, `leaf_1`, ...: the 16 slots in turn, a
  double-float slot as its hi then its lo array, the iteration index and
  the seed as int32 scalars) and a JSON header with the metadata, so a
  carry saved by either package has the same leaves
  (convert.switching_carry_from_arrays turns the JAX package's into the
  port's). The JAX package also records its pytree's treedef; here a
  structure tag (the kind of each slot) takes its place. A file the JAX
  package wrote has no tag: its slot kinds follow from its leaf count,
  so load_carry resumes it too.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.precision import DF, df_to_f64, is_df

_ITERATE_FORMAT = 1
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


# --- the classic family's iterate checkpoint --------------------------------

def _host_iterate(x) -> tuple[str, np.ndarray]:
    """(kind, host array): a DF iterate as its float64 value ("df"), a
    tensor as it is ("arr")."""
    if is_df(x):
        return "df", df_to_f64(x)
    return "arr", x.detach().cpu().numpy()


def save_checkpoint(path: str, x, n_iter_done: int, meta: dict):
    """Atomically write the solver iterate x ([n], a tensor or a DF pair)
    and its metadata."""
    kind, data = _host_iterate(x)
    header = dict(format=_ITERATE_FORMAT, kind=kind,
                  n_iter_done=int(n_iter_done), **meta)
    _atomic_savez(path, x=data, header=json.dumps(header))


def load_checkpoint(path: str, expect: dict | None = None):
    """(x as a host array, n_iter_done, header), or None when the file is
    absent. expect: metadata that must match (the matrix, the method...);
    a mismatch raises rather than resume a different run."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        x = z["x"]
    if header.get("format") != _ITERATE_FORMAT:
        raise ValueError(f"unknown checkpoint format in {path}")
    for k, v in (expect or {}).items():
        if header.get(k) != v:
            raise ValueError(
                f"checkpoint {path} was written for {k}={header.get(k)!r}, "
                f"refusing to resume a run with {k}={v!r}")
    return x, int(header["n_iter_done"]), header


def _resume(path: str, meta: dict, group):
    """load_checkpoint(path, meta); with a process group, rank 0 loads it
    and broadcasts what it found (or its error, which every rank then
    raises) to the others."""
    if group is None:
        return load_checkpoint(path, expect=meta)
    import torch.distributed as dist
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = ("ok", load_checkpoint(path, expect=meta))
        except Exception as e:   # noqa: BLE001 — re-raised on every rank
            box[0] = ("error", f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(box, src=0, group=group)
    kind, payload = box[0]
    if kind == "error":
        raise ValueError(payload)
    return payload


def solve_with_checkpoints(runner, path: str, segment_iters: int,
                           max_iter: int, meta: dict, tol: float,
                           x_key: str = "x", group=None):
    """Run runner(x0_host or None, iters_budget, tol_segment) in segments,
    saving the iterate after each; resumes from `path` when it exists.

    Each restarted segment measures its residual against ITS OWN r0 =
    b - A x0, so the original stopping rule (relative to ||b||, from x0 =
    0) holds through scaling: tol_segment = tol / the product of the
    earlier segments' final relres (cum_rel). The product is stored in
    the checkpoint, so a resumed process keeps the original rule.

    runner returns a result with n_iter, converged, final_relres and the
    iterate under x_key. Returns (the last result or None, total
    iterations, cum_rel): cum_rel is the residual relative to the
    original ||b||, what the solve without checkpoints reports; the
    result is None when the checkpoint alone satisfies the run
    (converged, or out of budget).

    group: the torch.distributed group of a distributed runner, called
    on every rank with the global iterate on each: rank 0 reads the file
    and broadcasts the iterate, done and cum_rel to the group (_resume),
    rank 0 alone saves each segment, and a barrier after each save keeps
    the ranks in step."""
    if segment_iters < 1:
        raise ValueError("segment_iters must be >= 1")
    writer = True
    if group is not None:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    resumed = _resume(path, meta, group)
    x0 = None
    done = 0
    cum_rel = 1.0
    if resumed is not None:
        x0, done, header = resumed
        cum_rel = float(header.get("cum_rel", 1.0))
    res = None
    while done < max_iter and cum_rel > tol:
        budget = min(segment_iters, max_iter - done)
        tol_seg = min(tol / max(cum_rel, 1e-300), 0.5)
        res = runner(x0, budget, tol_seg)
        done += int(res.n_iter)
        # a breakdown's NaN and an exact solve's 0.0 both belong in the
        # cumulative residual
        cum_rel *= float(res.final_relres)
        x = getattr(res, x_key)
        if writer:
            save_checkpoint(path, x, done, dict(meta, cum_rel=cum_rel))
        if group is not None:
            dist.barrier(group=group)
        if bool(res.converged) or int(res.n_iter) < budget:
            break
        x0 = _host_iterate(x)[1]
    return res, done, cum_rel
