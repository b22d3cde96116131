"""State carried across from the JAX package.

operator_from_arrays builds the port's operator from the arrays of a JAX
DiaMatrix, EllMatrix, HybridMatrix, WindowEllMatrix or ButterflyMatrix
passed as NumPy
(np.asarray of each leaf), so that one operator can be driven through
both packages:

    kind 'dia':    arrays {"vals": [W, n]}, or {"vals_hi", "vals_lo"}
                   for a double-float operator (the JAX DF pair's leaves);
                   meta {"offsets": tuple, "n": int}
    kind 'ell':    arrays {"cols": [width, n_rows] int, "vals": [width,
                   n_rows], "tail_rows", "tail_cols", "tail_vals"};
                   meta {"n_rows": int, "n_cols": int}
    kind 'hybrid': the 'dia' arrays prefixed "dia_" and the 'ell' arrays
                   prefixed "ell_"; the 'dia' meta (n is the square size)
    kind 'window': arrays {"sub_sel", "lane_idx" (int8 [W, T, 8, 128]),
                   "vals" ([W, T, 8, 128]), "window_base" (int32 [T]),
                   "tail_rows", "tail_cols" (int32 [L, cap]),
                   "tail_vals"}; meta {"n_rows", "n_cols", "width",
                   "x_rows", "tail_counts"} (a WindowEllMatrix's static
                   fields; a tail needs its per-level counts, which the
                   JAX package's distributed shards leave empty)
    kind 'butterfly': arrays {"k1_src" (int32 [P]), "k1_sub", "k1_lane",
                   "k2_sub", "k2_lane" (int8 [P, 8, 128]), "k3_sub",
                   "k3_lane" (int8 [W//8, 8, NR, 128]), "k3_vals" (same
                   shape), "tail_rows", "tail_cols" (int32 [L, cap]),
                   "tail_vals"}; meta {"rb", "n_rows", "n_cols", "n_pad",
                   "nc_pad", "P", "nnz", "tail_n"} (a ButterflyMatrix's
                   static fields)

Any "vals", "k3_vals" or "tail_vals" array may come as the pair "<key>_hi",
"<key>_lo" instead, which gives DF values. df_from_arrays builds a DF
vector (b, x0) from the leaves of a JAX DF pair. cheby_operator_from_arrays
builds the port's ops/cheby.ChebyOperator from a JAX ChebyOperator: its
inner operator's arrays and meta as above, and its degree, lo and hi.

config_from_fields builds a SolverConfig from the fields of a JAX
SolverConfig (dataclasses.asdict), shifted_config_from_fields a
ShiftedConfig from those of a JAX ShiftedConfig.

switching_carry_from_arrays turns a JAX seed-switching carry, given as
its NumPy leaves (as the JAX package's save_carry writes them: np.asarray
of each leaf of the flattened 16-slot tuple), into the port's carry, so
that a solve begun in the JAX package resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.butterfly import ButterflyMatrix
from mpi_bicgstab_tpu_torch.ops.cheby import ChebyOperator
from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix
from mpi_bicgstab_tpu_torch.ops.layout import HybridMatrix
from mpi_bicgstab_tpu_torch.ops.precision import DF
from mpi_bicgstab_tpu_torch.ops.window_ell import WindowEllMatrix
from mpi_bicgstab_tpu_torch.utils.checkpoint import switching_kinds, unflatten
from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig, SolverConfig,
                                                 canon_dtype)
from mpi_bicgstab_tpu_torch.utils.device import resolve_device

_ELL_KEYS = ("cols", "vals", "tail_rows", "tail_cols", "tail_vals")
_WINDOW_KEYS = ("sub_sel", "lane_idx", "vals", "window_base", "tail_rows",
                "tail_cols", "tail_vals")
_BUTTERFLY_KEYS = ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane",
                   "k3_sub", "k3_lane", "k3_vals", "tail_rows", "tail_cols",
                   "tail_vals")
_BUTTERFLY_META = ("rb", "n_rows", "n_cols", "n_pad", "nc_pad", "P", "nnz",
                   "tail_n")
# JAX config field with no meaning here: history is always recorded
_IGNORED = ("record_history",)


def df_from_arrays(hi, lo, device="cuda") -> DF:
    """A DF pair on `device` from the float32 hi and lo arrays of a JAX
    DF pair."""
    dev = resolve_device(device)
    return DF(torch.from_numpy(np.array(hi, np.float32)).to(dev),
              torch.from_numpy(np.array(lo, np.float32)).to(dev))


def _values(arrays, key, dev):
    """arrays[key] as a tensor, or the pair key_hi / key_lo as a DF."""
    if key + "_hi" in arrays:
        return df_from_arrays(arrays[key + "_hi"], arrays[key + "_lo"], dev)
    return torch.from_numpy(np.array(arrays[key])).to(dev)


def _dia(arrays, meta, dev, prefix=""):
    vals = _values(arrays, prefix + "vals", dev)
    n = int(meta["n"])
    offsets = tuple(int(o) for o in meta["offsets"])
    if len(vals.shape) != 2 or vals.shape[1] != n \
            or vals.shape[0] < len(offsets):
        raise ValueError(f"DIA vals of shape {tuple(vals.shape)} do not "
                         f"match {len(offsets)} offsets and n={n}")
    return DiaMatrix(vals, offsets, n, n)


def _ell(arrays, meta, dev, prefix=""):
    t = {k: _values(arrays, prefix + k, dev) for k in _ELL_KEYS}
    return EllMatrix(t["cols"], t["vals"], t["tail_rows"], t["tail_cols"],
                     t["tail_vals"], int(meta["n_rows"]),
                     int(meta["n_cols"]))


def _window(arrays, meta, dev):
    t = {k: _values(arrays, k, dev) for k in _WINDOW_KEYS}
    return WindowEllMatrix(
        t["sub_sel"], t["lane_idx"], t["vals"], t["window_base"],
        t["tail_rows"], t["tail_cols"], t["tail_vals"],
        n_rows=int(meta["n_rows"]), n_cols=int(meta["n_cols"]),
        width=int(meta["width"]), x_rows=int(meta["x_rows"]),
        tail_counts=tuple(int(c) for c in meta["tail_counts"]))


def _butterfly(arrays, meta, dev):
    return ButterflyMatrix(
        **{k: _values(arrays, k, dev) for k in _BUTTERFLY_KEYS},
        **{k: int(meta[k]) for k in _BUTTERFLY_META})


def operator_from_arrays(kind: str, arrays: dict, meta: dict,
                         device="cuda"):
    """The port's operator of `kind` from NumPy arrays (see module doc)."""
    dev = resolve_device(device)
    if kind == "dia":
        return _dia(arrays, meta, dev)
    if kind == "ell":
        return _ell(arrays, meta, dev)
    if kind == "window":
        return _window(arrays, meta, dev)
    if kind == "butterfly":
        return _butterfly(arrays, meta, dev)
    if kind == "hybrid":
        n = int(meta["n"])
        return HybridMatrix(_dia(arrays, meta, dev, "dia_"),
                            _ell(arrays, {"n_rows": n, "n_cols": n}, dev,
                                 "ell_"))
    raise ValueError(f"unknown operator kind {kind!r}; expected 'dia', "
                     f"'ell', 'hybrid', 'window' or 'butterfly'")


def cheby_operator_from_arrays(kind: str, arrays: dict, meta: dict,
                               degree: int, lo: float, hi: float,
                               device="cuda") -> ChebyOperator:
    """The port's ChebyOperator over operator_from_arrays(kind, arrays,
    meta), with a JAX ChebyOperator's degree and bounds."""
    return ChebyOperator(operator_from_arrays(kind, arrays, meta, device),
                         int(degree), float(lo), float(hi))


def _port_fields(fields: dict) -> dict:
    """A JAX config's fields as the port's config takes them:
    record_history is dropped; serialize_comm (the distributed no-overlap
    A/B mode) is carried."""
    fields = dict(fields)
    for k in _IGNORED:
        fields.pop(k, None)
    if "dtype" in fields:
        fields["dtype"] = canon_dtype(fields["dtype"])
    return fields


def config_from_fields(fields: dict) -> SolverConfig:
    """SolverConfig from a JAX SolverConfig's fields (krr and nrr
    included; see _port_fields)."""
    return SolverConfig(**_port_fields(fields))


def shifted_config_from_fields(fields: dict) -> ShiftedConfig:
    """ShiftedConfig from a JAX ShiftedConfig's fields (see
    _port_fields)."""
    return ShiftedConfig(**_port_fields(fields))


def switching_carry_from_arrays(leaves, device="cuda"):
    """The port's seed-switching carry on `device` from the NumPy leaves of
    a JAX carry: 16 leaves for a float32 / float64 solve, 28 for df32
    (each of its 12 value slots a hi, lo pair)."""
    dev = resolve_device(device)
    kinds = switching_kinds(len(leaves))
    if kinds is None:
        raise ValueError(f"a switching carry has 16 leaves (28 in df32), "
                         f"got {len(leaves)}")
    z = torch.zeros(0, device=dev)
    template = [0 if c == "i" else DF(z, z) if c == "d" else z
                for c in kinds]
    return unflatten(template, [np.asarray(a) for a in leaves])
