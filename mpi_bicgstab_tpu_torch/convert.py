"""State carried across from the JAX package.

operator_from_arrays builds the port's operator from the arrays of a JAX
DiaMatrix, EllMatrix or HybridMatrix passed as NumPy (np.asarray of each
leaf), so that one operator can be driven through both packages:

    kind 'dia':    arrays {"vals": [W, n]}, or {"vals_hi", "vals_lo"}
                   for a double-float operator (the JAX DF pair's leaves);
                   meta {"offsets": tuple, "n": int}
    kind 'ell':    arrays {"cols": [width, n_rows] int, "vals": [width,
                   n_rows], "tail_rows", "tail_cols", "tail_vals"};
                   meta {"n_rows": int, "n_cols": int}
    kind 'hybrid': the 'dia' arrays prefixed "dia_" and the 'ell' arrays
                   prefixed "ell_"; the 'dia' meta (n is the square size)

Any "vals" or "tail_vals" array may come as the pair "<key>_hi",
"<key>_lo" instead, which gives DF values. df_from_arrays builds a DF
vector (b, x0) from the leaves of a JAX DF pair.

config_from_fields builds a SolverConfig from the fields of a JAX
SolverConfig (dataclasses.asdict).
"""
from __future__ import annotations

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix
from mpi_bicgstab_tpu_torch.ops.layout import HybridMatrix
from mpi_bicgstab_tpu_torch.ops.precision import DF
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig, canon_dtype
from mpi_bicgstab_tpu_torch.utils.device import resolve_device

_ELL_KEYS = ("cols", "vals", "tail_rows", "tail_cols", "tail_vals")
# JAX SolverConfig field with no meaning here: history is always recorded
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


def operator_from_arrays(kind: str, arrays: dict, meta: dict,
                         device="cuda"):
    """The port's operator of `kind` from NumPy arrays (see module doc)."""
    dev = resolve_device(device)
    if kind == "dia":
        return _dia(arrays, meta, dev)
    if kind == "ell":
        return _ell(arrays, meta, dev)
    if kind == "hybrid":
        n = int(meta["n"])
        return HybridMatrix(_dia(arrays, meta, dev, "dia_"),
                            _ell(arrays, {"n_rows": n, "n_cols": n}, dev,
                                 "ell_"))
    raise ValueError(f"unknown operator kind {kind!r}; expected 'dia', "
                     f"'ell' or 'hybrid'")


def config_from_fields(fields: dict) -> SolverConfig:
    """SolverConfig from a JAX SolverConfig's fields (krr and nrr
    included). record_history is dropped; serialize_comm=True (the JAX
    package's distributed no-overlap A/B mode) raises until the
    distributed layer is ported."""
    fields = dict(fields)
    if fields.pop("serialize_comm", False):
        raise NotImplementedError(
            "serialize_comm (the distributed no-overlap mode) is not "
            "ported yet: ROADMAP slice 8 (distributed)")
    for k in _IGNORED:
        fields.pop(k, None)
    if "dtype" in fields:
        fields["dtype"] = canon_dtype(fields["dtype"])
    return SolverConfig(**fields)
