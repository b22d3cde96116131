"""Port vs JAX package: `solve-shifted` (cli.py, reference main_shifted.c).

On the CPU (`--device cpu`) the port's command prints the JAX package's
solve-shifted fields under the same keys, agrees with the JAX command on
the same generator matrix and ladder (n_iter within +-2, the same final
seed, all shifts converged, max true relative error at most 100 tol), and
exits 0 when every shift converged, 2 otherwise. Without --device cpu the
command runs on the card, and raises on a machine without one.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.cli as jcli
from mpi_bicgstab_tpu_torch import cli

torch.set_num_threads(1)

BASE = ["solve-shifted", "--matrix", "banded:512", "--sigma-len", "6",
        "--seed", "3", "--tol", "1e-10", "--max-iter", "300"]


def _port(*extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main([*BASE, *extra, "--device", "cpu"])
    return code, out.getvalue()


def _port_rows(*extra):
    args = cli.build_parser().parse_args([*BASE, *extra, "--device", "cpu"])
    rows, res = cli.run_solve_shifted(args)
    return rows, res


def _parse(text):
    """The printed `key: value` lines as a dict of strings."""
    out = {}
    for line in text.splitlines():
        k, _, v = line.partition(":")
        out[k.strip()] = v.strip()
    return out


def _jax(*extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*BASE, *extra, "--platform", "cpu", "--json"])
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_payload_matches_jax(dtype):
    jcode, want = _jax("--dtype", dtype, "--check-error")
    (got,), _ = _port_rows("--dtype", dtype, "--check-error")
    assert set(got) == set(want)
    assert jcode == 0 and got["all_converged"] and want["all_converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    for k in ("method", "matrix", "n", "sigma_len", "seed", "final_seed",
              "devices", "sigma_devices"):
        assert got[k] == want[k], k
    assert got["max_true_rel_error"] <= 100 * 1e-10
    assert got["seed_true_relres"] <= 100 * 1e-10


def test_prints_every_key_and_exits_0():
    code, text = _port("--dtype", "df32")
    fields = _parse(text)
    assert code == 0 and fields["all_converged"] == "True"
    (row,), _ = _port_rows("--dtype", "df32")
    assert set(fields) == set(row)


def test_default_seed_fits_a_short_ladder():
    """Without --seed the reference's 255 does not fit a short ladder: both
    CLIs refuse it alike (the sweep mode alone clamps the seed), and both
    take the seed once it is given."""
    argv = ["solve-shifted", "--matrix", "banded:512", "--sigma-len", "8",
            "--tol", "1e-10"]
    with pytest.raises(SystemExit) as jex:
        jcli.main([*argv, "--platform", "cpu"])
    with pytest.raises(SystemExit) as tex:
        cli.main([*argv, "--device", "cpu"])
    assert str(tex.value) == str(jex.value)
    assert "--seed 255 out of range for --sigma-len 8" in str(tex.value)
    (row,), _ = cli.run_solve_shifted(cli.build_parser().parse_args(
        [*argv, "--seed", "7", "--device", "cpu"]))
    assert row["seed"] == 7 and row["all_converged"]


def test_exit_2_when_a_shift_does_not_converge():
    code, text = _port("--max-iter", "3")
    assert code == 2 and _parse(text)["all_converged"] == "False"


def test_refine_write_solution_and_rhs(tmp_path):
    rhs = np.random.default_rng(0).standard_normal(512)
    np.save(tmp_path / "b.npy", rhs)
    sol = tmp_path / "x.npy"
    (row,), res = _port_rows("--tol", "1e-6", "--refine", "--rhs",
                             str(tmp_path / "b.npy"), "--write-solution",
                             str(sol))
    # the recurrence solutions already meet tol here: refine checks them
    assert row["refine_iters"] == 0
    assert row["max_true_relres_after_refine"] <= 1e-6
    xs = np.load(sol)
    assert xs.shape == (6, 512) and xs.dtype == np.float64
    from mpi_bicgstab_tpu_torch.models.generators import banded_random
    w = max(2, int(round(512 ** (1 / 3))))
    csr = banded_random(512, [1, -1, w, -w, w * w, -w * w], seed=0)
    sigma = np.arange(1, 7) * (0.01 / 6)
    res_true = [np.linalg.norm(csr.matvec(x) + s * x - rhs)
                / np.linalg.norm(rhs) for s, x in zip(sigma, xs)]
    assert max(res_true) <= 100 * 1e-6


def test_sigma_len_sweep_prints_one_row_per_length():
    args = cli.build_parser().parse_args(
        [*BASE, "--sigma-len-sweep", "2,5", "--seed", "9", "--device",
         "cpu"])
    printed = []
    rows, _ = cli.run_solve_shifted(args, report=printed.append)
    assert [r["sigma_len"] for r in rows] == [2, 5] and printed == rows
    assert [r["seed"] for r in rows] == [1, 4]      # clamped into the ladder


def test_bad_arguments_exit():
    with pytest.raises(SystemExit, match="out of range"):
        _port("--seed", "6")
    with pytest.raises(SystemExit, match="seed-switching"):
        _port("--method", "shifted_lopbicgstab", "--checkpoint", "c.npz")
    with pytest.raises(SystemExit, match="--repeat"):
        _port("--checkpoint", "c.npz", "--repeat", "2")
    with pytest.raises(SystemExit):                   # not accepted yet
        _port("--devices", "2")
    with pytest.raises(SystemExit):
        _port("--sigma-devices", "2")


def test_every_method_runs():
    for method in ("shifted_bicgstab", "shifted_lopbicgstab_v2",
                   "shifted_pipe_lopbicgstab_nooverlap", "shifted_lopbicg"):
        code, text = _port("--method", method, "--tol", "1e-8")
        assert code == 0, (method, text)


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(BASE)
