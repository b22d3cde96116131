"""`solve --devices N --checkpoint` (cli._run_solve_dist over
utils/checkpoint.solve_with_checkpoints with the world's group), the
port's counterpart of the JAX CLI's checkpointed distributed solve
(mpi_bicgstab_tpu/cli.py:337-420), on the CPU with two gloo ranks: rank 0
alone reads and writes the file and broadcasts a resume.

* a run cut after one segment and resumed ends with the uninterrupted
  run's x, total_iter and cum_rel, bit for bit;
* a checkpoint written for another method is refused on every rank;
* total_iter within 2 of the JAX CLI's `--devices 2 --checkpoint`;
* `solve-shifted --devices 2 --checkpoint` is still refused, as in JAX.

The ranks run cli.run_solve as a launch.Pool task (rank 0's report and
result come back), on one module-scoped pool of 2 ranks."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.cli as jcli
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.parallel import launch

torch.set_num_threads(1)
BASE = ["solve", "--matrix", "banded:4096", "--devices", "2",
        "--checkpoint-every", "5", "--device", "cpu"]


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(2, device="cpu") as p:
        yield p


def _run(pool, *argv):
    return pool.run(cli.run_solve, cli.build_parser().parse_args(
        [*BASE, *argv]))


@pytest.fixture(scope="module")
def whole(pool, tmp_path_factory):
    """The uninterrupted checkpointed run."""
    path = tmp_path_factory.mktemp("ck") / "whole.npz"
    return _run(pool, "--checkpoint", str(path))


def test_cut_and_resumed_run_equals_the_uninterrupted_one(pool, whole,
                                                          tmp_path):
    path = str(tmp_path / "cut.npz")
    first, _ = _run(pool, "--checkpoint", path, "--max-iter", "5")
    assert first["total_iter"] == 5 and not first["converged"]
    report, res = _run(pool, "--checkpoint", path)
    want_report, want = whole
    assert want_report["converged"] and report["converged"]
    for k in ("total_iter", "final_relres", "true_relres"):
        assert report[k] == want_report[k], k
    np.testing.assert_array_equal(res.x, want.x)
    # the run is complete in the file: the short report
    done, _ = _run(pool, "--checkpoint", path)
    assert done["note"] == "run already complete in checkpoint"
    assert done["total_iter"] == want_report["total_iter"]


def test_a_foreign_checkpoint_is_refused(pool, tmp_path):
    path = str(tmp_path / "ck.npz")
    _run(pool, "--checkpoint", path, "--max-iter", "5")
    with pytest.raises(RuntimeError, match="refusing to resume"):
        _run(pool, "--checkpoint", path, "--method", "ca_bicgstab")


def test_total_iter_near_the_jax_cli(whole, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main(["solve", "--matrix", "banded:4096", "--devices",
                          "2", "--checkpoint", str(tmp_path / "j.npz"),
                          "--checkpoint-every", "5", "--json",
                          "--platform", "cpu"])
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    assert code == 0 and want["converged"]
    assert abs(whole[0]["total_iter"] - want["total_iter"]) <= 2


def test_shifted_checkpoint_stays_refused(tmp_path):
    with pytest.raises(SystemExit, match="single-device"):
        cli.main(["solve-shifted", "--matrix", "banded:4096", "--sigma-len",
                  "8", "--seed", "5", "--devices", "2", "--checkpoint",
                  str(tmp_path / "s.npz"), "--device", "cpu"])
