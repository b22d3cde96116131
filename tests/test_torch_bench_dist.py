"""The distributed sections of the port's bench (benchmarks/runner.py:
bench_overlap, bench_scaling, and `bench --devices N`), the counterpart
of the JAX package's runner (runner.py:68,206,288,357-450), on the CPU
with gloo ranks (the host clock times them; no device number comes from
here):

* bench_scaling(max_devices=2) sweeps [1, 2] with speedup_d1 1.0 and
  the "cpu-gloo" label, as JAX tests/test_bench.py:42-51 checks its own;
* bench_overlap has the JAX package's keys, plus the label of what its
  collectives crossed; both sides' times positive;
* `bench --devices 2 --what spmv,iter` has the JAX line's keys (and the
  card's name and power limit, as every port bench line), the JAX line
  taken with its timers stubbed.

One module-scoped pool of 2 ranks runs every port section."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.benchmarks.runner as jrunner
import mpi_bicgstab_tpu.cli as jcli
from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.benchmarks import runner
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.parallel import launch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(2, device="cpu") as p:
        yield p


def _csr():
    return tgen.banded_random(2048, [1, -1, 16, -16], seed=3)


def test_bench_scaling_sweep(pool):
    r = pool.run(runner.bench_scaling, _csr(), "float32", max_devices=2,
                 method="bicgstab", iters=6, device="cpu")
    assert r["scaling_devices"] == [1, 2]
    assert r["speedup_d1"] == 1.0
    assert r["time_per_iter_s_d1"] > 0 and r["time_per_iter_s_d2"] > 0
    assert r["speedup_d2"] > 0
    assert r["scaling_fabric"] == "cpu-gloo"


def test_bench_overlap_has_the_jax_keys(pool, monkeypatch):
    monkeypatch.setattr(jrunner, "_slope_time", lambda *a, **k: 1e-3)
    want = jrunner.bench_overlap(
        jgen.banded_random(2048, [1, -1, 16, -16], seed=3), np.float32,
        devices=2, iters=6)
    got = pool.run(runner.bench_overlap, _csr(), "float32", 2, iters=12,
                   device="cpu")
    assert set(got) == set(want) | {"overlap_fabric"}
    assert got["overlap_method"] == want["overlap_method"]
    assert got["time_per_iter_overlap_s"] > 0
    assert got["time_per_iter_serialized_s"] > 0
    assert got["overlap_gain"] == (got["time_per_iter_serialized_s"]
                                   / got["time_per_iter_overlap_s"])
    assert got["overlap_fabric"] == "cpu-gloo"


def test_bench_devices_keys_equal_jax(pool, monkeypatch):
    argv = ["bench", "--matrix", "banded:2048", "--devices", "2", "--what",
            "spmv,iter", "--iters", "6"]
    monkeypatch.setattr(jrunner, "_slope_time", lambda *a, **k: 1e-3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jrunner.run_bench(jcli.build_parser().parse_args(
            [*argv, "--platform", "cpu"])) == 0
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = pool.run(runner.bench_report, cli.build_parser().parse_args(
        [*argv, "--device", "cpu"]))
    assert set(got) == set(want) | {"device_name", "power_limit"}
    for k in ("matrix", "n", "nnz", "dtype", "devices", "spmv_layout",
              "iter_method"):
        assert got[k] == want[k], k
    assert got["devices"] == 2 and got["backend"] == "cpu"
    assert got["spmv_s"] > 0 and got["time_per_iter_s"] > 0
