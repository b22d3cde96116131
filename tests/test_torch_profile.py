"""The port's `profile` (benchmarks/sections.py, CLI `profile`) against
the JAX package's: the same phase keys for one device and for two, the
JSON line and the torch.profiler trace; and the CLI's distributed solves
(`solve --devices 2`, `solve-shifted --devices 4 --sigma-devices 2`,
gloo ranks on the CPU) against the JAX CLI's on its virtual devices:
n_iter within 2. One module-scoped pool of 4 ranks (parallel/launch.Pool)
serves the two-device sections."""
import json

import jax.numpy as jnp
import pytest
import torch

import mpi_bicgstab_tpu.cli as jcli
from mpi_bicgstab_tpu.benchmarks import sections as jsec
from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.benchmarks import sections
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.parallel import launch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_profile_sections_one_device_keys_match_jax():
    t = tgen.transport_like(4096)
    j = jgen.transport_like(4096)
    got = sections.profile_sections(t, torch.float32, sigma_len=4,
                                    iters=12, device="cpu")
    want = jsec.profile_sections(j, jnp.float32, sigma_len=4, iters=12)
    assert set(got) == set(want) == {"spmv", "axpy", "dot", "shifted_iter",
                                     "shift_update"}
    assert all(v >= 0 for v in got.values())
    assert got["spmv"] > 0 and got["shifted_iter"] > 0


def test_profile_sections_two_devices_keys_match_jax(pool):
    t = tgen.transport_like(4096)
    j = jgen.transport_like(4096)
    got = pool.run(sections.dist_sections, t, torch.float32, 2, 12)
    want = jsec.profile_sections(j, jnp.float32, devices=2, iters=12)
    assert set(got) == set(want) == {"spmv_total", "halo_exchange",
                                     "allgather", "allreduce_dot"}
    assert all(v > 0 for v in got.values())


def test_cli_profile_json_and_trace(tmp_path, capsys):
    rc = cli.main(["profile", "--matrix", "transport-like:4096", "--json",
                   "--iters", "12", "--device", "cpu", "--trace",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and f"trace written to {tmp_path}" in out
    line = _last_json(out)
    assert {"matrix", "n", "nnz", "devices", "spmv_s", "axpy_s",
            "dot_s"} <= set(line) and line["devices"] == 1
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_solve_devices_2_matches_jax_cli(capfd):
    argv = ["solve", "--matrix", "banded:4096", "--json", "--devices", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capfd.readouterr().out)
    assert jcli.main(argv) == 0
    want = _last_json(capfd.readouterr().out)
    assert set(got) == set(want)
    assert got["devices"] == want["devices"] == 2 and got["converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2


def test_cli_solve_shifted_grid_matches_jax_cli(capfd):
    argv = ["solve-shifted", "--matrix", "banded:4096", "--sigma-len", "8",
            "--seed", "7", "--tol", "1e-10", "--json", "--devices", "4",
            "--sigma-devices", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capfd.readouterr().out)
    assert jcli.main(argv) == 0
    want = _last_json(capfd.readouterr().out)
    assert got["devices"] == 4 and got["sigma_devices"] == 2
    assert got["all_converged"] and want["all_converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert got["final_seed"] == want["final_seed"]


def test_cli_devices_refusals(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["solve", "--matrix", "banded:4096", "--devices", "2"])
    for argv, msg in (
            (["solve", "--matrix", "banded:4096", "--devices", "2",
              "--rhs-batch", "B.npy"], "--rhs-batch is single-device"),
            (["solve-shifted", "--matrix", "banded:4096", "--sigma-len", "6",
              "--seed", "5", "--devices", "2", "--sigma-devices", "4"],
             "not divisible by --sigma-devices 4"),
            (["solve-shifted", "--matrix", "banded:4096", "--sigma-len", "8",
              "--seed", "5", "--sigma-devices", "2"],
             "requires the distributed path")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(argv + ["--device", "cpu"])
    # bench --what overlap runs (one spawned rank, its line on its own
    # standard output)
    assert cli.main(["bench", "--what", "overlap", "--matrix", "banded:512",
                     "--iters", "6", "--device", "cpu"]) == 0
