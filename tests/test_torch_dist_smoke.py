"""chip_smoke.py's distributed and profile phases at a small size on the
CPU: each helper on a gloo group of one rank in this process (as the
card runs them on one NCCL rank) and of two ranks (parallel/launch.Pool,
chip_smoke's helpers run by the ranks through launch.call_script), where
every wrapper takes its
plain twin and counts no launch; and check_dist_counts, the launch rule
of the distributed phases on the card, case by case. Both packages are
imported, as in every port test; the JAX package has no counterpart of
these phases."""
import importlib.util
import sys
from pathlib import Path

import jax  # noqa: F401  (the test files import both packages)
import pytest
import torch

import mpi_bicgstab_tpu  # noqa: F401
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.ops import cuda_spmv
from mpi_bicgstab_tpu_torch.ops.cheby import estimate_bounds
from mpi_bicgstab_tpu_torch.parallel import launch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N = 512


SCRIPT = str(REPO / "chip_smoke.py")


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


smoke = _chip_smoke()


@pytest.fixture(scope="module")
def one_rank():
    smoke.init_world("cpu")
    yield
    smoke.end_world()


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(2, device="cpu") as p:
        yield p


def _inputs(phase):
    """(helper, args) of a phase at a CPU size."""
    if phase in smoke.DIST_PATHS:
        return smoke.run_dist_path, (phase, tgen.transport_like(N))
    if phase == "dist_window":
        return smoke.run_dist_layout, (phase, tgen.clustered_random(2048))
    if phase == "dist_butterfly":
        return smoke.run_dist_layout, (phase, smoke.uniform_csr(2048))
    if phase == "dist_shifted":
        return smoke.run_dist_shifted, (tgen.transport_like(N),)
    if phase == "dist_batched":
        return smoke.run_dist_batched, (tgen.transport_like(N),)
    if phase == "dist_overlap":
        return smoke.run_dist_overlap, (tgen.transport_like(N),)
    if phase == "dist_checkpoint":
        return smoke.run_dist_checkpoint, (tgen.transport_like(N),)
    csr = tgen.transport_hard(N)
    return smoke.run_dist_cheby, (csr, *estimate_bounds(csr))


PHASES = [*smoke.DIST_PATHS, "dist_window", "dist_butterfly",
          "dist_shifted", "dist_batched", "dist_cheby", "dist_overlap",
          "dist_checkpoint"]
SHIFTED_KW = {"S": 16, "seed": 15}


def _kw(phase, tmp_path):
    if phase == "dist_shifted":
        return SHIFTED_KW
    return {"workdir": str(tmp_path)} if phase == "dist_checkpoint" else {}


@pytest.mark.parametrize("phase", PHASES)
def test_dist_phase_one_rank_on_cpu(one_rank, phase, capsys, tmp_path):
    fn, args = _inputs(phase)
    kw = _kw(phase, tmp_path)
    out = fn(*args, n_devices=1, device="cpu", **kw)
    assert not any(out["counts"].values())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{phase}] ") and "launches={}" in line


@pytest.mark.parametrize("phase", ["dist", "dist_ca", "dist_pipe",
                                   "dist_df32", "dist_ring",
                                   "dist_window", "dist_butterfly",
                                   "dist_shifted", "dist_cheby",
                                   "dist_batched", "dist_overlap",
                                   "dist_checkpoint"])
def test_dist_phase_two_ranks_on_cpu(pool, phase, tmp_path):
    fn, args = _inputs(phase)
    kw = _kw(phase, tmp_path)
    out = pool.run(launch.call_script, SCRIPT, fn.__name__, *args,
                   n_devices=2, device="cpu", **kw)
    assert out["ranks"] == 2 and not any(out["counts"].values())


def test_bench_dist_tool_on_cpu():
    """`[tools]`' bench --devices 1 --what overlap,scaling, in its own
    process as on the card: the one-rank labels."""
    line = smoke.run_bench_dist(N, device="cpu", iters=6)
    assert line["scaling_devices"] == [1] and line["devices"] == 1


def test_dist_cli_and_profile_phases_on_cpu(one_rank, tmp_path, capsys):
    smoke.run_dist_cli(N, device="cpu")
    smoke.run_profile_path(N, device="cpu", workdir=tmp_path)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(ln.startswith("[dist_cli] ") for ln in lines)
    assert lines[-1].startswith("[profile] ")
    assert (tmp_path / "profile_trace" / "trace.json").exists()


def test_no_twin_on_card_guard():
    class OnCard:
        device = torch.device("cuda")
    with smoke.no_twin_on_card():
        with pytest.raises(smoke.SmokeFailure, match="plain twin"):
            cuda_spmv.dia_spmv_plain(OnCard(), (0,), OnCard())
        y = cuda_spmv.dia_spmv_plain(torch.ones(1, 4), (0,), torch.ones(4))
    assert torch.equal(y, torch.ones(4))
    assert cuda_spmv.dia_spmv_plain.__name__ == "dia_spmv_plain"


def _counts(**kw):
    base = dict.fromkeys(("dia_spmv", "dia_spmv_df", "window_rows",
                          "butterfly_k1", "butterfly_k2", "butterfly_decode",
                          "butterfly_k3", "shift_update_df", "fused_k1",
                          "fused_k2", "fused_k3", "fused_ca_k1",
                          "fused_ca_k2", "fused_k1_df"), 0)
    return {**base, **kw}


CLASSIC = ("fused_k1", "fused_k2", "fused_k3")
FUSED_KW = {"per_iter": 0, "per_seg": 2, "passes": CLASSIC}


@pytest.mark.parametrize("kernel,it,counts,kw,ok", [
    # one segment: 2 per iteration and r0 + the true residual
    ("dia_spmv", 8, _counts(dia_spmv=18), {}, True),
    # three segments (restarts 2)
    ("dia_spmv", 8, _counts(dia_spmv=22), {}, True),
    ("dia_spmv", 8, _counts(dia_spmv=24), {}, False),
    ("dia_spmv", 8, _counts(dia_spmv=17), {}, False),
    ("dia_spmv", 8, _counts(dia_spmv=18, dia_spmv_df=1), {}, False),
    ("dia_spmv_df", 14, _counts(dia_spmv_df=30), {}, True),
    # the butterfly: K3 per SpMV, the table built once
    ("butterfly_k3", 9, _counts(butterfly_k3=20, butterfly_k1=1,
                                butterfly_k2=1, butterfly_decode=1),
     {"also": {"butterfly_k1": 1, "butterfly_k2": 1,
               "butterfly_decode": 1}}, True),
    ("butterfly_k3", 9, _counts(butterfly_k3=20),
     {"also": {"butterfly_k1": 1, "butterfly_k2": 1,
               "butterfly_decode": 1}}, False),
    # 8 lanes: each lane one to three segments
    ("dia_spmv", 70, _counts(dia_spmv=156), {"lanes": 8}, True),
    ("dia_spmv", 70, _counts(dia_spmv=154), {"lanes": 8}, False),
    # cheby:8: 9 SpMVs an application of A p(A), 8 for the exit
    ("dia_spmv", 30, _counts(dia_spmv=9 * 62 + 8),
     {"per_op": 9, "exit_launches": 8}, True),
    ("dia_spmv", 30, _counts(dia_spmv=9 * 62 + 7),
     {"per_op": 9, "exit_launches": 8}, False),
    # the halo-fused route: each pass once an iteration, the SpMV kernel
    # per_seg times a segment (classic: r0 and the true residual)
    ("dia_spmv", 8, _counts(dia_spmv=2, fused_k1=8, fused_k2=8,
                            fused_k3=8), FUSED_KW, True),
    ("dia_spmv", 8, _counts(dia_spmv=6, fused_k1=8, fused_k2=8,
                            fused_k3=8), FUSED_KW, True),
    ("dia_spmv", 8, _counts(dia_spmv=2, fused_k1=8, fused_k2=8,
                            fused_k3=7), FUSED_KW, False),
    ("dia_spmv", 8, _counts(dia_spmv=18, fused_k1=8, fused_k2=8,
                            fused_k3=8), FUSED_KW, False),
    # CA: r0, w0 and the true residual a segment
    ("dia_spmv", 9, _counts(dia_spmv=3, fused_ca_k1=9, fused_ca_k2=9),
     {"per_iter": 0, "per_seg": 3,
      "passes": ("fused_ca_k1", "fused_ca_k2")}, True),
    ("dia_spmv", 9, _counts(dia_spmv=4, fused_ca_k1=9, fused_ca_k2=9),
     {"per_iter": 0, "per_seg": 3,
      "passes": ("fused_ca_k1", "fused_ca_k2")}, False),
    ("dia_spmv", 9, _counts(dia_spmv=3, fused_ca_k1=9, fused_ca_k2=9,
                            fused_k1_df=1),
     {"per_iter": 0, "per_seg": 3,
      "passes": ("fused_ca_k1", "fused_ca_k2")}, False),
])
def test_check_dist_counts(kernel, it, counts, kw, ok):
    if ok:
        smoke.check_dist_counts("t", kernel, it, counts, 2, **kw)
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.check_dist_counts("t", kernel, it, counts, 2, **kw)


def test_check_dist_counts_on_cpu_wants_none():
    smoke.check_dist_counts("t", "dia_spmv", 8, _counts(), 2, device="cpu")
    with pytest.raises(smoke.SmokeFailure, match="on the CPU"):
        smoke.check_dist_counts("t", "dia_spmv", 8, _counts(dia_spmv=18), 2,
                                device="cpu")
