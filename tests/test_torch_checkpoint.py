"""Full-carry checkpoint and resume of the seed-switching solver
(utils/checkpoint.py, api.solve_shifted_checkpointed), and a solve begun
in the JAX package resumed in the port (convert.switching_carry_from_arrays).

Fixture: the JAX package's checkpoint fixture of tests/test_checkpoint.py
(banded_random(256), the wide ladder, seed 4, which switches early). A
segmented port run must be BIT-identical to the uninterrupted port run;
a JAX carry saved after 7 iterations and resumed in the port must end
with the n_iter and final seed of JAX's uninterrupted solve, its
solutions within 1e-8 of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.utils.checkpoint as jckpt
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu.parallel.comm import Comm as JComm
from mpi_bicgstab_tpu.solvers.switching import init_switching_carry as jinit
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.api import _ladder
from mpi_bicgstab_tpu_torch.ops.layout import spmv
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.switching import (
    carry_k, init_switching_carry, shifted_lopbicg_switching_segment)
from mpi_bicgstab_tpu_torch.utils import checkpoint as ckpt
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig

torch.set_num_threads(1)

SIGMA = np.array([0.0, 0.05, 0.2, 1.0, 4.0])
META = {"n": 256, "sigma_len": 5}


def _setup(dtype="float64", max_iter=800):
    csr = tgen.banded_random(256, [1, -1, 10, -10], seed=7)
    prob = tprob.build_problem(csr, dtype=dtype, multiple=1, device="cpu",
                               sigma_seed=float(SIGMA[4]))
    return prob, ShiftedConfig(tol=1e-11, max_iter=max_iter, dtype=dtype)


def _leaves(x):
    return [x.hi, x.lo] if tp.is_df(x) else [x]


def _assert_same(a, b):
    assert a.n_iter == b.n_iter and a.final_seed == b.final_seed
    for u, v in zip(_leaves(a.x_set) + [a.shift_relres, a.stop_flags],
                    _leaves(b.x_set) + [b.shift_relres, b.stop_flags]):
        assert torch.equal(u, v)
    h = ~torch.isnan(a.history)
    assert torch.equal(a.history[h], b.history[~torch.isnan(b.history)])


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_segmented_run_is_bit_identical(dtype, tmp_path):
    """Two short segments, a saved carry (simulated preemption), then a
    resume from the file alone in segments of 4, across a seed switch."""
    prob, cfg = _setup(dtype)
    ref = tapi.solve_shifted(prob.A, prob.b, SIGMA, seed=4,
                             method="shifted_lopbicg_switching", cfg=cfg)
    assert bool(ref.stop_flags.all()) and ref.n_iter > 12
    assert ref.final_seed != 4
    path = str(tmp_path / "sw.npz")
    sig = _ladder(prob.b, SIGMA)
    A = prob.A
    carry = init_switching_carry(prob.b, sig, 4, cfg, comm=Comm())
    _, carry = shifted_lopbicg_switching_segment(
        lambda v: spmv(A, v), Comm(), prob.b, sig, cfg, carry, 7)
    assert carry_k(carry) == 7
    ckpt.save_carry(path, carry, META)
    res, total = tapi.solve_shifted_checkpointed(
        prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path, segment_iters=4,
        meta=META)
    assert total == ref.n_iter
    _assert_same(ref, res)


def test_meta_or_structure_mismatch_refuses_to_resume(tmp_path):
    prob, cfg = _setup()
    path = str(tmp_path / "sw.npz")
    tapi.solve_shifted_checkpointed(prob.A, prob.b, SIGMA, seed=4, cfg=cfg,
                                    path=path, segment_iters=10, meta=META)
    with pytest.raises(ValueError, match="refusing to resume"):
        tapi.solve_shifted_checkpointed(
            prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path,
            segment_iters=10, meta={**META, "sigma_len": 6})
    # another max_iter changes the archives' shapes
    with pytest.raises(ValueError, match="structure|leaf"):
        tapi.solve_shifted_checkpointed(
            prob.A, prob.b, SIGMA, seed=4, cfg=cfg.replace(max_iter=801),
            path=path, segment_iters=10, meta=META)
    # a df32 run cannot resume a float64 carry
    pdf, cdf = _setup("df32")
    with pytest.raises(ValueError, match="structure"):
        tapi.solve_shifted_checkpointed(pdf.A, pdf.b, SIGMA, seed=4,
                                        cfg=cdf, path=path,
                                        segment_iters=10, meta=META)
    with pytest.raises(ValueError, match="segment_iters"):
        tapi.solve_shifted_checkpointed(prob.A, prob.b, SIGMA, seed=4,
                                        cfg=cfg, path=str(tmp_path / "x"),
                                        segment_iters=0, meta=META)


def test_finished_checkpoint_short_circuits(tmp_path):
    prob, cfg = _setup()
    path = str(tmp_path / "sw.npz")
    res1, it1 = tapi.solve_shifted_checkpointed(
        prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path,
        segment_iters=50, meta=META)
    assert bool(res1.stop_flags.all())
    res2, it2 = tapi.solve_shifted_checkpointed(
        prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path,
        segment_iters=50, meta=META)
    assert it2 == it1
    _assert_same(res1, res2)


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_jax_carry_resumes_in_the_port(dtype, tmp_path):
    """A carry saved by the JAX package after 7 iterations (its own
    save_carry file), its leaves turned into the port's carry, finishes in
    the port with the n_iter and final seed of JAX's uninterrupted solve."""
    jprob_ = jprob.build_problem(
        jgen.banded_random(256, [1, -1, 10, -10], seed=7), dtype=dtype,
        sigma_seed=float(SIGMA[4]))
    jc = jcfg.ShiftedConfig(tol=1e-11, max_iter=800,
                            dtype=jnp.float32 if dtype == "df32"
                            else jnp.float64)
    sig_j = (jp.df_from_f64(SIGMA) if dtype == "df32"
             else jnp.asarray(SIGMA, jprob_.b.dtype))

    def jax_segment(k_stop, carry=None):
        if carry is None:
            carry = jinit(jprob_.b, sig_j, 4, jc, comm=JComm(None))
        return japi._switching_segment_jit(jprob_.A, jprob_.b, sig_j, jc,
                                           carry, jnp.int32(k_stop))

    # uninterrupted: one segment to the end (the JAX package's own tests
    # hold it bit-equal to solve_shifted)
    ref, _ = jax_segment(jc.max_iter + 1)
    _, carry = jax_segment(7)
    path = str(tmp_path / "jax.npz")
    jckpt.save_carry(path, carry, META)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    assert len(leaves) == (28 if dtype == "df32" else 16)
    port_carry = convert.switching_carry_from_arrays(leaves, device="cpu")
    prob, cfg = _setup(dtype)
    assert carry_k(port_carry) == 7
    assert ckpt.structure(port_carry) == ckpt.structure(
        init_switching_carry(prob.b, SIGMA, 4, cfg))
    sig = _ladder(prob.b, SIGMA)
    res, out = shifted_lopbicg_switching_segment(
        lambda v: spmv(prob.A, v), Comm(), prob.b, sig, cfg, port_carry,
        cfg.max_iter + 1)
    assert res.n_iter == int(ref.n_iter)
    assert res.final_seed == int(ref.final_seed)
    assert bool(res.stop_flags.all())
    want = (jp.df_to_f64(ref.x_set) if dtype == "df32"
            else np.asarray(ref.x_set))
    got = tp.df_to_f64(res.x_set) if dtype == "df32" else res.x_set.numpy()
    np.testing.assert_allclose(got, want, atol=1e-8)
    # and a port carry saved to disk has the same leaves, in order
    path2 = str(tmp_path / "port.npz")
    ckpt.save_carry(path2, out, META)
    with np.load(path2) as z:
        assert len(z.files) - 1 == len(leaves)
        for i, leaf in enumerate(leaves):
            assert z[f"leaf_{i}"].shape == leaf.shape
            assert z[f"leaf_{i}"].dtype == leaf.dtype


def test_carry_conversion_refuses_a_wrong_leaf_count():
    with pytest.raises(ValueError, match="16 leaves"):
        convert.switching_carry_from_arrays([np.zeros(1)] * 15, device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_jax_written_carry_file_resumes_in_the_port(dtype, tmp_path):
    """The file the JAX package's save_carry writes (its header records a
    treedef, no structure tag) resumes through the port's load_carry, as
    `solve-shifted --checkpoint FILE` does, bit-identical to the resume
    through convert.switching_carry_from_arrays."""
    jprob_ = jprob.build_problem(
        jgen.banded_random(256, [1, -1, 10, -10], seed=7), dtype=dtype,
        sigma_seed=float(SIGMA[4]))
    jc = jcfg.ShiftedConfig(tol=1e-11, max_iter=800,
                            dtype=jnp.float32 if dtype == "df32"
                            else jnp.float64)
    sig_j = (jp.df_from_f64(SIGMA) if dtype == "df32"
             else jnp.asarray(SIGMA, jprob_.b.dtype))
    carry = jinit(jprob_.b, sig_j, 4, jc, comm=JComm(None))
    _, carry = japi._switching_segment_jit(jprob_.A, jprob_.b, sig_j, jc,
                                           carry, jnp.int32(7))
    path = str(tmp_path / "jax.npz")
    jckpt.save_carry(path, carry, META)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    prob, cfg = _setup(dtype)
    # its metadata is still checked
    with pytest.raises(ValueError, match="refusing to resume"):
        tapi.solve_shifted_checkpointed(
            prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path,
            segment_iters=5, meta={**META, "n": 257})
    # through the file, as the CLI resumes it
    res, total = tapi.solve_shifted_checkpointed(
        prob.A, prob.b, SIGMA, seed=4, cfg=cfg, path=path, segment_iters=5,
        meta=META)
    # through the leaves
    ref, _ = shifted_lopbicg_switching_segment(
        lambda v: spmv(prob.A, v), Comm(), prob.b, _ladder(prob.b, SIGMA),
        cfg, convert.switching_carry_from_arrays(leaves, device="cpu"),
        cfg.max_iter + 1)
    assert total == ref.n_iter and bool(res.stop_flags.all())
    _assert_same(ref, res)
