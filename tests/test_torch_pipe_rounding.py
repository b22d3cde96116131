"""Why the port's float64 pipe_bicgstab and the JAX package's part ways on
the restart fixture of tests/test_batched.py::test_batched_lane_restarts:
banded_random(512, [1, -1, 9, -9], seed 0), b = A 1, tol 1e-15.

Both recurrences agree to rounding for ~20 iterations, then sit at the
attainable-accuracy floor (~1e-15) while x drifts away from the truth in
both (true residuals grow from iteration ~26 on). Whether the recursive
residual dips below 1e-15 there, and when, is decided by the rounding
order of the reductions, chiefly the SpMV's band sum: jitted XLA
reassociates the pad-plus-slice sum (its result differs from the eager
and the port's sum by an ulp or two), while the port adds the diagonals'
rounded products in offset order. JAX's own solver reaches 9.5e-16 at
iteration 34. Given the port's SpMV order (through a host callback) and
nothing else of the port, the same JAX solver misses 1e-15 there and ends
decoupled, like the port; given XLA's jitted SpMV and dots and nothing
else of JAX, the port's solver converges at iteration 34, like JAX. So
the difference is not a fault of the port.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.utils.config as jcfg
from mpi_bicgstab_tpu.ops.layout import spmv as jspmv
from mpi_bicgstab_tpu.parallel.comm import Comm as JComm
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import dia_spmv_plain
from mpi_bicgstab_tpu_torch.ops.layout import spmv as tspmv
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

# the module, not the function the package re-exports under that name
jbicgstab = importlib.import_module("mpi_bicgstab_tpu.solvers.bicgstab")
torch.set_num_threads(1)
N, OFFSETS, TOL = 512, [1, -1, 9, -9], 1e-15
JAX_HIT = 34     # JAX's one pass: its recurrence reaches 9.5e-16 at its end


def _jax_problem():
    return jprob.build_problem(jgen.banded_random(N, OFFSETS, seed=0),
                               dtype=jnp.float64)


def _jax_pipe(pj, spmv):
    """JAX's own pipe_bicgstab, one pass (no restarts), jitted."""
    cfg = jcfg.SolverConfig(tol=TOL, max_iter=400, dtype=jnp.float64)
    res = jax.jit(lambda b, x0: jbicgstab.pipe_bicgstab(
        spmv, JComm(None), b, x0, cfg))(pj.b, jnp.zeros_like(pj.b))
    return int(res.n_iter), np.asarray(res.history), float(res.true_relres)


def _port_pipe(spmv, comm):
    pt = tprob.build_problem(tgen.banded_random(N, OFFSETS, seed=0),
                             dtype="float64", device="cpu")
    res = CLASSIC_SOLVERS["pipe_bicgstab"](
        lambda v: spmv(pt.A, v), comm, pt.b, pt.x0,
        SolverConfig(tol=TOL, max_iter=400, restarts=0))
    return res.n_iter, res.history.numpy(), float(res.true_relres)


def test_jax_solver_with_the_ports_spmv_order_misses_tol_like_the_port():
    pj = _jax_problem()
    k, hist, true = _jax_pipe(pj, lambda v: jspmv(pj.A, v))
    assert k == JAX_HIT and hist[k - 1] <= TOL and true < 1e-8
    vals = torch.from_numpy(np.array(pj.A.vals))
    shape = jax.ShapeDtypeStruct((N,), jnp.float64)

    def port_order(v):       # the port's plain SpMV, through a host callback
        return jax.pure_callback(
            lambda u: dia_spmv_plain(vals, pj.A.offsets,
                                     torch.from_numpy(np.array(u))).numpy(),
            shape, v)

    k2, hist2, true2 = _jax_pipe(pj, port_order)
    assert np.nanmin(hist2[:JAX_HIT + 2]) > TOL      # no hit near JAX's
    assert not true2 <= 100 * TOL                    # ends decoupled
    k3, hist3, true3 = _port_pipe(tspmv, Comm())
    assert np.nanmin(hist3[:JAX_HIT + 2]) > TOL      # the port alike
    assert not true3 <= 100 * TOL


def test_port_solver_with_xla_reductions_converges_like_jax():
    pj = _jax_problem()
    jit_spmv = jax.jit(lambda v: jspmv(pj.A, v))
    jit_dot = jax.jit(lambda u, v: jnp.dot(u, v, precision="highest"))

    def as_t(a):
        return torch.from_numpy(np.array(a))

    class XlaDots(Comm):
        def dot(self, u, v):
            return as_t(jit_dot(u.numpy(), v.numpy()))

        def dots(self, *pairs):
            return torch.stack([self.dot(u, v) for u, v in pairs])

    k, hist, true = _port_pipe(lambda A, v: as_t(jit_spmv(v.numpy())),
                               XlaDots())
    assert abs(k - JAX_HIT) <= 2 and hist[k - 1] <= TOL and true < 1e-8
