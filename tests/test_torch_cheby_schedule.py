"""The chain kernels' schedule (ops/cuda_cheby.chain_plan; csrc/cheby.cu
runs it), on the CPU.

The kernel runs x = p(A) v as tasks (step k, row tile t) handed out in
step-major ticket order (ticket k n_tiles + t), each waiting only for
step k - 1 on the tiles within its reach, with d ping-ponged between two
shared buffers. Held here: the plan at the main path's shape
(transport_hard(1602112): 1,601,613 rows, offsets up to +-27,378), the
ticket order (every task once, every dependency on a smaller ticket, the
reach covering every column a task reads), and a tiled simulation that
runs the
chain task by task with the plain twin's arithmetic on shared buffers,
in ticket order and in random orders that respect only the dependency
rule: it must equal cheby_chain_plain / cheby_chain_df_plain bit
for bit, and a rule one tile too short must not. The twins themselves
stay equal to the JAX package's cheby_apply (within 2e-6 of the largest
entry in float32, 1e-11 relative in DF, as tests/test_torch_cheby.py).
"""
import dataclasses
import functools
import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.cheby as jcheby
import mpi_bicgstab_tpu.ops.precision as jp
from mpi_bicgstab_tpu.ops.layout import spmv as jspmv
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.models.generators import transport_hard
from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
from mpi_bicgstab_tpu_torch.ops.cheby import (_coeffs, _scale, df_const,
                                              estimate_bounds)
from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df, vfma, vzeros

torch.set_num_threads(1)

HARD_N = 117 ** 3          # transport_hard(1602112)
HARD_OFFSETS = (0, 1, -1, 2, -2, 117, -117, 234, -234, 13689, -13689,
                27378, -27378)


# --- the plan ----------------------------------------------------------------

H100_GRID = 132 * 6     # resident chain blocks on an H100 (132 SMs x 6)


def test_plan_at_the_main_path_shape():
    p = cc.chain_plan(HARD_N, HARD_OFFSETS, H100_GRID)
    assert p.tile == cc.TILES[0] == 1024
    assert p.n_tiles == math.ceil(HARD_N / p.tile) == 1565
    assert p.reach == math.ceil(27378 / p.tile) == 27


@pytest.mark.parametrize("n,grid,tile", [
    (HARD_N, H100_GRID, 1024),     # 1565 tiles: each block gets one
    (HARD_N, 2000, 512),
    (HARD_N, 4000, 256),
    (HARD_N, 10_000, 256),         # none fills the grid: the smallest
    (300763, H100_GRID, 256),      # transport_hard(300763): 1175 tiles
    (300763, 100, 1024),
    (1000, 1, 1024),               # one ragged tile
    (1000, 2, 512),
])
def test_plan_takes_the_largest_tile_that_fills_the_grid(n, grid, tile):
    p = cc.chain_plan(n, HARD_OFFSETS, grid)
    assert p.tile == tile
    assert p.n_tiles == -(-n // tile)
    bigger = [t for t in cc.TILES if t > tile]
    assert p.n_tiles >= grid or tile == cc.TILES[-1]
    assert all(-(-n // t) < grid for t in bigger)


@pytest.mark.parametrize("n,offsets,tile,reach", [
    (100, (0, 1, -1, 99, -99, 150), 256, 1),   # offset > n; one tile
    (100, (0, 1, -1, 99, -99, 150), 16, 7),     # n % tile != 0
    (5000, (0, 1, -1, 40, -40, 129, -129), 256, 1),
    (16384, (0, 1, -1, 9000, -9000), 256, 36),
    (5000, (0, 7000, -7000), 256, 0),           # no in-range off-diagonal
])
def test_plan_reach_and_ragged_tiles(n, offsets, tile, reach):
    p = cc.chain_plan(n, offsets, 1, tiles=(tile,))
    assert p.reach == reach
    assert p.n_tiles == -(-n // tile)
    widest = max((abs(o) for o in offsets if abs(o) < n), default=0)
    assert p.reach * tile >= widest > (p.reach - 1) * tile
    tiles = [_rows(p, n, t) for t in range(p.n_tiles)]
    assert tiles[0].start == 0 and tiles[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(tiles, tiles[1:]))


# --- the ticket order --------------------------------------------------------

@pytest.mark.parametrize("n,offsets,degree,tile", [
    (4096, (0, 1, -1, 256, -256, 512, -512), 8, 64),
    (4096, (0, 1, -1, 256, -256, 512, -512), 1, 64),
    (100, (0, 1, -1, 99, -99, 150), 64, 16),
    (5000, (0, 1, -1, 40, -40, 129, -129), 3, 256),
    (HARD_N, HARD_OFFSETS, 2, 1024),
])
def test_ticket_order_covers_every_task_once_after_its_dependencies(
        n, offsets, degree, tile):
    p = cc.chain_plan(n, offsets, 1, tiles=(tile,))
    order = _ticket_order(p, degree)
    assert len(order) == len(set(order)) == p.n_tiles * degree
    ticket = {task: i for i, task in enumerate(order)}
    for (k, t), i in ticket.items():
        for dep in _deps(p, k, t):
            assert ticket[(k - 1, dep)] < i
        if k > 0:    # the reach covers every row the task's rows read
            rows = _rows(p, n, t)
            need = {j // tile for i_ in (rows.start, rows.stop - 1)
                    for o in offsets if 0 <= (j := i_ + o) < n}
            assert need <= set(_deps(p, k, t))


# --- the tiled simulation ----------------------------------------------------

def _rows(plan, n, t) -> range:
    return range(t * plan.tile, min((t + 1) * plan.tile, n))


def _ticket_order(plan, degree):
    """Tasks in the kernel's ticket order: ticket k n_tiles + t."""
    return [divmod(i, plan.n_tiles) for i in range(plan.n_tiles * degree)]


def _deps(plan, k, t) -> range:
    """The kernel's rule (csrc/cheby.cu, run_tasks): the tiles on which
    step k - 1 must be done before task (k, t) runs (none for step 0)."""
    if k == 0:
        return range(0)
    return range(max(t - plan.reach, 0),
                 min(t + plan.reach, plan.n_tiles - 1) + 1)


def _random_order(plan, degree, seed, deepest):
    """A random order of every task that respects only the rule; deepest
    picks a ready task of the highest step (ties at random), which runs
    later steps as early as the rule lets them."""
    rng = random.Random(seed)
    done = [0] * plan.n_tiles          # steps done on each tile
    order = []
    while len(order) < plan.n_tiles * degree:
        ready = [(k, t) for t, k in enumerate(done) if k < degree
                 and all(done[q] >= k for q in _deps(plan, k, t))]
        if deepest:
            top = max(k for k, _ in ready)
            ready = [task for task in ready if task[0] == top]
        k, t = rng.choice(ready)
        done[t] += 1
        order.append((k, t))
    return order


def _fill_nan(like):
    if is_df(like):
        return DF(torch.full_like(like.hi, math.nan),
                  torch.full_like(like.hi, math.nan))
    return torch.full_like(like, math.nan)


def _put(buf, rows, val):
    if is_df(buf):
        buf.hi[rows.start:rows.stop] = val.hi
        buf.lo[rows.start:rows.stop] = val.lo
    else:
        buf[rows.start:rows.stop] = val


def _cut(vec, rows):
    return vec[rows.start:rows.stop]


def _tile_spmv(vals, offsets, src, rows):
    """Rows `rows` of dia_spmv_plain / dia_spmv_df_plain on src as the
    shared buffer holds it now: the twin's per-row operations."""
    pad_lo = -min(0, min(offsets))
    pad_hi = max(0, max(offsets))
    if is_df(src):
        sp = DF(F.pad(src.hi, (pad_lo, pad_hi)),
                F.pad(src.lo, (pad_lo, pad_hi)))
    else:
        sp = F.pad(src, (pad_lo, pad_hi))
    acc = vzeros(len(rows), src)
    for w, o in enumerate(offsets):
        at = slice(pad_lo + o + rows.start, pad_lo + o + rows.stop)
        acc = vfma(acc, vals[w, rows.start:rows.stop], sp[at])
    return acc


def simulate(vals, v, offsets, degree, lo, hi, plan, order):
    """The chain task by task in `order`, as the kernel runs it: x, r and
    the two d buffers shared (NaN until written), x_0 formed at the band
    columns from v, step k reading d_{k-1} and writing d_k."""
    inv_theta, pairs = _coeffs(degree, lo, hi)
    if is_df(v):
        inv_theta = df_const(inv_theta, "cpu")
        pairs = [(df_const(a, "cpu"), df_const(b, "cpu")) for a, b in pairs]
    x0 = _scale(inv_theta, v)
    x, r = _fill_nan(v), _fill_nan(v)
    d = [_fill_nan(v), _fill_nan(v)]
    n = len(v)
    for k, t in order:
        rows = _rows(plan, n, t)
        if k == 0:
            ri = vfma(_cut(v, rows), -1.0, _tile_spmv(vals, offsets, x0, rows))
            di = _scale(inv_theta, ri)
            if degree == 1:
                _put(x, rows, vfma(_cut(x0, rows), 1.0, di))
            else:
                _put(x, rows, _cut(x0, rows))
                _put(r, rows, ri)
                _put(d[0], rows, di)
            continue
        c_d, c_r = pairs[k - 1]
        dc, dn = d[(k - 1) % 2], d[k % 2]
        di = _cut(dc, rows)
        xi = vfma(_cut(x, rows), 1.0, di)
        rn = vfma(_cut(r, rows), -1.0, _tile_spmv(vals, offsets, dc, rows))
        dni = vfma(_scale(c_d, di), c_r, rn)
        if k == degree - 1:
            _put(x, rows, vfma(xi, 1.0, dni))
        else:
            _put(x, rows, xi)
            _put(r, rows, rn)
            _put(dn, rows, dni)
    return x


@functools.cache
def _hard(n, df):
    """transport_hard(n) as the port's DIA band, v from a seeded NumPy
    generator, and its Chebyshev bounds."""
    csr = transport_hard(n)
    offsets = (0, 1, -1, 2, -2, 16, -16, 32, -32, 256, -256, 512, -512)
    A, rem = csr_to_dia(csr, offsets, dtype="df32" if df else torch.float32,
                        device="cpu")
    assert rem is None
    v = np.random.default_rng(7).standard_normal(csr.nrows)
    vt = tp.df_from_f64(v, "cpu") if df else torch.as_tensor(
        v, dtype=torch.float32)
    return A, vt, estimate_bounds(csr)


def _same(a, b):
    if is_df(a):
        return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
    return torch.equal(a, b)


def _twin(A, v, degree, lo, hi):
    plain = cc.cheby_chain_df_plain if is_df(v) else cc.cheby_chain_plain
    return plain(A.vals, v, A.offsets, degree, lo, hi)


# transport_hard(4096): offsets up to +-512, so T = 64 gives a reach of 8
# tiles each side over 64 tiles
@pytest.mark.parametrize("df,degree,order", [
    (False, 8, "tickets"),
    (False, 8, "random:1"),
    (False, 8, "deepest:2"),
    (False, 8, "deepest:3"),
    (False, 2, "deepest:6"),
    (False, 1, "tickets"),
    (True, 4, "tickets"),
    (True, 4, "deepest:7"),
    (True, 3, "random:4"),
    (True, 3, "deepest:5"),
])
def test_tiled_simulation_equals_the_twin_bit_for_bit(df, degree, order):
    A, v, (lo, hi) = _hard(4096, df)
    p = cc.chain_plan(4096, A.offsets, 1, tiles=(64,))
    assert p.reach == 8 and p.n_tiles == 64
    if order == "tickets":
        tasks = _ticket_order(p, degree)
    else:
        kind, seed = order.split(":")
        tasks = _random_order(p, degree, int(seed), kind == "deepest")
    got = simulate(A.vals, v, A.offsets, degree, lo, hi, p, tasks)
    assert _same(got, _twin(A, v, degree, lo, hi))


@pytest.mark.parametrize("seed", [2, 3])
def test_a_reach_one_tile_short_breaks_the_chain(seed):
    """The simulation sees a dependency rule too weak for the band (and
    for the d ping-pong): the same deepest-first orders under reach - 1
    give other bits."""
    A, v, (lo, hi) = _hard(4096, False)
    p = cc.chain_plan(4096, A.offsets, 1, tiles=(64,))
    short = dataclasses.replace(p, reach=p.reach - 1)
    tasks = _random_order(short, 8, seed, True)
    got = simulate(A.vals, v, A.offsets, 8, lo, hi, p, tasks)
    assert not _same(got, _twin(A, v, 8, lo, hi))


@pytest.mark.parametrize("dtype,n,degree", [("float32", 512, 8),
                                            ("df32", 512, 2)])
def test_twins_still_match_jax_cheby_apply(dtype, n, degree):
    """The twins the kernels and the simulation are held to are unchanged:
    equal to JAX's cheby_apply as tests/test_torch_cheby.py holds them."""
    csr = jgen.transport_hard(n)
    A = jprob.build_problem(csr, dtype=dtype if dtype == "df32" else
                            jnp.float32, multiple=1).A
    lo, hi = jcheby.estimate_bounds(csr)
    v = np.random.default_rng(n).standard_normal(n)
    if dtype == "df32":
        At = convert.operator_from_arrays(
            "dia", {"vals_hi": np.asarray(A.vals.hi),
                    "vals_lo": np.asarray(A.vals.lo)},
            {"offsets": A.offsets, "n": n}, device="cpu")
        vj = jp.df_from_f64(v)
        ref = jp.df_to_f64(jcheby.cheby_apply(lambda u: jspmv(A, u), vj,
                                              degree, lo, hi))
        got = tp.df_to_f64(cc.cheby_chain_df_plain(
            At.vals, convert.df_from_arrays(np.asarray(vj.hi),
                                            np.asarray(vj.lo), device="cpu"),
            At.offsets, degree, lo, hi))
        assert np.abs(got - ref).max() <= 1e-11 * np.abs(ref).max()
        return
    At = convert.operator_from_arrays("dia", {"vals": np.asarray(A.vals)},
                                      {"offsets": A.offsets, "n": n},
                                      device="cpu")
    v = v.astype(np.float32)
    ref = np.asarray(jcheby.cheby_apply(lambda u: jspmv(A, u),
                                        jnp.asarray(v), degree, lo, hi))
    got = cc.cheby_chain_plain(At.vals, torch.from_numpy(v), At.offsets,
                               degree, lo, hi).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()
