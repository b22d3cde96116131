"""Port vs JAX package: the butterfly column table's build in the port's
form (ops/butterfly_spmv.py k1_plain, k2_plain, decode_plain; kernels
csrc/butterfly.cu bfly_route_kernel and bfly_decode_kernel).

K1 and K2 write their outputs transposed, so that no transpose follows
them: their twins must equal JAX's _k1 / _k2 (interpret mode) followed by
JAX's own T1 / T2 reshapes (pallas_butterfly.py:274,276), in 4-byte and
8-byte elements, on a P that no block size divides and an n_cols that is
not a multiple of 1024. A NumPy model of the kernels' block schedule (G
windows a block, staged by bulk copies that stop at the last whole vector
below the window's limit, the transposed tile stored as runs of G at e *
P + a0, element by element in the partial last block) must equal the
twins bit for bit and write every output slot once,
as must a model of the decode's schedule (a block per 128-row tile, 16
slots of one slab a thread) against the decode's twin and the table the
layout carries.
"""
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.ops.butterfly as jbf
import mpi_bicgstab_tpu.ops.pallas_butterfly as jpb
import jax.numpy as jnp
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.ops.butterfly as tbf
import mpi_bicgstab_tpu_torch.ops.butterfly_spmv as tbs
from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf

torch.set_num_threads(1)

WIN = 1024
N_COLS, NC_WIN = 2999, 3       # 3 source windows, the last one partial
# element size -> (numpy dtype, torch dtype) of the routed elements
ELEMS = {4: (np.float32, torch.float32), 8: (np.float64, torch.float64)}


class Tables:
    """K1's and K2's tables for P windows from a NumPy seed: k1_src names
    every source window (the first and last blocks read the partial last
    one), the sublane and lane bytes uniform in their ranges."""

    def __init__(self, P, seed=11):
        g = np.random.default_rng(seed)
        src = g.integers(0, NC_WIN, P).astype(np.int32)
        src[:3] = src[-3:] = NC_WIN - 1

        def rand(hi):
            return torch.as_tensor(g.integers(0, hi, (P, 8, 128)).astype(
                np.int8))
        self.P, self.n_cols, self.nc_pad = P, N_COLS, NC_WIN * WIN
        self.k1_src = torch.as_tensor(src)
        self.k1_sub, self.k1_lane = rand(8), rand(128)
        self.k2_sub, self.k2_lane = rand(8), rand(128)


def _x(size, n, seed=3):
    npd = ELEMS[size][0]
    x = np.random.default_rng(seed).standard_normal(n).astype(npd)
    x[[5, 17]] = np.nan, -np.inf        # bits, not values, are moved
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.itemsize])


@pytest.mark.parametrize("size", [4, 8])
def test_transposed_twins_equal_jax_kernels_and_reshapes(size, monkeypatch):
    """k1_plain and k2_plain against JAX's _k1 / _k2 (interpret mode, one
    window a grid step) followed by T1 / T2 as JAX writes them: equal bit
    for bit, P = 37 windows, 2999 columns (x zero-padded past them)."""
    monkeypatch.setattr(jpb, "_tb_windows", lambda P: 1)
    T = Tables(37)
    x = _x(size, N_COLS)
    xp = np.zeros(T.nc_pad, x.dtype)
    xp[:N_COLS] = x
    j = {k: jnp.asarray(getattr(T, k).numpy())
         for k in ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane")}
    u1 = jpb._k1(j["k1_src"], j["k1_sub"], j["k1_lane"],
                 jnp.asarray(xp.reshape(-1, 128)), interpret=True)
    mid = u1.reshape(T.P, 1024).T.reshape(T.P, 8, 128)     # JAX's T1
    z1 = jpb._k2(mid, j["k2_sub"], j["k2_lane"], interpret=True)
    z = z1.reshape(T.P, 1024).T.reshape(-1)                 # JAX's T2
    mid_t = tbs.k1_plain(T, torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(mid_t.numpy()),
                                  _bits(np.asarray(mid).reshape(-1)))
    z_t = tbs.k2_plain(T, mid_t)
    np.testing.assert_array_equal(_bits(z_t.numpy()), _bits(z))
    assert np.isnan(z_t.numpy()).any()


def model_route(T, G, inp, src):
    """bfly_route_kernel in NumPy, block by block: block b stages windows
    a0 = b G .. a0 + gw - 1 (gw = min(G, P - a0)) in shared memory that
    starts poisoned: the tables' gw rows, and for window g the elements of
    window src[a] of inp (K1; window a for K2, src None) that its bulk
    copy moves (whole 16-byte vectors below the limit), the rest element
    by element (0 past the limit). Item (e, c) gathers slot e of windows
    c V .. c V + V - 1 and stores them at e P + a0 + c V: one aligned
    vector in a whole block, else element by element below gw. Returns
    (out bits, writes per slot)."""
    P, inp = T.P, _bits(inp)
    size = inp.itemsize
    V = 16 // size
    C = G // V
    limit = len(inp)
    poison = np.iinfo(inp.dtype).max
    out = np.full(P * WIN, poison, inp.dtype)
    writes = np.zeros(P * WIN, np.int64)
    tables = {}
    for name, t in (("sub", T.k1_sub if src is not None else T.k2_sub),
                    ("lane", T.k1_lane if src is not None else T.k2_lane)):
        tables[name] = t.numpy().reshape(P, WIN).astype(np.int64)
    for a0 in range(0, P, G):
        gw = min(G, P - a0)
        xs = np.full((G, WIN), poison, inp.dtype)
        subs = np.full((G, WIN), 99, np.int64)   # out of range: a read
        lanes = np.full((G, WIN), 999, np.int64)  # of it would raise
        subs[:gw] = tables["sub"][a0:a0 + gw]
        lanes[:gw] = tables["lane"][a0:a0 + gw]
        for g in range(gw):
            base = (int(src[a0 + g]) if src is not None else a0 + g) * WIN
            left = limit - base
            done = (0 if left <= 0 else min(left, WIN)) & ~(V - 1)
            xs[g, :done] = inp[base:base + done]
            for k in range(done, WIN):
                xs[g, k] = inp[base + k] if base + k < limit else 0
        whole = gw == G and P % V == 0
        it = np.arange(WIN * C)
        e, g0 = it // C, (it % C) * V
        for q in range(V):
            g = g0 + q
            ok = g < gw
            gg, ee = g[ok], e[ok]
            lam = lanes[gg, ee]
            s = subs[gg, (ee & ~127) + lam]
            dst = ee * P + a0 + gg
            out[dst] = xs[gg, s * 128 + lam]
            np.add.at(writes, dst, 1)
        if whole:       # every item's run is one aligned 16-byte vector
            assert ((e * P + a0 + g0) % V == 0).all()
    return out, writes


# P: 37 (no V divides it: element stores), or a multiple of V that G does
# not divide (whole blocks store vectors, the partial last block elements)
STORES = {"elements": {4: 37, 8: 37}, "vectors": {4: 44, 8: 42}}


@pytest.mark.parametrize("n_cols", [2999, 3000])
@pytest.mark.parametrize("stores", sorted(STORES))
@pytest.mark.parametrize("size", [4, 8])
def test_block_schedule_model_equals_twins(size, stores, n_cols):
    """The kernels' block schedule (G = 4 V windows a block, V = 16 /
    element size): K1 on x of n_cols elements (2999: the last source
    window's bulk copy stops short of its last whole vector and the rest is
    filled element by element; 3000: it ends on a vector), then K2 on the
    twin's mid, bit-equal to k1_plain / k2_plain, every output slot written
    once, on P windows of STORES."""
    G, P = 4 * 16 // size, STORES[stores][size]
    assert P % G and (stores == "elements") == bool(P % (16 // size))
    T = Tables(P, seed=P)
    T.n_cols = n_cols
    x = _x(size, n_cols, seed=P + 1)
    mid, writes = model_route(T, G, x, T.k1_src.numpy())
    assert (writes == 1).all()
    mid_t = tbs.k1_plain(T, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(mid, _bits(mid_t))
    z, writes = model_route(T, G, mid_t, None)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        z, _bits(tbs.k2_plain(T, torch.as_tensor(mid_t)).numpy()))


def model_decode(A, z) -> np.ndarray:
    """bfly_decode_kernel in NumPy: block R (a 128-row tile), thread t
    takes slots j = 32 q + 4 (t % 8) + i (q, i < 4) of slabs t // 8,
    t // 8 + 16, ...: lam from its lane bytes, s = k3_sub[w, R 128 + lam]
    (the slab's sublane row), k3_col = z[((R stack + j // rb) 8 + (s &
    7)) 128 + lam] - 1 (z: the routed iota; the tile's stack windows).
    Every slot written once."""
    W, n_pad = A.width, A.n_pad
    NR = n_pad // 128
    sub = A.k3_sub.numpy().reshape(W, n_pad).astype(np.int64)
    lane = A.k3_lane.numpy().reshape(W, n_pad).astype(np.int64)
    z = np.asarray(z)
    col = np.full((W, n_pad), np.iinfo(np.int32).min, np.int64)
    writes = np.zeros((W, n_pad), np.int64)
    R = np.arange(NR)[:, None]
    for t in range(128):
        j = (32 * np.arange(4)[:, None] + 4 * (t % 8)
             + np.arange(4)[None, :]).reshape(1, 16)
        for w in range(t // 8, W, 16):
            r = R * 128 + j                              # [NR, 16]
            lam = lane[w, r]
            s = sub[w, R * 128 + lam]
            zs = z[R * A.stack * 1024 + np.arange(A.stack * 1024)]
            e = ((j // A.rb) * 8 + (s & 7)) * 128 + lam
            col[w, r] = np.take_along_axis(zs, e, axis=1) - 1
            writes[w, r] += 1
    assert (writes == 1).all()
    return col.reshape(tuple(A.k3_lane.shape)).astype(np.int32)


LAYOUTS = {"4096": lambda g: g.random_diag_dominant(4096, seed=3),
           "20480_rb32": lambda g: g.random_diag_dominant(
               20480, nnz_per_row=12, seed=1)}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_decode_twin_and_model_give_the_table(case):
    """decode_plain on the routed iota equals the decode's block model,
    the table the layout carries, and the table JAX's own arrays give
    (the iota routed by JAX's XLA lines, decoded by the model); rb 64
    (two stacked windows) and rb 32 (four), W 16 and 24 (a thread's
    second slab past 16)."""
    A = tbf.build_butterfly(LAYOUTS[case](tgen), device="cpu")
    Aj = jbf.build_butterfly(LAYOUTS[case](jgen))
    iota = torch.arange(1, A.n_cols + 1, dtype=torch.int32)
    z = tbs.route(A, iota)
    got = tbs.decode_plain(A, z)
    np.testing.assert_array_equal(got.numpy(), model_decode(A, z.numpy()))
    np.testing.assert_array_equal(got.numpy(), A.k3_col.numpy())
    zj = _jax_route(Aj, np.arange(1, A.n_cols + 1, dtype=np.int32))
    np.testing.assert_array_equal(model_decode(A, zj), got.numpy())
    assert (got.numpy() == 0).any()


def _jax_route(Aj, x):
    """The JAX package's z for x (zero-padded to nc_pad): the routing
    lines of its XLA form on JAX's tables, with T1 and T2 as reshapes."""
    xp = jnp.zeros(Aj.nc_pad, x.dtype).at[: Aj.n_cols].set(jnp.asarray(x))
    win = xp.reshape(Aj.nc_pad // 1024, 8, 128)[Aj.k1_src]
    t1 = jnp.take_along_axis(win, Aj.k1_sub.astype(jnp.int32), axis=1)
    u1 = jnp.take_along_axis(t1, Aj.k1_lane.astype(jnp.int32), axis=2)
    mid = u1.reshape(Aj.P, 1024).T.reshape(Aj.P, 8, 128)
    t2 = jnp.take_along_axis(mid, Aj.k2_sub.astype(jnp.int32), axis=1)
    z1 = jnp.take_along_axis(t2, Aj.k2_lane.astype(jnp.int32), axis=2)
    return np.asarray(z1.reshape(Aj.P, 1024).T.reshape(-1))


def test_decode_wrapper_takes_card_tensors_only():
    """On CPU tensors the decode's wrapper raises (the CPU takes the twin
    through ops/butterfly_spmv.decode, never the wrapper)."""
    A = tbf.build_butterfly(LAYOUTS["4096"](tgen), device="cpu")
    z = tbs.route(A, torch.arange(1, A.n_cols + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        cbf.butterfly_decode(A, z)
    with pytest.raises(ValueError):
        cbf.butterfly_decode(A, z[:100])
    assert torch.equal(tbs.decode(A, z), tbs.decode_plain(A, z))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_counts_the_build_bytes():
    """chip_smoke's build bound at a small size: the decode reads K3's two
    int8 tables, the distinct z elements its slots name (a slab's padded
    slots in a row tile share one) and writes k3_col; the build's bound is
    K1's, K2's and the decode's bytes at 3.35 TB/s."""
    smoke = _chip_smoke()
    inp = smoke.butterfly_inputs(smoke.uniform_csr(4000), device="cpu")
    B = inp["B32"]
    elem = np.concatenate([tbs.k3_elem(B, c).numpy()
                           for c in range(B.width // 8)])
    assert inp["b_zread"] == np.unique(elem).size < B.width * B.n_pad
    slots = B.width * B.n_pad
    assert smoke.butterfly_work("butterfly_decode", inp)[:2] == (
        6 * slots + 4 * inp["b_zread"], 0)
    total = sum(smoke.butterfly_work(k, inp)[0]
                for k in ("butterfly_k1", "butterfly_k2", "butterfly_decode"))
    assert smoke.build_bound_ms(inp) == total / smoke.HBM_BYTES_PER_S * 1e3
    assert torch.equal(inp["bziota"], tbs.route(B, inp["biota"]))
