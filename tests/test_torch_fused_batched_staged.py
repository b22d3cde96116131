"""The staged data flow of the fused batched passes K1b and K2b
(csrc/fused_batched.cu), in plain PyTorch on the CPU.

On the card each pass runs in two stages. Stage 0 forms p' (K1b) or q
(K2b) once per row and lane and stores it: P2 holds p' on an active lane
and p on a frozen one, whose unmasked p' goes to a scratch plane. Stage 1
multiplies from the stored planes only: lane l's source is P2 when the
lane is active and the scratch plane when it is frozen. Here the scratch
plane starts as NaN, so a read of a row stage 0 did not write would show.

The staged flow must equal the twins (fused_k1b_plain, fused_k2b_plain)
bit for bit, also when a frozen lane's beta and omega are NaN or inf (its
recurrences may be, solvers/batched_fused.py): a frozen lane's P2 and S2
are its p and s, its dot that of the unmasked p'. The twins themselves
are held to the JAX kernels in test_torch_fused_batched.py.
"""
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu_torch.models.generators import banded_random
from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fb
from mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv import \
    batched_dia_spmv_plain
from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia

torch.set_num_threads(1)

# transport_like's offsets at w = 9 (reach 91 rows) on n = 1000, not a
# multiple of the 256-row block
N = 1000
OFFSETS = [1, -1, 2, -2, 9, -9, 10, -10, 81, -81, 90, -90, 91, -91]
# k: frozen lanes
LANES = {1: [0], 3: [1], 8: [0, 5]}
FROZEN = {"finite": None, "nan_inf": (float("nan"), float("inf")),
          "inf_nan": (float("inf"), float("nan"))}


def _setup(k, frozen_kind, seed=5):
    csr = banded_random(N, OFFSETS, seed=seed)
    A, rem = csr_to_dia(csr, sorted({0, *OFFSETS}), dtype=torch.float32,
                        device="cpu")
    assert rem is None
    rng = np.random.default_rng(seed + k)
    R, P, S, Rh = (torch.as_tensor(rng.standard_normal((k, N)),
                                   dtype=torch.float32) for _ in range(4))
    a, b, w = (torch.as_tensor(rng.uniform(0.1, 0.9, k),
                               dtype=torch.float32) for _ in range(3))
    fz = LANES[k]
    act = torch.ones(k)
    act[fz] = 0.0
    a[fz] = 0.0        # the solver loop runs a frozen lane with alpha 0
    if FROZEN[frozen_kind] is not None:
        b[fz], w[fz] = FROZEN[frozen_kind]
    return A, (R, P, S, Rh), (a, b, w, act), fz


def _bits(t):
    return t.contiguous().view(torch.int32)


def staged_k1b(vals, R, P, S, R_hat, scalars, offsets):
    beta, omega, active = scalars
    on = (active != 0)[:, None]
    # stage 0: p' once per row and lane; P2 masked, frozen p' to scratch
    Pp = R + beta[:, None] * (P - omega[:, None] * S)
    P2 = torch.where(on, Pp, P)
    U = torch.full_like(R, float("nan"))
    U[~on[:, 0]] = Pp[~on[:, 0]]
    # stage 1: every lane's neighbours from the stored planes only
    S2 = batched_dia_spmv_plain(vals, offsets, torch.where(on, P2, U))
    return P2, torch.where(on, S2, S), (R_hat * S2).sum(1)


def staged_k2b(vals, R, S2, scalars, offsets):
    (alpha,) = scalars
    Q = R - alpha[:, None] * S2                      # stage 0, stored
    Y = batched_dia_spmv_plain(vals, offsets, Q)     # stage 1, from Q
    return Q, Y, (Q * Y).sum(1), (Y * Y).sum(1)


@pytest.mark.parametrize("frozen_kind", list(FROZEN))
@pytest.mark.parametrize("k", list(LANES))
def test_staged_k1b_equals_twin(k, frozen_kind):
    A, (R, P, S, Rh), (a, b, w, act), fz = _setup(k, frozen_kind)
    args = (A.vals, R, P, S, Rh, (b, w, act), A.offsets)
    got, want = staged_k1b(*args), fb.fused_k1b_plain(*args)
    for g, t in zip(got, want):
        assert torch.equal(_bits(g), _bits(t))
    # the frozen lanes keep p and s bit for bit
    assert torch.equal(_bits(got[0][fz]), _bits(P[fz]))
    assert torch.equal(_bits(got[1][fz]), _bits(S[fz]))
    # their dots are those of the unmasked p' (NaN where beta or omega is
    # not finite), not of the p they keep
    unmasked = R + b[:, None] * (P - w[:, None] * S)
    dot = (Rh * batched_dia_spmv_plain(A.vals, A.offsets, unmasked)).sum(1)
    assert torch.equal(_bits(got[2]), _bits(dot))
    kept = (Rh * batched_dia_spmv_plain(A.vals, A.offsets, P)).sum(1)
    if frozen_kind == "finite":
        assert not torch.equal(got[2][fz], kept[fz])
    else:
        assert bool(got[2][fz].isnan().all())


@pytest.mark.parametrize("k", list(LANES))
def test_staged_k2b_equals_twin(k):
    A, (R, _, S, _), (a, _, _, _), fz = _setup(k, "finite")
    args = (A.vals, R, S, (a,), A.offsets)
    got, want = staged_k2b(*args), fb.fused_k2b_plain(*args)
    for g, t in zip(got, want):
        assert torch.equal(_bits(g), _bits(t))
    # alpha = 0 on a frozen lane: q = r bit for bit
    assert torch.equal(_bits(got[0][fz]), _bits(R[fz]))
