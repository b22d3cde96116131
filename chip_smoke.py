#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (mpi_bicgstab_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100, sm_90a) and nvcc; imports
nothing of JAX or of the JAX package. Phases, each printing one line of
numbers; any failure exits non-zero:

  1. probe   torch / CUDA versions, card, power limit, nvcc, CUTLASS
  2. build   every kernel from csrc/ (one nvcc per source, in parallel),
             with each kernel's registers, shared memory and spills
  3. check   each kernel against its plain PyTorch version on the same
             inputs at the main path's full width: transport_like(1602112),
             15 diagonals (tolerances in TOL below); the batched kernels
             at k = 8 lanes, two of them frozen (their outputs must be
             their old values bit for bit). The double-float (DF)
             kernels take the band as DF pairs split from float64 and
             random DF vectors from a seeded NumPy generator; their output
             vectors must equal the twin's bit for bit, each dot must lie
             within 1e-12 sum|u_i v_i| of the twin's, and the scalar each
             pass folds into its finishing stage must equal the twin's
             formula (ops/precision.py) applied to the kernel's own dots.
             The windowed-ELL kernels (slab part of y = A x; float32,
             float64, DF) on the layout of clustered_random(1602560)
             (W = 24), built once on the host in float64 and cast, with x
             from a seeded NumPy generator: bit-equal to their twins; the
             whole float64 SpMV (kernel plus COO tail) within 1e-12 of
             torch's CSR product. The butterfly kernels (K1, K2 in 4- and
             8-byte elements, a DF vector as packed pairs; K3 in float32
             and float64; K3 DF) on the layout of uniform:1602112 padded
             to 1,602,560 rows as the CLI pads it (P = 25,600, W = 16),
             routed once on the host in float64 (the C++ router, built by
             g++) and cast, on each stage's input as the twins route a
             seeded x: bit-equal to their twins; the whole float64 SpMV
             (stages, transposes, tail) within 1e-12 of torch's CSR
             product
  4. solves  each path as `python -m mpi_bicgstab_tpu_torch solve --matrix
             transport-like:1602112 --method M --dtype D --tol T`, every
             launch counter set to 0 just before and read just after
             (PATHS below): converged, max|x-1| < 1e-3 (f32) or 1e-6
             (f64, df32), and counters showing the path ran through its
             kernels. f32 classic, CA, pipelined and pipelined-RR (--krr 3
             --nrr 2, so that replacement iterations fire) take the fused
             kernels; f64 classic, f64 pipelined-RR and f64 BiCGStab(2) the
             unfused solvers over the float64 DIA SpMV kernel; df32
             classic, CA, pipelined and pipelined-RR the fused DF kernels
             (true_relres <= 1e-8; n_iter within 2 of f64 classic's for
             classic, and of the same method's unfused DF solver over the
             DF SpMV kernel, run once beside the path, for the others) and
             df32 BiCGStab(2) the unfused solver over the DF SpMV kernel.
             (At tol 1e-5 the stopping rule itself allows max|x-1| of
             about 2e-3 at this n in f32, in the JAX package as in the
             port.)
             The shifted family (ROADMAP slice 4) on the same matrix with
             the flagship ladder (512 shifts, sigma_i = (i + 1) 0.01 / 512,
             seed 255): `solve-shifted --method shifted_lopbicg_switching`
             in df32 at tol 1e-10 (the fused DF shift update once per
             iteration, 2 n_iter + 1 DF SpMVs), float32 at 1e-6 (blocked
             updates, L = 64) and float64 at 1e-10, each with every shift's
             true residual computed on the card with the float64 SpMV
             (<= 100 tol); the four other shifted methods in float64
             through api.solve_shifted on one built problem; the float32
             solve at tol 1e-4 refined to 1e-6 by the batched per-shift
             refinement (refine_shifted_solutions: it must iterate, and
             every shift's true residual fall to <= 10 tol); a checkpointed
             df32 run (16 shifts, --checkpoint-every 5) across a seed
             switch, bit-identical to the uninterrupted one.
             Batched right-hand sides (ROADMAP slice 5): `solve
             --rhs-batch B.npy --dtype float32 --tol 1e-6` with k = 8
             lanes, B[j] = A x_j for seeded x_j (x_0 = ones), through the
             fused batched kernels (K1b = K2b = K3b = the largest n_iter,
             the batched SpMV twice, no single-lane kernel), every lane
             converged with its true residual <= 100 tol and its n_iter
             within 1 of a single-RHS f32 solve of that lane; the same at
             k = 2 in float64 and df32 (tol 1e-10), lane by lane through
             the unfused solvers and the DIA SpMV kernels.
             Chebyshev preconditioning (ROADMAP slice 7) and the fused DF
             pipelined bodies (slice 3c) on transport_hard(1602112) (117^3
             = 1,601,613 rows, 13 diagonals, offsets up to +-27,378),
             degree 8 (CHEBY_PATHS): `[cheby]` `solve --precond cheby:8`
             in float32 through the CLI (the chain kernel twice per
             iteration and once at exit, beside the float32 DIA SpMV; no
             fused classic kernel), then through api.solve on one built
             problem: `[cheby_df32]` (DF chain kernel, DF SpMV),
             `[cheby_pipe_df32]` (the two body kernels once per
             iteration), `[cheby_f64]` (the chain as d float64 SpMVs),
             `[cheby_batched]` (2 lanes, lane by lane, one exit transform
             each); every one converged with its true residual <= 100 tol.
             `[pipe_df32_ell]`: df32 pipe_bicgstab on the ELL layout of
             the main matrix through the body kernels, within 2
             iterations of `[pipe_df32]`. `[cheby_ab]`: the plain and the
             preconditioned float32 solve on the hard matrix (restarts
             0): iterations, wall seconds, true residuals, speedup.
             Unstructured input (ROADMAP slices 6a, 6b): `[window]` is
             `solve --matrix clustered:1602560 --dtype float32 --tol
             1e-6` with the CLI defaults (--format auto, --reorder auto):
             the WindowEllMatrix route, the window kernel twice per
             iteration and per segment for r0 and the true residual, no
             other kernel; `[window_f64]`, `[window_df32]` (the DF kernel)
             and `[window_pipe_df32]` (the DF kernel and the two DF body
             kernels once per iteration) through api.solve at 1e-10; each
             converged, max|x-1| < 1e-3 (f32) or 1e-6, and within 2
             iterations of the same solve on gather-ELL. `[reorder]`:
             banded_random(1602112, [1, -1, 5, -5], seed=3) shuffled by
             default_rng(7).permutation, as an .npz, solved with the CLI
             defaults in float64 at 1e-10 with --write-solution: reordered,
             the DIA/hybrid route, the written (unpermuted) solution
             within 1e-6 of ones. The butterfly (ROADMAP slice 6c):
             `[butterfly]` is `solve --matrix uniform:1602112 --dtype
             float32 --tol 1e-6` with the CLI defaults: the
             ButterflyMatrix route, one K1, K2 and K3 launch per SpMV, x
             held to a residual taken with torch's float64 CSR product
             (<= 10 tol) and to the error bound it gives;
             `[butterfly_f64]`, `[butterfly_df32]` (K3 DF) and
             `[butterfly_pipe_df32]` (and the two DF body kernels once per
             iteration) through api.solve at 1e-10, max|x-1| < 1e-6;
             each within 2 iterations of gather-ELL, launches in
             `check_butterfly_counts`
  5. times   CUDA-event slopes: time per iteration of f32 classic, CA and
             pipelined BiCGStab and of df32 classic, CA and pipelined
             (tol=0 chains of 200 iterations) as the host issues it and as
             a replayed CUDA graph (the device's own time; their ratio is
             the device's busy share), beside their byte floors; each
             kernel against its bound, its plain version and, for the
             f32/f64 SpMV, torch's CSR product; time per shifted
             iteration at 512 shifts (df32, float32 blocked and
             per-iteration, float64) beside the shift update's byte floor;
             time per batched iteration at k = 8 (eager and device) beside
             8 single-lane classic f32 iterations and its byte floor; the
             chain kernels beside the unfused chain (bench_cheby), the f32
             chain at degrees 1, 2, 4 and 8, and the
             preconditioned f32 classic, df32 classic and df32 pipelined
             iterations (eager and device) beside 2 x (chain + DIA SpMV)
             bytes; the window kernels beside their bounds, twins and
             torch's CSR product, the window build's host seconds, and
             the f32 and df32 classic iterations on the window layout
             (eager and device) beside two window SpMVs' bytes; the
             butterfly kernels and the whole butterfly SpMV (f32, f64,
             DF) beside their bounds, the twins and torch's CSR
             product, the two transposes, the route's host seconds,
             and the f32 and df32 classic iterations on the butterfly
             layout beside two SpMVs' bytes
  6. report  the kernels JSON line, the card's name and power limit,
             and the final {"ok": true, "device": ...} line
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

N_MAIN = 1_602_112
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,      # non-tensor-core rates, same sheet
              "float64": 34e12,
              "df32": 67e12}         # DF pairs compute in float32
# float operations of the DF helpers (csrc/df_core.cuh; an FMA counts 2):
# one df_fma, and one compensated dot term plus its combine in the sums
DF_FMA_FLOPS, DF_DOT_FLOPS = 18, 15
TOL = {   # kernel versus plain version on the same inputs
    "float32": {"rtol": 1e-5, "atol": 1e-4},
    "float32_dot": {"rtol": 1e-4},
    # the card contracts the band sums into FMAs and the plain version
    # does not, so rows whose terms cancel differ by rounding of the
    # largest terms: atol is relative to the output's scale
    "float64": {"rtol": 1e-12, "atol_rel": 1e-12},
    # DF: vectors and folded scalars bit-equal; each dot within this
    # times sum |u_i v_i| (the kernel sums its compensated partials in
    # another order than the twin's pairwise df_sum)
    "df32_dot": 1e-12,
    # the float32 chain: max |kernel - twin| within this times max |twin|
    # (the JAX package's own bar for its chain, tests/test_cheby.py:139)
    "float32_chain": 2e-6,
    # the window and butterfly kernels (every dtype): bit-equal, no
    # tolerance; unfused multiplies and adds in the twin's slab order, the
    # routing stages pure movement
    "bit_equal": 0.0,
}
REPLACES = {
    "dia_spmv": "mpi_bicgstab_tpu/ops/pallas_spmv.py:85",
    "fused_k1": "mpi_bicgstab_tpu/ops/pallas_fused_classic.py:129",
    "fused_k2": "mpi_bicgstab_tpu/ops/pallas_fused_classic.py:152",
    "fused_k3": "mpi_bicgstab_tpu/ops/pallas_fused_classic.py:174",
    "fused_ca_k1": "mpi_bicgstab_tpu/ops/pallas_fused_ca.py:78",
    "fused_ca_k2": "mpi_bicgstab_tpu/ops/pallas_fused_ca.py:110",
    "fused_phase_a": "mpi_bicgstab_tpu/ops/pallas_fused_pipe.py:113",
    "fused_phase_b": "mpi_bicgstab_tpu/ops/pallas_fused_pipe.py:162",
    # the DF SpMV is XLA code in the JAX package, not a Pallas kernel
    "dia_spmv_df": "mpi_bicgstab_tpu/ops/dia.py:143",
    "fused_k1_df": "mpi_bicgstab_tpu/ops/pallas_fused_classic_df.py:107",
    "fused_k2_df": "mpi_bicgstab_tpu/ops/pallas_fused_classic_df.py:139",
    "fused_k3_df": "mpi_bicgstab_tpu/ops/pallas_fused_classic_df.py:165",
    "fused_ca_k1_df": "mpi_bicgstab_tpu/ops/pallas_fused_ca_df.py:90",
    "fused_ca_k2_df": "mpi_bicgstab_tpu/ops/pallas_fused_ca_df.py:137",
    "fused_phase_a_df": "mpi_bicgstab_tpu/ops/pallas_fused_pipe_df2.py:170",
    "fused_phase_b_df": "mpi_bicgstab_tpu/ops/pallas_fused_pipe_df2.py:205",
    "shift_update_df": "mpi_bicgstab_tpu/ops/pallas_shift_update.py:85",
    "batched_dia_spmv": "mpi_bicgstab_tpu/ops/pallas_batched_spmv.py:91",
    "fused_k1b": "mpi_bicgstab_tpu/ops/pallas_fused_batched.py:170",
    "fused_k2b": "mpi_bicgstab_tpu/ops/pallas_fused_batched.py:260",
    "fused_k3b": "mpi_bicgstab_tpu/ops/pallas_fused_batched.py:297",
    "fused_body_a": "mpi_bicgstab_tpu/ops/pallas_fused_pipe_df.py:124",
    "fused_body_b": "mpi_bicgstab_tpu/ops/pallas_fused_pipe_df.py:153",
    "cheby_chain": "mpi_bicgstab_tpu/ops/pallas_cheby.py:141",
    "cheby_chain_df": "mpi_bicgstab_tpu/ops/pallas_cheby_df.py:105",
    "window_spmv": "mpi_bicgstab_tpu/ops/pallas_window_spmv.py:43",
    "window_spmv_df": "mpi_bicgstab_tpu/ops/pallas_window_spmv.py:122",
    "butterfly_k1": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:87",
    "butterfly_k2": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:133",
    "butterfly_k3": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:163",
    "butterfly_k3_df": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:327",
}
_CSRC = "mpi_bicgstab_tpu_torch/csrc/"
SOURCES = {
    "dia_spmv": _CSRC + "dia_spmv.cu",
    "fused_k1": _CSRC + "fused_classic.cu",
    "fused_k2": _CSRC + "fused_classic.cu",
    "fused_k3": _CSRC + "fused_classic.cu",
    "fused_ca_k1": _CSRC + "fused_ca.cu",
    "fused_ca_k2": _CSRC + "fused_ca.cu",
    "fused_phase_a": _CSRC + "fused_pipe.cu",
    "fused_phase_b": _CSRC + "fused_pipe.cu",
    "dia_spmv_df": _CSRC + "dia_spmv.cu",
    "fused_k1_df": _CSRC + "fused_classic_df.cu",
    "fused_k2_df": _CSRC + "fused_classic_df.cu",
    "fused_k3_df": _CSRC + "fused_classic_df.cu",
    "fused_ca_k1_df": _CSRC + "fused_ca_df.cu",
    "fused_ca_k2_df": _CSRC + "fused_ca_df.cu",
    "fused_phase_a_df": _CSRC + "fused_pipe_df.cu",
    "fused_phase_b_df": _CSRC + "fused_pipe_df.cu",
    "shift_update_df": _CSRC + "shift_update_df.cu",
    "batched_dia_spmv": _CSRC + "batched_spmv.cu",
    "fused_k1b": _CSRC + "fused_batched.cu",
    "fused_k2b": _CSRC + "fused_batched.cu",
    "fused_k3b": _CSRC + "fused_batched.cu",
    "fused_body_a": _CSRC + "pipe_df_bodies.cu",
    "fused_body_b": _CSRC + "pipe_df_bodies.cu",
    "cheby_chain": _CSRC + "cheby.cu",
    "cheby_chain_df": _CSRC + "cheby.cu",
    "window_spmv": _CSRC + "window_spmv.cu",
    "window_spmv_df": _CSRC + "window_spmv.cu",
    "butterfly_k1": _CSRC + "butterfly.cu",
    "butterfly_k2": _CSRC + "butterfly.cu",
    "butterfly_k3": _CSRC + "butterfly.cu",
    "butterfly_k3_df": _CSRC + "butterfly.cu",
}
KRR, NRR = 3, 2      # small enough that replacements fire in a short solve
# SpMV launches per solver segment: r0 (and w0 = A r0 for CA, w0, t0 for
# the pipelined methods) and the true residual at exit. The fused DF
# pipelined drivers take no t0: their phase A multiplies w itself.
SEGMENT_SPMVS = {"bicgstab": 2, "ca_bicgstab": 3, "pipe_bicgstab": 4,
                 "pipe_bicgstab_rr": 4, "bicgstab_l2": 2, "bicgstab_l4": 2}
SEGMENT_SPMVS_DF = {**SEGMENT_SPMVS, "pipe_bicgstab": 3,
                    "pipe_bicgstab_rr": 3}
# phase: (method, dtype, tol, extra CLI arguments); each path's kernels
# and launch rule are in expected_counts
PATHS = {
    "f32": ("bicgstab", "float32", 1e-6, ()),
    "f64": ("bicgstab", "float64", 1e-10, ()),
    "ca": ("ca_bicgstab", "float32", 1e-6, ()),
    "pipe": ("pipe_bicgstab", "float32", 1e-6, ()),
    "pipe_rr": ("pipe_bicgstab_rr", "float32", 1e-6,
                ("--krr", str(KRR), "--nrr", str(NRR))),
    "pipe_rr_f64": ("pipe_bicgstab_rr", "float64", 1e-10,
                    ("--krr", str(KRR), "--nrr", str(NRR))),
    "l2": ("bicgstab_l2", "float64", 1e-10, ()),
    "df32": ("bicgstab", "df32", 1e-10, ()),
    "l2_df32": ("bicgstab_l2", "df32", 1e-10, ()),
    "ca_df32": ("ca_bicgstab", "df32", 1e-10, ()),
    "pipe_df32": ("pipe_bicgstab", "df32", 1e-10, ()),
    "pipe_rr_df32": ("pipe_bicgstab_rr", "df32", 1e-10,
                     ("--krr", str(KRR), "--nrr", str(NRR))),
}
# the path whose run gives each kernel's launches in the kernels line
LAUNCHES_FROM = {"dia_spmv_f32": ("f32", "dia_spmv"),
                 "dia_spmv_f64": ("f64", "dia_spmv"),
                 "fused_k1": ("f32", "fused_k1"),
                 "fused_k2": ("f32", "fused_k2"),
                 "fused_k3": ("f32", "fused_k3"),
                 "fused_ca_k1": ("ca", "fused_ca_k1"),
                 "fused_ca_k2": ("ca", "fused_ca_k2"),
                 "fused_phase_a": ("pipe", "fused_phase_a"),
                 "fused_phase_b": ("pipe", "fused_phase_b"),
                 "dia_spmv_df": ("df32", "dia_spmv_df"),
                 "fused_k1_df": ("df32", "fused_k1_df"),
                 "fused_k2_df": ("df32", "fused_k2_df"),
                 "fused_k3_df": ("df32", "fused_k3_df"),
                 "fused_ca_k1_df": ("ca_df32", "fused_ca_k1_df"),
                 "fused_ca_k2_df": ("ca_df32", "fused_ca_k2_df"),
                 "fused_phase_a_df": ("pipe_df32", "fused_phase_a_df"),
                 "fused_phase_b_df": ("pipe_df32", "fused_phase_b_df"),
                 "shift_update_df": ("shifted_df32", "shift_update_df"),
                 "batched_dia_spmv": ("batched", "batched_dia_spmv"),
                 "fused_k1b": ("batched", "fused_k1b"),
                 "fused_k2b": ("batched", "fused_k2b"),
                 "fused_k3b": ("batched", "fused_k3b"),
                 "cheby_chain": ("cheby", "cheby_chain"),
                 "cheby_chain_df": ("cheby_df32", "cheby_chain_df"),
                 "fused_body_a": ("cheby_pipe_df32", "fused_body_a"),
                 "fused_body_b": ("cheby_pipe_df32", "fused_body_b"),
                 "window_spmv_f32": ("window", "window_slabs"),
                 "window_spmv_f64": ("window_f64", "window_slabs"),
                 "window_spmv_df": ("window_df32", "window_slabs_df"),
                 "butterfly_k1_f32": ("butterfly", "butterfly_k1"),
                 "butterfly_k2_f32": ("butterfly", "butterfly_k2"),
                 "butterfly_k3_f32": ("butterfly", "butterfly_k3"),
                 "butterfly_k1_f64": ("butterfly_f64", "butterfly_k1"),
                 "butterfly_k2_f64": ("butterfly_f64", "butterfly_k2"),
                 "butterfly_k3_f64": ("butterfly_f64", "butterfly_k3"),
                 "butterfly_k1_df": ("butterfly_df32", "butterfly_k1"),
                 "butterfly_k2_df": ("butterfly_df32", "butterfly_k2"),
                 "butterfly_k3_df": ("butterfly_df32", "butterfly_k3_df")}
# the flagship ladder (main_shifted.c:13-14,95-100) and the shifted paths:
# phase -> (dtype, tol)
S_MAIN, SEED_MAIN, SIGMA_MAX = 512, 255, 0.01
SHIFTED_PATHS = {"shifted_df32": ("df32", 1e-10),
                 "shifted_f32": ("float32", 1e-6),
                 "shifted_f64": ("float64", 1e-10)}
REFINE_TOLS = (1e-4, 1e-6)   # the loose shifted solve, the refinement
SHIFT_ROWS_PER_TWIN = 32   # the DF twin's rows per slice at full width
DF_MUL_FLOPS, DF_ADD_FLOPS = 10, 20
# batched right-hand sides: lanes, the kernel check's frozen lanes, and the
# per-lane route's lanes and tolerance
K_MAIN, FROZEN_LANES = 8, (2, 5)
BATCHED = ("batched_dia_spmv", "fused_k1b", "fused_k2b", "fused_k3b")
K_LANES, LANES_TOL = 2, 1e-10
# Chebyshev preconditioning on transport-hard:N_HARD at CHEBY_DEGREE; the
# API phases: phase -> (method, dtype, tol)
N_HARD, CHEBY_DEGREE, CHEBY_MAX_ITER = 1_602_112, 8, 5000
CHEBY_PATHS = {"cheby_df32": ("bicgstab", "df32", 1e-10),
               "cheby_pipe_df32": ("pipe_bicgstab", "df32", 1e-10),
               "cheby_f64": ("bicgstab", "float64", 1e-10)}
AB_TOL, AB_MAX_ITER = 1e-5, 20000
# windowed-ELL (slice 6b) on clustered_random(N_WINDOW): `[window]` is the
# CLI in float32 at WINDOW_TOL, these through api.solve: phase -> (method,
# dtype, tol); each against the same solve on gather-ELL
N_WINDOW, WINDOW_TOL = 1_602_560, 1e-6
WINDOW_PATHS = {"window_f64": ("bicgstab", "float64", 1e-10),
                "window_df32": ("bicgstab", "df32", 1e-10),
                "window_pipe_df32": ("pipe_bicgstab", "df32", 1e-10)}
# the reorder path (slice 6a): banded_random(N_MAIN, REORDER_OFFSETS,
# seed=3) in the order of default_rng(7).permutation
REORDER_OFFSETS, REORDER_SEEDS = [1, -1, 5, -5], (3, 7)
# the butterfly layout (slice 6c) on uniform:N_UNIFORM (the JAX CLI's
# random_diag_dominant(N, 8 nonzeros a row, seed 0), padded to a multiple
# of 1024 as the CLI pads it): `[butterfly]` is the CLI in float32 at
# UNIFORM_TOL, these through api.solve: phase -> (method, dtype, tol);
# each against the same solve on gather-ELL
N_UNIFORM, UNIFORM_TOL = 1_602_112, 1e-6
BUTTERFLY_PATHS = {"butterfly_f64": ("bicgstab", "float64", 1e-10),
                   "butterfly_df32": ("bicgstab", "df32", 1e-10),
                   "butterfly_pipe_df32": ("pipe_bicgstab", "df32", 1e-10)}


class SmokeFailure(RuntimeError):
    pass


def _say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _counters():
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca_df as fcadf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe_df as fpipedf
    from mpi_bicgstab_tpu_torch.ops import cuda_shift_update as csu
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fbat
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    return {"dia_spmv": cuda_spmv.dia_spmv, "fused_k1": fcl.fused_k1,
            "fused_k2": fcl.fused_k2, "fused_k3": fcl.fused_k3,
            "fused_ca_k1": fca.fused_ca_k1, "fused_ca_k2": fca.fused_ca_k2,
            "fused_phase_a": fpipe.fused_phase_a,
            "fused_phase_b": fpipe.fused_phase_b,
            "dia_spmv_df": cuda_spmv.dia_spmv_df,
            "fused_k1_df": fcldf.fused_k1_df,
            "fused_k2_df": fcldf.fused_k2_df,
            "fused_k3_df": fcldf.fused_k3_df,
            "fused_ca_k1_df": fcadf.fused_ca_k1_df,
            "fused_ca_k2_df": fcadf.fused_ca_k2_df,
            "fused_phase_a_df": fpipedf.fused_phase_a_df,
            "fused_phase_b_df": fpipedf.fused_phase_b_df,
            "shift_update_df": csu.fused_shift_update_df,
            "batched_dia_spmv": cbs.batched_dia_spmv,
            "fused_k1b": fbat.fused_k1b, "fused_k2b": fbat.fused_k2b,
            "fused_k3b": fbat.fused_k3b,
            "fused_body_a": cpb.fused_body_a,
            "fused_body_b": cpb.fused_body_b,
            "cheby_chain": cc.cheby_chain,
            "cheby_chain_df": cc.cheby_chain_df,
            "window_slabs": cws.window_slabs,
            "window_slabs_df": cws.window_slabs_df,
            "butterfly_k1": cbf.butterfly_k1,
            "butterfly_k2": cbf.butterfly_k2,
            "butterfly_k3": cbf.butterfly_k3,
            "butterfly_k3_df": cbf.butterfly_k3_df}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


# --- phases -----------------------------------------------------------------

def probe() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from mpi_bicgstab_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    _say("probe", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda,
         device=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), nvidia_smi=repr(smi),
         nvcc=repr(nvcc),
         cutlass=Path("/usr/local/cutlass/include").exists())
    return smi


def build() -> None:
    from mpi_bicgstab_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    _say("build", seconds=round(time.perf_counter() - t0, 3),
         dir=_build.build_dir())
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _close(name, got, want, rtol, atol) -> None:
    import torch
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise SmokeFailure(f"{name}: kernel and plain version differ, max "
                           f"abs err {_err(got, want):.3e} (rtol {rtol}, "
                           f"atol {atol})")


def kernel_inputs(csr, device="cuda", seed=0) -> dict:
    """The kernels' inputs at the main path's shapes: the DIA band in
    float32, float64 and DF pairs (split from float64) from the host CSR,
    random vectors from a seed (the DF ones, "df_" keys, from a seeded
    NumPy generator)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.dia import analyze_diagonals, csr_to_dia
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    offsets, _ = analyze_diagonals(csr)
    A32, _ = csr_to_dia(csr, offsets, dtype=torch.float32, device=device)
    A64, _ = csr_to_dia(csr, offsets, dtype=torch.float64, device=device)
    Adf, _ = csr_to_dia(csr, offsets, dtype="df32", device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    vec = lambda dt=torch.float32: torch.randn(  # noqa: E731
        csr.nrows, generator=g, dtype=dt, device=device)
    sc = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                device=device)
    rng = np.random.default_rng(seed)
    inp = {"A32": A32, "A64": A64, "Adf": Adf, "x64": vec(torch.float64),
           "r": vec(), "p": vec(), "s": vec(), "r_hat": vec(), "x": vec(),
           "q": vec(), "y": vec(), "alpha": sc(0.7), "beta": sc(0.3),
           "omega": sc(0.2), "w": vec(), "z": vec()}
    for k in ("r", "p", "s", "r_hat", "x", "q", "y", "w", "z", "v", "t"):
        inp["df_" + k] = df_from_f64(rng.standard_normal(csr.nrows), device)
    for k, v in (("alpha", 0.7), ("beta", 0.3), ("omega", 0.2),
                 ("rTr", 2.5)):
        inp["df_" + k] = df_from_f64(np.float64(v) * (1 + 1e-9), device)
    # batched: [K_MAIN, n] planes, per-lane scalars, FROZEN_LANES inactive
    for k in ("r", "p", "s", "r_hat", "x", "q", "y"):
        inp["b_" + k] = torch.randn((K_MAIN, csr.nrows), generator=g,
                                    device=device)
    for k in ("alpha", "beta", "omega"):
        inp["b_" + k] = 0.1 + 0.8 * torch.rand(K_MAIN, generator=g,
                                               device=device)
    inp["b_active"] = torch.ones(K_MAIN, device=device)
    inp["b_active"][list(FROZEN_LANES)] = 0.0
    # the solver loop runs a frozen lane's K2b with alpha = 0
    inp["b_alpha"][list(FROZEN_LANES)] = 0.0
    return inp


def kernel_calls(inp: dict) -> dict:
    """name -> (kernel call, plain call, dtype) on the same inputs."""
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
    A32, A64 = inp["A32"], inp["A64"]
    v, o = A32.vals, A32.offsets
    r, p, s, rh = inp["r"], inp["p"], inp["s"], inp["r_hat"]
    x, q, y, wv, z = inp["x"], inp["q"], inp["y"], inp["w"], inp["z"]
    a, b, w = inp["alpha"], inp["beta"], inp["omega"]
    ca1 = (v, r, p, s, wv, z, (a, b, w), o)
    ca2 = (v, q, y, x, p, rh, s, z, (a, w), o)
    pa = (v, z, r, p, s, wv, x, (a, b, w), o)      # z' = z, old z = x
    pb = (v, wv, x, p, q, y, rh, s, z, (a, w), o)
    return {
        "dia_spmv_f32": (lambda: (cuda_spmv.dia_spmv(v, o, x),),
                         lambda: (cuda_spmv.dia_spmv_plain(v, o, x),),
                         "float32"),
        "dia_spmv_f64": (
            lambda: (cuda_spmv.dia_spmv(A64.vals, o, inp["x64"]),),
            lambda: (cuda_spmv.dia_spmv_plain(A64.vals, o, inp["x64"]),),
            "float64"),
        "fused_k1": (lambda: fcl.fused_k1(v, r, p, s, rh, (b, w), o),
                     lambda: fcl.fused_k1_plain(v, r, p, s, rh, (b, w), o),
                     "float32"),
        "fused_k2": (lambda: fcl.fused_k2(v, r, s, (a,), o),
                     lambda: fcl.fused_k2_plain(v, r, s, (a,), o),
                     "float32"),
        "fused_k3": (lambda: fcl.fused_k3(x, p, q, y, rh, (a, w)),
                     lambda: fcl.fused_k3_plain(x, p, q, y, rh, (a, w)),
                     "float32"),
        "fused_ca_k1": (lambda: fca.fused_ca_k1(*ca1),
                        lambda: fca.fused_ca_k1_plain(*ca1), "float32"),
        "fused_ca_k2": (lambda: fca.fused_ca_k2(*ca2),
                        lambda: fca.fused_ca_k2_plain(*ca2), "float32"),
        "fused_phase_a": (lambda: fpipe.fused_phase_a(*pa),
                          lambda: fpipe.fused_phase_a_plain(*pa), "float32"),
        "fused_phase_b": (lambda: fpipe.fused_phase_b(*pb),
                          lambda: fpipe.fused_phase_b_plain(*pb), "float32"),
        **df_kernel_calls(inp),
        **batched_kernel_calls(inp),
        **cheby_kernel_calls(inp),
    }


def cheby_inputs(prob64, device="cuda") -> dict:
    """The chain kernels' inputs at the preconditioned path's shapes: the
    band of prob64 (a float64 DIA problem) as float32 and as DF pairs
    split from float64, a standard-normal v from a NumPy generator seeded
    0, and the matrix's Chebyshev bounds (ops/cheby.py)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.cheby import estimate_bounds
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    p32, pdf = problems_from_f64(prob64)
    v = np.random.default_rng(0).standard_normal(prob64.n)
    lo, hi = estimate_bounds(prob64.csr)
    return {"H32": p32.A, "Hdf": pdf.A,
            "h_v": torch.as_tensor(v, dtype=torch.float32, device=device),
            "h_vdf": df_from_f64(v, device), "h_lo": lo, "h_hi": hi,
            "h_prob32": p32, "h_probdf": pdf}


def problems_from_f64(prob64):
    """The float32 and the df32 problem of a float64 DIA problem, made on
    its device: the band and b rounded to float32, or split into DF pairs
    (hi = f32(a), lo = f32(a - hi)), as models.problem.build_problem makes
    them from the host's float64 values, without assembling the band on
    the host again."""
    import dataclasses

    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    from mpi_bicgstab_tpu_torch.ops.precision import DF, vzeros_like
    A = prob64.A

    def split(a):
        hi = a.float()
        return DF(hi, (a - hi.double()).float())

    out = []
    for conv in (lambda a: a.float(), split):
        b = conv(prob64.b)
        out.append(dataclasses.replace(
            prob64, A=DiaMatrix(conv(A.vals), A.offsets, A.n_rows, A.n_cols),
            b=b, x0=vzeros_like(b)))
    return out


def cheby_kernel_calls(inp: dict) -> dict:
    """The chain kernels' entries of kernel_calls, at CHEBY_DEGREE on the
    hard matrix (absent when inp has no "H32")."""
    if "H32" not in inp:
        return {}
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    A, Adf = inp["H32"], inp["Hdf"]
    c = (CHEBY_DEGREE, inp["h_lo"], inp["h_hi"])
    f32 = (A.vals, inp["h_v"], A.offsets, *c)
    df = (Adf.vals, inp["h_vdf"], Adf.offsets, *c)
    return {
        "cheby_chain": (lambda: (cc.cheby_chain(*f32),),
                        lambda: (cc.cheby_chain_plain(*f32),),
                        "float32_chain"),
        "cheby_chain_df": (lambda: (cc.cheby_chain_df(*df),),
                           lambda: (cc.cheby_chain_df_plain(*df),), "df32"),
    }


def batched_kernel_calls(inp: dict) -> dict:
    """The batched kernels' entries of kernel_calls (k = K_MAIN lanes;
    each returns its planes, then its [k] dots)."""
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fbat
    v, o = inp["A32"].vals, inp["A32"].offsets
    r, p, s, rh, x, q, y = (inp["b_" + k] for k in
                            ("r", "p", "s", "r_hat", "x", "q", "y"))
    a, b, w, act = (inp["b_" + k] for k in
                    ("alpha", "beta", "omega", "active"))
    k1 = (v, r, p, s, rh, (b, w, act), o)
    k2 = (v, r, s, (a,), o)
    k3 = (x, p, q, y, rh, (a, w, act))
    return {
        "batched_dia_spmv": (lambda: (cbs.batched_dia_spmv(v, o, x),),
                             lambda: (cbs.batched_dia_spmv_plain(v, o, x),),
                             "float32"),
        "fused_k1b": (lambda: fbat.fused_k1b(*k1),
                      lambda: fbat.fused_k1b_plain(*k1), "float32"),
        "fused_k2b": (lambda: fbat.fused_k2b(*k2),
                      lambda: fbat.fused_k2b_plain(*k2), "float32"),
        "fused_k3b": (lambda: fbat.fused_k3b(*k3),
                      lambda: fbat.fused_k3b_plain(*k3), "float32"),
    }


def check_frozen_lanes(calls: dict, inp: dict) -> None:
    """The batched passes write a frozen lane's old values back bit for
    bit: p and s in K1b, q = r in K2b (alpha = 0), x and q in K3b."""
    import torch
    fz = list(FROZEN_LANES)
    keep = {"fused_k1b": ("p", "s"), "fused_k2b": ("r",),
            "fused_k3b": ("x", "q")}
    for name, olds in keep.items():
        got = calls[name][0]()
        torch.cuda.synchronize()
        for i, old in enumerate(olds):
            if not torch.equal(got[i][fz], inp["b_" + old][fz]):
                raise SmokeFailure(f"{name} output {i}: a frozen lane "
                                   f"changed")
    _say("batched_kernels", k=K_MAIN, frozen_lanes=list(FROZEN_LANES),
         frozen="bit-unchanged")


def df_kernel_calls(inp: dict) -> dict:
    """The DF kernels' entries of kernel_calls: each call returns a tuple
    of DF pairs, vectors first, then dots, then the folded scalar."""
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca_df as fcadf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe_df as fpipedf
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
    A = inp["Adf"]
    v, o = A.vals, A.offsets
    r, p, s, rh, x, q, y, wv, z, vv, t = (
        inp["df_" + k] for k in
        ("r", "p", "s", "r_hat", "x", "q", "y", "w", "z", "v", "t"))
    a, b, w, rtr = (inp["df_" + k] for k in
                    ("alpha", "beta", "omega", "rTr"))
    ca1 = (v, r, p, s, wv, z, (a, b, w), o)
    ca2 = (v, q, y, x, p, rh, s, z, (a, w, rtr), o)
    pa = (v, wv, r, p, s, z, vv, (a, b, w), o)
    pb = (v, z, x, p, q, y, t, rh, s, (a, w, rtr), o)
    ba = (r, p, s, wv, z, t, vv, (a, b, w))
    bb = (x, p, q, y, t, vv, rh, s, z, (a, w))

    def flat(out):      # the body's vectors, then its dots one by one
        return (*out[:-1], *out[-1])

    return {
        "fused_body_a": (lambda: flat(cpb.fused_body_a(*ba)),
                         lambda: flat(cpb.fused_body_a_plain(*ba)), "df32"),
        "fused_body_b": (lambda: flat(cpb.fused_body_b(*bb)),
                         lambda: flat(cpb.fused_body_b_plain(*bb)), "df32"),
        "dia_spmv_df": (lambda: (cuda_spmv.dia_spmv_df(v, o, x),),
                        lambda: (cuda_spmv.dia_spmv_df_plain(v, o, x),),
                        "df32"),
        "fused_k1_df": (
            lambda: fcldf.fused_k1_df(v, r, p, s, rh, (b, w, rtr), o),
            lambda: fcldf.fused_k1_df_plain(v, r, p, s, rh, (b, w, rtr), o),
            "df32"),
        "fused_k2_df": (lambda: fcldf.fused_k2_df(v, r, s, (a,), o),
                        lambda: fcldf.fused_k2_df_plain(v, r, s, (a,), o),
                        "df32"),
        "fused_k3_df": (
            lambda: fcldf.fused_k3_df(x, p, q, y, rh, (a, w, rtr)),
            lambda: fcldf.fused_k3_df_plain(x, p, q, y, rh, (a, w, rtr)),
            "df32"),
        "fused_ca_k1_df": (lambda: fcadf.fused_ca_k1_df(*ca1),
                           lambda: fcadf.fused_ca_k1_df_plain(*ca1), "df32"),
        "fused_ca_k2_df": (lambda: fcadf.fused_ca_k2_df(*ca2),
                           lambda: fcadf.fused_ca_k2_df_plain(*ca2), "df32"),
        "fused_phase_a_df": (
            lambda: fpipedf.fused_phase_a_df(*pa),
            lambda: fpipedf.fused_phase_a_df_plain(*pa), "df32"),
        "fused_phase_b_df": (
            lambda: fpipedf.fused_phase_b_df(*pb),
            lambda: fpipedf.fused_phase_b_df_plain(*pb), "df32"),
    }


def df_outputs(name: str, out: tuple, inp: dict):
    """What a DF kernel's outputs are: (number of vectors, the (u, v)
    pair of each dot, the folded scalars recomputed from the outputs'
    own dots with the twin's formulas, ops/precision.py)."""
    from mpi_bicgstab_tpu_torch.ops.precision import df_div, df_mul
    from mpi_bicgstab_tpu_torch.solvers.base import fold_beta_alpha
    a, w, rtr, rh, s, z = (inp["df_" + k] for k in
                           ("alpha", "omega", "rTr", "r_hat", "s", "z"))
    if name in ("fused_ca_k1_df", "fused_phase_a_df"):
        # [t,] p2, s2, z2, q, y, (q, y), (y, y), omega2
        nv = 5 if name == "fused_ca_k1_df" else 6
        q, y = out[nv - 2], out[nv - 1]
        return nv, [(q, y), (y, y)], [df_div(out[nv], out[nv + 1])]
    if name in ("fused_ca_k2_df", "fused_phase_b_df"):
        # [v2,] x2, r2, w2, the five dots of r2, w2 and the inputs s2 = s,
        # z2 = z, beta2, alpha2
        nv = 3 if name == "fused_ca_k2_df" else 4
        r2, w2 = out[nv - 2], out[nv - 1]
        return nv, [(r2, r2), (rh, r2), (rh, w2), (rh, s), (rh, z)], list(
            fold_beta_alpha(a, w, rtr, *out[nv + 1:nv + 5]))
    if name in ("dia_spmv_df", "cheby_chain_df"):
        return 1, [], []
    if name == "fused_body_a":      # p2, s2, z2, q, y, (q, y), (y, y)
        q, y = out[3], out[4]
        return 5, [(q, y), (y, y)], []
    if name == "fused_body_b":      # x2, r2, w2, the five dots; s2 = s
        r2, w2 = out[1], out[2]
        return 3, [(r2, r2), (rh, r2), (rh, w2), (rh, s), (rh, z)], []
    if name == "fused_k1_df":       # p2, s2, (r^, s2), alpha
        return 2, [(rh, out[1])], [df_div(rtr, out[2])]
    if name == "fused_k2_df":       # q, y, (q, y), (y, y), omega
        return 2, [(out[0], out[1]), (out[1], out[1])], [
            df_div(out[2], out[3])]
    # fused_k3_df: x2, r2, (r2, r2), (r^, r2), beta
    return 2, [(out[1], out[1]), (rh, out[1])], [
        df_mul(df_div(a, w), df_div(out[3], rtr))]


def _f64(t):
    """A tensor or a DF pair as float64 (exact for a pair)."""
    return t.hi.double() + t.lo.double() if hasattr(t, "hi") else t.double()


def _same(t, u) -> bool:
    import torch
    return torch.equal(t.hi, u.hi) and torch.equal(t.lo, u.lo)


def check_df_kernel(name, got, want, inp) -> list:
    """A DF kernel's outputs against its twin's (module doc, phase 3);
    returns the abs error of each output in float64 (0 for the equal
    vectors; a folded scalar's error follows its dots')."""
    n_vec, pairs, refolded = df_outputs(name, got, inp)
    for i in range(n_vec):
        if not _same(got[i], want[i]):
            raise SmokeFailure(
                f"{name} output {i}: kernel and twin vectors differ, max "
                f"abs err {_err(_f64(got[i]), _f64(want[i])):.3e}")
    for j, (u, v) in enumerate(pairs):
        k = n_vec + j
        err = _err(_f64(got[k]), _f64(want[k]))
        scale = float((_f64(u) * _f64(v)).abs().sum())
        if not err <= TOL["df32_dot"] * scale:
            raise SmokeFailure(f"{name} dot {j}: |kernel - twin| = "
                               f"{err:.3e} > {TOL['df32_dot']} x "
                               f"sum|u v| = {scale:.3e}")
    for j, ref in enumerate(refolded):
        if not _same(got[n_vec + len(pairs) + j], ref):
            raise SmokeFailure(f"{name} folded scalar {j} differs from "
                               f"the twin's formula on the kernel's dots")
    return [_err(_f64(g), _f64(w)) for g, w in zip(got, want)]


def check_kernels(calls: dict, inp: dict) -> dict:
    """Each kernel against its plain version; returns name -> max abs
    error over all its outputs."""
    import torch
    errs = {}
    for name, (kern, plain, dt) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if dt == "df32":
            per_out = check_df_kernel(name, got, want, inp)
            errs[name] = max(per_out)
            _say("check", kernel=name, ok=True, vectors="equal",
                 folded_scalars="equal", max_abs_err_per_output="["
                 + ",".join(f"{e:.3e}" for e in per_out) + "]",
                 scale_per_output="[" + ",".join(
                     f"{float(_f64(w).abs().max()):.3e}" for w in want)
                 + "]")
            continue
        if dt == "bit_equal":
            (g,), (w,) = got, want
            same = _same(g, w) if hasattr(g, "hi") else torch.equal(g, w)
            err = _err(_f64(g), _f64(w))
            if not same or err > TOL[dt]:
                raise SmokeFailure(f"{name}: kernel and twin differ, max "
                                   f"abs err {err:.3e} (bit-equal wanted)")
            errs[name] = err
            _say("check", kernel=name, ok=True, bit_equal=True,
                 max_abs_err=f"{err:.3e}",
                 scale=f"{float(_f64(w).abs().max()):.3e}")
            continue
        if dt == "float32_chain":
            (g,), (w,) = got, want
            err, scale = _err(g, w), float(w.abs().max())
            if not err <= TOL[dt] * scale:
                raise SmokeFailure(f"{name}: |kernel - twin| = {err:.3e} > "
                                   f"{TOL[dt]} x max|twin| = {scale:.3e}")
            errs[name] = err
            _say("check", kernel=name, ok=True, degree=CHEBY_DEGREE,
                 max_abs_err=f"{err:.3e}", scale=f"{scale:.3e}",
                 bit_equal=torch.equal(g, w))
            continue
        for i, (g, w) in enumerate(zip(got, want)):
            what = f"{name} output {i}"
            if dt == "float64":
                _close(what, g, w, TOL[dt]["rtol"],
                       TOL[dt]["atol_rel"] * float(w.abs().max()))
            elif g.dim() == 0 or (name in BATCHED and g.dim() == 1):
                _close(what, g, w, TOL["float32_dot"]["rtol"], 0.0)
            else:
                _close(what, g, w, **TOL["float32"])
        per_out = [_err(g, w) for g, w in zip(got, want)]
        errs[name] = max(per_out)
        _say("check", kernel=name, ok=True, max_abs_err_per_output="["
             + ",".join(f"{e:.3e}" for e in per_out) + "]",
             scale_per_output="[" + ",".join(
                 f"{float(w.abs().max()):.3e}" for w in want) + "]")
    return errs


def _fits(total: int, per_segment: int, restarts: int) -> bool:
    """Is `total` the launches of 1 to 1 + restarts solver segments,
    per_segment each? (api._restarted may re-enter the solver.)"""
    return any(total == per_segment * k for k in range(1, restarts + 2))


def check_counts(method: str, dtype: str, it: int, counts: dict,
                 restarts: int, device: str = "cuda") -> None:
    """The launch counts that a converged run of `method` on its route
    must show after `it` iterations in all (over every restart segment);
    raises SmokeFailure otherwise. A pipelined-RR replacement iteration
    launches six SpMVs (five in df32, which forms no t = A w) and no
    phase kernel. df32 runs the DF kernels (the DF SpMV in place of the
    float one) and no float32 kernel."""
    used = {"bicgstab": ("fused_k1", "fused_k2", "fused_k3"),
            "ca_bicgstab": ("fused_ca_k1", "fused_ca_k2"),
            "pipe_bicgstab": ("fused_phase_a", "fused_phase_b"),
            "pipe_bicgstab_rr": ("fused_phase_a", "fused_phase_b")}
    used_df = {"bicgstab": ("fused_k1_df", "fused_k2_df", "fused_k3_df"),
               "ca_bicgstab": ("fused_ca_k1_df", "fused_ca_k2_df"),
               "pipe_bicgstab": ("fused_phase_a_df", "fused_phase_b_df"),
               "pipe_bicgstab_rr": ("fused_phase_a_df", "fused_phase_b_df")}
    rr = method == "pipe_bicgstab_rr"
    df = dtype == "df32"
    if device == "cpu" or dtype == "float64":
        fused = ()             # plain twins, or the unfused solver
    else:
        fused = (used_df if df else used).get(method, ())
    n_rr = it - counts[fused[0]] if fused and rr else 0
    spmv_name = "dia_spmv_df" if dtype == "df32" else "dia_spmv"
    for k, v in counts.items():
        if k == spmv_name:
            continue
        want = (it - n_rr) if k in fused else 0
        if v != want:
            raise SmokeFailure(f"{method} {dtype}: {k} launched {v} times "
                               f"in {it} iterations, expected {want}")
    spmv = counts[spmv_name]
    if device == "cpu":
        ok = spmv == 0
    else:
        # the unfused solvers launch 2 SpMVs per (classic-equivalent)
        # iteration, a replacement 4 more; the fused drivers none per
        # iteration, a replacement 6 (5 in df32)
        per_iter, per_rr = (0, 5 if df else 6) if fused else (2, 4)
        segment = (SEGMENT_SPMVS_DF if fused and df else SEGMENT_SPMVS)
        rrs = [0]
        if rr:       # at least one replacement: the path is set up so
            rrs = [n_rr] if fused else range(1, NRR * (restarts + 1) + 1)
        ok = any(_fits(spmv - per_iter * it - per_rr * r, segment[method],
                       restarts) and (r >= 1 or not rr)
                 for r in rrs)
    if not ok:
        raise SmokeFailure(f"{method} {dtype}: {spmv} SpMV launches in {it} "
                           f"iterations do not fit the route")


def run_main_path(n: int, dtype: str, tol: float, device: str = "cuda",
                  method: str = "bicgstab", extra=()):
    """Drive `solve --matrix transport-like:n --method M` through the
    CLI's own code (cli.run_solve), with every launch counter set to 0
    just before and read just after. Checks convergence, max|x-1| and
    the counters (check_counts; on the CPU every wrapper takes its plain
    version and counts nothing). Returns (report, counts, max|x-1|)."""
    from mpi_bicgstab_tpu_torch import cli
    args = cli.build_parser().parse_args(
        ["solve", "--matrix", f"transport-like:{n}", "--method", method,
         "--dtype", dtype, "--tol", str(tol), "--device", device, *extra])
    reset_counts()
    report, res = cli.run_solve(args)
    counts = read_counts()
    err = float((_f64(res.x) - 1.0).abs().max())
    if not report["converged"]:
        raise SmokeFailure(f"{method} {dtype} did not converge: {report}")
    if err >= (1e-3 if dtype == "float32" else 1e-6):
        raise SmokeFailure(f"{method} {dtype}: max|x-1| = {err:.3e}")
    if dtype == "df32" and not report["true_relres"] <= 1e-8:
        raise SmokeFailure(f"{method} {dtype}: true_relres "
                           f"{report['true_relres']:.3e} > 1e-8")
    check_counts(method, dtype, report["total_iter"], counts, args.restarts,
                 device)
    return report, counts, err


def _band_nnz(A) -> int:
    return sum(A.n_rows - abs(o) for o in A.offsets)


def work(name: str, inp: dict) -> tuple[float, float, str]:
    """(bytes, flops, dtype) the function must move and do on these
    inputs: each input read once, each output written once; flops count
    the band's structural entries."""
    if name.startswith("window_spmv"):
        return window_work(name, inp)
    if name.startswith("butterfly"):
        return butterfly_work(name, inp)
    A = inp["A32"]
    n, W = A.n_rows, A.n_diags
    nz = _band_nnz(A)
    fma, dot = DF_FMA_FLOPS, DF_DOT_FLOPS
    if name in ("cheby_chain", "cheby_chain_df"):
        # the band once, v in, x out; operations of this run's chain: the
        # band product at every step but the last, 2 flops per entry (one
        # df_fma in DF), and 5 (in DF 4 df_fma) updates per row and step
        H = inp["H32"]
        n, W, nz, d = H.n_rows, H.n_diags, _band_nnz(H), CHEBY_DEGREE
        if name == "cheby_chain":
            return 4 * (W * n + 2 * n), 2 * nz * d + 5 * n * d, "float32"
        return 8 * (W * n + 2 * n), fma * (nz * d + 4 * n * d), "df32"
    if name == "fused_body_a":   # 7 DF vectors in, 5 out, 3 scalars, 2 dots
        return 8 * (12 * n + 3 + 2), fma * 8 * n + dot * 2 * n, "df32"
    if name == "fused_body_b":   # 9 DF vectors in, 3 out, 2 scalars, 5 dots
        return 8 * (12 * n + 2 + 5), fma * 5 * n + dot * 5 * n, "df32"
    if name == "dia_spmv_f32":
        return 4 * (W * n + 2 * n), 2 * nz, "float32"
    if name == "dia_spmv_f64":
        return 8 * (W * n + 2 * n), 2 * nz, "float64"
    if name == "fused_k1":   # r, p, s, r_hat in; p2, s2 out; 1 dot
        return 4 * (W * n + 6 * n + 3), 2 * nz + 4 * n + 2 * n, "float32"
    if name == "fused_k2":   # r, s2 in; q, y out; 2 dots
        return 4 * (W * n + 4 * n + 3), 2 * nz + 2 * n + 4 * n, "float32"
    if name == "fused_k3":   # x, p2, q, y, r_hat in; x2, r2 out; 2 dots
        return 4 * (7 * n + 4), 6 * n + 4 * n, "float32"
    # batched, K_MAIN lanes: the band once for all lanes, every [k, n]
    # plane once, the [k] scalars and dots; the flops of the single-lane
    # pass per lane
    k = K_MAIN
    if name == "batched_dia_spmv":
        return 4 * (W * n + 2 * k * n), 2 * nz * k, "float32"
    if name == "fused_k1b":  # r p s r^ in; p2 s2 out; beta omega active; 1
        return 4 * (W * n + 6 * k * n + 4 * k), k * (2 * nz + 6 * n), \
            "float32"
    if name == "fused_k2b":  # r s2 in; q y out; alpha; 2 dots
        return 4 * (W * n + 4 * k * n + 3 * k), k * (2 * nz + 6 * n), \
            "float32"
    if name == "fused_k3b":  # x p2 q y r^ in; x2 r2 out; 3 scalars; 2 dots
        return 4 * (7 * k * n + 5 * k), k * 10 * n, "float32"
    # DF: 8 bytes per element; the vectors and scalars as for float32;
    # operations: one df_fma per band entry and per update, and the dots
    if name == "dia_spmv_df":
        return 8 * (W * n + 2 * n), fma * nz, "df32"
    if name == "fused_k1_df":   # + rTr in, alpha out
        return 8 * (W * n + 6 * n + 5), fma * (nz + 2 * n) + dot * n, "df32"
    if name == "fused_k2_df":   # omega out
        return 8 * (W * n + 4 * n + 4), fma * (nz + n) + 2 * dot * n, "df32"
    if name == "fused_k3_df":   # + rTr in, beta out
        return 8 * (7 * n + 6), 3 * fma * n + 2 * dot * n, "df32"
    # DF CA passes and pipelined phases: (vectors in, vectors out, scalars
    # in + dots and folded scalars out, df_fma updates per row, dots).
    # CA K1: r p s w z in; p' s' z' q y out; omega' folded. CA K2: q y x
    # p' r^ s' z' in; x' r' w' out; beta', alpha' folded. Phase A: w r p s
    # z v in; t p' s' z' q y out. Phase B: z' x p' q y t r^ s' in; v' x' r'
    # w' out.
    df_counts = {"fused_ca_k1_df": (5, 5, 3 + 2 + 1, 6, 2),
                 "fused_ca_k2_df": (7, 3, 3 + 5 + 2, 3, 5),
                 "fused_phase_a_df": (6, 6, 3 + 2 + 1, 8, 2),
                 "fused_phase_b_df": (8, 4, 3 + 5 + 2, 5, 5)}
    if name in df_counts:
        n_in, n_out, n_sc, n_fma, n_dot = df_counts[name]
        return (8 * (W * n + (n_in + n_out) * n + n_sc),
                fma * (nz + n_fma * n) + dot * n_dot * n, "df32")
    # (vectors in, vectors out, scalars in + dots out); each of these
    # does one band product and 16 flops per row in its updates and dots.
    # CA K1: r p s w z in; p' s' z' q y out. CA K2: q y x p' r^ s' z'
    # in; x' r' w' out. Phase A: z' r p s w z in; v' p' s' q y out.
    # Phase B: w' x p' q y r^ s' z' in; t' x' r' out.
    counts = {"fused_ca_k1": (5, 5, 3 + 2), "fused_ca_k2": (7, 3, 2 + 5),
              "fused_phase_a": (6, 5, 3 + 2), "fused_phase_b": (8, 3, 2 + 5)}
    n_in, n_out, n_sc = counts[name]
    return (4 * (W * n + (n_in + n_out) * n + n_sc), 2 * nz + 16 * n,
            "float32")


def torch_csr(csr, dtype, device):
    """The host CSR as torch's sparse CSR tensor on `device`."""
    import torch
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.ptr, device=device),
        torch.as_tensor(csr.col, device=device),
        torch.as_tensor(csr.val, dtype=dtype, device=device),
        size=csr.shape)


def library_call(name: str, inp: dict, csr):
    """One PyTorch call computing the same function, or None: torch's CSR
    sparse product for the SpMV (a yardstick; the port never calls it)."""
    import torch
    if name == "batched_dia_spmv":      # torch.sparse.mm(A in CSR, X^T)
        A = torch_csr(csr, torch.float32, inp["A32"].device)
        X = inp["b_x"]
        return lambda: torch.sparse.mm(A, X.t())
    f32 = name.endswith("f32")
    if name in ("window_spmv_f32", "window_spmv_f64"):
        A = torch_csr(csr, torch.float32 if f32 else torch.float64,
                      inp["W32"].device)
        x = inp["wx32" if f32 else "wx64"]
        return lambda: A @ x
    if name not in ("dia_spmv_f32", "dia_spmv_f64"):
        return None     # no PyTorch call computes a fused pass or a DF SpMV
    A = torch_csr(csr, torch.float32 if f32 else torch.float64,
                  inp["A32"].device)
    x = inp["x"] if f32 else inp["x64"]
    return lambda: A @ x


def time_kernels(calls: dict, inp: dict, csr) -> dict:
    """Per kernel: its device time and its plain version's, each as a
    replayed CUDA graph of back-to-back calls (no host gaps), its time as
    the host issues it one call after another (eager_ms: wrapper checks,
    allocation and launch included), its bound, and the library call's
    time."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    out = {}
    for name, (kern, plain, _) in calls.items():
        nbytes, flops, dt = work(name, inp)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dt]
        lib = library_call(name, inp, csr)
        # a DF twin is hundreds of PyTorch launches: a shorter chain
        plain_iters = 12 if dt == "df32" else 30
        row = {"ms": time_call(kern, graph=True) * 1e3,
               "eager_ms": time_call(kern) * 1e3,
               "plain_ms": time_call(plain, iters=plain_iters, reps=3,
                                     graph=True) * 1e3,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": (time_call(lib) * 1e3 if lib is not None
                              else None)}
        out[name] = row
        extra = {}
        if name in ("cheby_chain", "cheby_chain_df"):
            # the floor this design can reach: the band read once per
            # step that multiplies (CHEBY_DEGREE times), v in, x out
            H = inp["H32"]
            elem = 4 if name == "cheby_chain" else 8
            band = elem * H.n_rows * (CHEBY_DEGREE * H.n_diags + 2)
            extra = {"band_reads_floor_ms":
                     f"{band / HBM_BYTES_PER_S * 1e3:.4f}",
                     "band_reads_floor_share":
                     f"{band / HBM_BYTES_PER_S * 1e3 / row['ms']:.3f}"}
        _say("times", kernel=name, ms=f"{row['ms']:.4f}",
             bound_ms=f"{row['bound_ms']:.4f}",
             bound_share=f"{row['bound_ms'] / row['ms']:.3f}",
             eager_ms=f"{row['eager_ms']:.4f}",
             plain_ms=f"{row['plain_ms']:.4f}",
             library_ms=(f"{row['library_ms']:.4f}"
                         if row["library_ms"] is not None else None),
             bytes=nbytes, **extra)
    return out


def unfused_df_iters(probdf, phase: str) -> tuple[int, bool]:
    """(n_iter, converged) of the unfused DF solver of PATHS[phase]'s
    method over the DF SpMV kernel at the path's tol: the yardstick of
    that path's fused DF driver. pipe_bicgstab runs the plain DF loop
    (_pipe without its fused bodies), so that no hand-written kernel
    but the DF SpMV stands in the yardstick."""
    from mpi_bicgstab_tpu_torch.ops.cuda_spmv import dia_spmv_df
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS, _pipe
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    method, dtype, tol, _ = PATHS[phase]
    A = probdf.A
    solver = CLASSIC_SOLVERS[method]
    if method == "pipe_bicgstab":
        solver = functools.partial(_pipe, rr=False)
    res = solver(
        lambda v: dia_spmv_df(A.vals, A.offsets, v), Comm(), probdf.b,
        probdf.x0, SolverConfig(tol=tol, dtype=dtype, krr=KRR, nrr=NRR))
    return res.n_iter, bool(res.converged)


# --- the shifted family -----------------------------------------------------

def flagship_ladder(S: int = S_MAIN):
    """main_shifted.c:95-100: sigma_i = (i + 1) sigma_max / S."""
    import numpy as np
    return (np.arange(S) + 1) * (SIGMA_MAX / S)


def _df_random(rng, shape):
    """Random normalised DF pairs as float32 NumPy (hi, lo): hi normal,
    lo below a quarter of hi's ulp, so that hi + lo rounds to hi."""
    import numpy as np
    hi = rng.standard_normal(shape, dtype=np.float32)
    lo = (rng.random(shape, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.5) * np.spacing(np.abs(hi))
    return hi, np.where(hi == 0, np.float32(0), lo).astype(np.float32)


def shift_update_inputs(n: int, S: int = S_MAIN, seed: int = 0,
                        frozen_share: float = 0.3):
    """The shift update's inputs at the main path's shapes, on the card:
    random DF [S, n] x_set and p_set, DF [n] q, r_old and r_new, and six
    DF [S] coefficients with about `frozen_share` of the rows frozen
    (0, 0, 0, 0, 1, 0), all from a seeded NumPy generator (the state in
    blocks of 64 rows, to bound the host's memory). Returns (the 11
    arguments, the active rows as a NumPy bool array)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.precision import DF
    rng = np.random.default_rng(seed)

    def pair(shape):
        h = torch.empty(shape, dtype=torch.float32, device="cuda")
        lo = torch.empty_like(h)
        for r0 in range(0, shape[0], 64 if len(shape) == 2 else shape[0]):
            a, b = _df_random(rng, (min(64, shape[0] - r0), *shape[1:])
                              if len(shape) == 2 else shape)
            h[r0:r0 + len(a)].copy_(torch.from_numpy(a))
            lo[r0:r0 + len(a)].copy_(torch.from_numpy(b))
        return DF(h, lo)

    x, p = pair((S, n)), pair((S, n))
    q, ro, rn = pair((n,)), pair((n,)), pair((n,))
    active = rng.random(S) >= frozen_share
    act = torch.as_tensor(active, device="cuda")
    coefs = []
    for i in range(6):
        c = pair((S,))
        coefs.append(DF(torch.where(act, c.hi, 1.0 if i == 4 else 0.0),
                        torch.where(act, c.lo, 0.0)))
    return [x, p, q, ro, rn, *coefs], active


def shift_update_work(S: int, n: int) -> tuple[float, float]:
    """(bytes, flops) of one shift update: the four float planes of the
    state read and written once, q, r_old, r_new and the coefficients
    read once; three df_fma, three df_mul and two df_add per element."""
    nbytes = 8 * (4 * S * n + 3 * n + 6 * S)
    flops = S * n * (3 * DF_FMA_FLOPS + 3 * DF_MUL_FLOPS + 2 * DF_ADD_FLOPS)
    return nbytes, flops


def check_shift_update(n: int) -> tuple[float, dict]:
    """The shift-update kernel against its twin at S = 512 and the main
    path's n, then its times. The kernel updates the state in place, so
    the twin runs on a copy of the inputs; the twin goes over slices of
    SHIFT_ROWS_PER_TWIN shift rows (the function is independent per row,
    and the full-width twin's temporaries would take ~3.3 GB each).
    Returns (max abs error, the times row)."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops import cuda_shift_update as csu
    from mpi_bicgstab_tpu_torch.ops.precision import DF
    t0 = time.perf_counter()
    args, active = shift_update_inputs(n)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    S, R = len(active), SHIFT_ROWS_PER_TWIN
    x0, p0 = (DF(v.hi.clone(), v.lo.clone()) for v in args[:2])
    got_x, got_p = csu.fused_shift_update_df(*args)
    torch.cuda.synchronize()
    err = 0.0
    for r0 in range(0, S, R):
        sl = slice(r0, r0 + R)
        want = csu.fused_shift_update_df_plain(
            x0[sl], p0[sl], *args[2:5], *(c[sl] for c in args[5:]))
        for got, w in zip((got_x[sl], got_p[sl]), want):
            err = max(err, _err(_f64(got), _f64(w)))
            if not _same(got, w):
                raise SmokeFailure(f"shift_update_df rows {r0}..{r0 + R}: "
                                   f"kernel and twin differ, max abs err "
                                   f"{_err(_f64(got), _f64(w)):.3e}")
    frozen = torch.as_tensor(~active, device="cuda")
    for got, src in ((got_x, x0), (got_p, p0)):
        if not (torch.equal(got.hi[frozen], src.hi[frozen])
                and torch.equal(got.lo[frozen], src.lo[frozen])):
            raise SmokeFailure("shift_update_df changed a frozen row")
    del x0, p0
    _say("check", kernel="shift_update_df", ok=True, S=S, n=n,
         frozen_rows=int((~active).sum()), state="equal",
         frozen="bit-unchanged", max_abs_err=err,
         twin=f"over_slices_of_{R}_shift_rows", host_setup_s=round(setup, 3))

    def plain():
        for r0 in range(0, S, R):
            sl = slice(r0, r0 + R)
            csu.fused_shift_update_df_plain(
                args[0][sl], args[1][sl], *args[2:5],
                *(c[sl] for c in args[5:]))

    def kern():
        # in place: every call updates the same state again
        csu.fused_shift_update_df(*args)

    nbytes, flops = shift_update_work(S, n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["df32"]
    row = {"ms": time_call(kern, iters=30, graph=True) * 1e3,
           "eager_ms": time_call(kern, iters=30) * 1e3,
           "plain_ms": time_call(plain, iters=4, reps=3, graph=True) * 1e3,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None}
    _say("times", kernel="shift_update_df", ms=f"{row['ms']:.4f}",
         bound_ms=f"{row['bound_ms']:.4f}",
         bound_share=f"{row['bound_ms'] / row['ms']:.3f}",
         eager_ms=f"{row['eager_ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
         library_ms=None, bytes=nbytes, flops=flops,
         ops_ms=f"{t_ops * 1e3:.4f}")
    return err, row


def shifted_residuals(x_set, sigma, A64, b64) -> float:
    """max_j ||b - (A + sigma_j I) x_j|| / ||b|| on the card, in float64
    through the DIA SpMV kernel, one row at a time."""
    import torch

    from mpi_bicgstab_tpu_torch.ops.cuda_spmv import dia_spmv
    norms = []
    for j, s in enumerate(sigma):
        xj = (x_set.hi[j].double() + x_set.lo[j].double()
              if hasattr(x_set, "hi") else x_set[j].double())
        r = b64 - (dia_spmv(A64.vals, A64.offsets, xj) + float(s) * xj)
        norms.append(torch.linalg.vector_norm(r))
    return float((torch.stack(norms) / torch.linalg.vector_norm(b64)).max())


def check_shifted_counts(what: str, dtype: str, it: int, counts: dict,
                         init_spmvs: int = 0) -> None:
    """A shifted solve's launches: two seed SpMVs per iteration, the
    exit's true-residual SpMV (and init_spmvs more at set-up); the DF
    shift update once per iteration in df32; nothing else."""
    spmv = "dia_spmv_df" if dtype == "df32" else "dia_spmv"
    want = {k: 0 for k in counts}
    want[spmv] = 2 * it + 1 + init_spmvs
    if dtype == "df32":
        want["shift_update_df"] = it
    if counts != want:
        bad = {k: (v, want[k]) for k, v in counts.items() if v != want[k]}
        raise SmokeFailure(f"{what}: launches (got, expected) {bad} in "
                           f"{it} iterations")


def _solve_shifted_cli(argv):
    from mpi_bicgstab_tpu_torch import cli
    return cli.run_solve_shifted(cli.build_parser().parse_args(argv))


def run_shifted_path(phase: str, A64, b64):
    """Drive `solve-shifted --matrix transport-like:N --dtype D --tol T`
    with the flagship ladder through the CLI's own code, every launch
    counter set to 0 just before and read just after. Checks that every
    shift converged, that every shift's true residual (on the card) is at
    most 100 tol, the df32 seed's true residual, and the launches.
    Returns (payload, counts, the true residual)."""
    import gc

    import torch
    dtype, tol = SHIFTED_PATHS[phase]
    argv = ["solve-shifted", "--matrix", f"transport-like:{N_MAIN}",
            "--method", "shifted_lopbicg_switching", "--dtype", dtype,
            "--sigma-len", str(S_MAIN), "--sigma-max", str(SIGMA_MAX),
            "--seed", str(SEED_MAIN), "--tol", str(tol)]
    reset_counts()
    (row,), res = _solve_shifted_cli(argv)
    counts = read_counts()
    it = row["total_iter"]
    if not row["all_converged"]:
        raise SmokeFailure(f"{phase}: not every shift converged: {row}")
    worst = shifted_residuals(res.x_set, flagship_ladder(), A64, b64)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if not worst <= 100 * tol:
        raise SmokeFailure(f"{phase}: max true residual {worst:.3e} > "
                           f"100 x {tol}")
    if dtype == "df32" and not row["seed_true_relres"] <= 1e-8:
        raise SmokeFailure(f"{phase}: seed_true_relres "
                           f"{row['seed_true_relres']:.3e} > 1e-8")
    check_shifted_counts(phase, dtype, it, counts)
    _say(phase, dtype=dtype, tol=tol, sigma_len=S_MAIN, n_iter=it,
         seed=row["seed"], final_seed=row["final_seed"],
         all_converged=row["all_converged"],
         final_relres=row["final_relres"],
         seed_true_relres=row["seed_true_relres"],
         max_shift_relres=row["max_shift_relres"],
         max_true_relres_on_card=worst, solve_s=row["total_time_s"],
         launches=json.dumps(counts).replace(" ", ""))
    return row, counts, worst


def run_refine_path(prob32, A64, b64, chunk: int = 128) -> None:
    """The float32 seed-switching solve of the flagship ladder at the
    loose tolerance, then refine_shifted_solutions to the tight one (one
    SpMV per row and operator application, in chunks of 128 shifts). The
    refinement must iterate, every shift's true residual on the card
    must fall from above the tight tolerance to at most 10 times it, and
    the launches must be the solve's and the refinement's SpMVs."""
    import gc

    import torch

    from mpi_bicgstab_tpu_torch.api import (refine_shifted_solutions,
                                            solve_shifted)
    from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,
                                                     SolverConfig)
    loose, tol = REFINE_TOLS
    sigma = flagship_ladder()
    reset_counts()
    t0 = time.perf_counter()
    res = solve_shifted(prob32.A, prob32.b, sigma, seed=SEED_MAIN,
                        method="shifted_lopbicg_switching",
                        cfg=ShiftedConfig(tol=loose, max_iter=1000,
                                          dtype="float32"))
    it = res.n_iter
    converged = bool(res.stop_flags.all())
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    check_shifted_counts("shifted_refine solve", "float32", it, counts)
    before = shifted_residuals(res.x_set, sigma, A64, b64)
    reset_counts()
    t0 = time.perf_counter()
    x2, rk, rres = refine_shifted_solutions(
        prob32.A, prob32.b, sigma, res.x_set,
        SolverConfig(tol=tol, max_iter=1000, dtype="float32"), chunk=chunk)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    rcounts = read_counts()
    del res
    after = shifted_residuals(x2, sigma, A64, b64)
    del x2
    gc.collect()
    torch.cuda.empty_cache()
    # each chunk applies the operator once, then twice per iteration it
    # runs (the slowest chunk runs rk of them)
    S = len(sigma)
    lo, hi = S + 2 * chunk * rk, S * (1 + 2 * rk)
    extra = {k: v for k, v in rcounts.items() if k != "dia_spmv" and v}
    if not (converged and before > tol and rk > 0 and after <= 10 * tol
            and float(rres.max()) <= tol):
        raise SmokeFailure(
            f"shifted_refine: solve converged {converged}, true residual "
            f"{before:.3e} before and {after:.3e} after {rk} refinement "
            f"iterations (recurrence {float(rres.max()):.3e})")
    if extra or not lo <= rcounts["dia_spmv"] <= hi:
        raise SmokeFailure(f"shifted_refine: refinement launches {rcounts}, "
                           f"expected only {lo}-{hi} dia_spmv")
    _say("shifted_refine", dtype="float32", solve_tol=loose, refine_tol=tol,
         sigma_len=S, n_iter=it, max_true_relres_before=before,
         refine_iters=rk, max_relres_after_refine=float(rres.max()),
         max_true_relres_on_card=after, solve_s=round(solve_s, 3),
         refine_s=round(refine_s, 3),
         launches=json.dumps(counts).replace(" ", ""),
         refine_launches=json.dumps(rcounts).replace(" ", ""))


def run_other_shifted_methods(prob64, A64, b64, tol: float = 1e-10):
    """shifted_bicgstab, shifted_lopbicgstab, shifted_pipe_lopbicgstab and
    shifted_lopbicg in float64 at 512 shifts through api.solve_shifted on
    one built problem; every shift converged, its true residual at most
    100 tol, and the launches. shifted_bicgstab's row 0 is its unshifted
    seed system (reference shifted_solver.c:90), so that row's residual is
    taken with sigma = 0."""
    import gc

    import torch

    from mpi_bicgstab_tpu_torch.api import solve_shifted
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    sigma = flagship_ladder()
    for method in ("shifted_bicgstab", "shifted_lopbicgstab",
                   "shifted_pipe_lopbicgstab", "shifted_lopbicg"):
        reset_counts()
        t0 = time.perf_counter()
        res = solve_shifted(prob64.A, prob64.b, sigma, seed=SEED_MAIN,
                            method=method,
                            cfg=ShiftedConfig(tol=tol, max_iter=1000))
        converged = bool(res.stop_flags.all())
        secs = time.perf_counter() - t0
        counts = read_counts()
        sig = sigma.copy()
        if method == "shifted_bicgstab":
            sig[0] = 0.0
        worst = shifted_residuals(res.x_set, sig, A64, b64)
        what = f"shifted_f64_methods {method}"
        if not (converged and worst <= 100 * tol):
            raise SmokeFailure(f"{what}: converged {converged}, max true "
                               f"residual {worst:.3e}")
        # the pipelined seed also multiplies w0 and t0 at set-up
        check_shifted_counts(what, "float64", res.n_iter, counts,
                             2 if method == "shifted_pipe_lopbicgstab"
                             else 0)
        _say("shifted_f64_methods", method=method, n_iter=res.n_iter,
             final_seed=res.final_seed,
             seed_true_relres=float(res.true_relres),
             max_true_relres_on_card=worst, solve_s=round(secs, 3),
             launches=json.dumps(counts).replace(" ", ""))
        del res
        gc.collect()
        torch.cuda.empty_cache()


def run_checkpoint_path(S: int = 16, every: int = 5,
                        sigma_max: float = 4.0) -> None:
    """The df32 seed-switching solve at S shifts on the full matrix,
    uninterrupted, then checkpointed every `every` iterations, then
    resumed from the finished checkpoint: both x_sets bit-identical to
    the uninterrupted one. The ladder is wide (sigma up to 4), so the
    seed at its top converges first and the solver switches seeds
    between two checkpoints (the flagship ladder's shifts all stop
    together)."""
    import torch
    path = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
        "switching.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    argv = ["solve-shifted", "--matrix", f"transport-like:{N_MAIN}",
            "--dtype", "df32", "--sigma-len", str(S), "--seed", str(S - 1),
            "--sigma-max", str(sigma_max), "--tol", "1e-10"]
    (ref,), res_u = _solve_shifted_cli(argv)
    if not (ref["all_converged"] and ref["final_seed"] != S - 1):
        raise SmokeFailure(f"shifted_checkpoint: expected every shift to "
                           f"converge after a seed switch: {ref}")
    runs = [_solve_shifted_cli(argv + ["--checkpoint", str(path),
                                       "--checkpoint-every", str(every)])
            for _ in range(2)]          # the second resumes the finished one
    for ((row,), res), what in zip(runs, ("segmented", "resumed")):
        same = (torch.equal(res.x_set.hi, res_u.x_set.hi)
                and torch.equal(res.x_set.lo, res_u.x_set.lo))
        if not (same and row["total_iter"] == ref["total_iter"]
                and row["final_seed"] == ref["final_seed"]):
            raise SmokeFailure(f"shifted_checkpoint: the {what} run differs "
                               f"from the uninterrupted one: {row} vs {ref}")
    path.unlink()
    _say("shifted_checkpoint", dtype="df32", sigma_len=S, every=every,
         sigma_max=sigma_max, seed=S - 1, n_iter=ref["total_iter"],
         final_seed=ref["final_seed"],
         all_converged=ref["all_converged"], segmented="bit-identical",
         resumed="bit-identical")


# --- batched right-hand sides ---------------------------------------------

def batched_rhs(csr, k: int, seed: int = 0):
    """(B, X): B[j] = A x_j with x_0 = ones and seeded x_j of kinds that
    stop at different iterations (on transport_like at tol 1e-6 a unit
    vector stops first, a sparse vector next, a fast wave last)."""
    import numpy as np
    n = csr.nrows
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n

    def unit(j):
        return np.eye(1, n, rng.integers(n)).ravel()

    def sparse(j):
        return (rng.random(n) < 0.01) * rng.standard_normal(n)

    kinds = [lambda j: np.ones(n), unit, sparse,
             lambda j: np.sin(2 * np.pi * 50 * t),
             lambda j: rng.standard_normal(n),
             lambda j: rng.uniform(-1.0, 1.0, n)]
    X = np.stack([kinds[j % len(kinds)](j) for j in range(k)])
    return np.stack([csr.matvec(x) for x in X]), X


def _rhs_batch_cli(n, B, dtype, tol, device, workdir):
    """`solve --matrix transport-like:n --rhs-batch B.npy` through the
    CLI's own code (cli.run_solve), every launch counter set to 0 just
    before and read just after. Returns (report, result, counts)."""
    import numpy as np

    from mpi_bicgstab_tpu_torch import cli
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / f"B_{B.shape[0]}.npy"
    np.save(path, B)
    args = cli.build_parser().parse_args(
        ["solve", "--matrix", f"transport-like:{n}", "--rhs-batch",
         str(path), "--dtype", dtype, "--tol", str(tol), "--device",
         device])
    reset_counts()
    report, res = cli.run_solve(args)
    counts = read_counts()
    path.unlink()
    return report, res, counts


def _workdir():
    return Path(__file__).resolve().parent / "build" / "chip_smoke"


def run_batched_path(n: int, device: str = "cuda", k: int = K_MAIN,
                     tol: float = 1e-6, A32=None, workdir=None) -> dict:
    """The batched main path: `solve --rhs-batch` in float32 with k lanes.
    Every lane converged, its true residual <= 100 tol, its n_iter within
    1 of a single-RHS f32 solve of that lane (api.solve on A32, outside
    the counted run), at least two distinct n_iter (so that lanes freeze
    while others iterate), lane 0 (x = ones) within 1e-3; on the card the
    launches are K1b = K2b = K3b = the largest n_iter and 2 batched SpMVs
    (r0 and the true residual), nothing else; on the CPU none. Returns
    the counts."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    csr = transport_like(n)
    B, X = batched_rhs(csr, k)
    report, res, counts = _rhs_batch_cli(n, B, "float32", tol, device,
                                         workdir or _workdir())
    its = report["n_iter"]
    if A32 is None:
        A32 = build_problem(csr, dtype=torch.float32, multiple=1,
                            device=device).A
    single = [solve(A32, torch.as_tensor(B[j], dtype=torch.float32,
                                         device=device),
                    cfg=SolverConfig(tol=tol, dtype="float32")).n_iter
              for j in range(k)]
    err0 = float((res.x[0].double() - 1.0).abs().max())
    err = float((res.x.double().cpu() - torch.as_tensor(X)).abs().max())
    if not (all(report["converged"])
            and report["max_true_relres"] <= 100 * tol):
        raise SmokeFailure(f"batched: {report}")
    # lanes that stop apart drive the frozen-lane masking at full width
    if (max(abs(a - b) for a, b in zip(its, single)) > 1 or err0 >= 1e-3
            or len(set(its)) < 2):
        raise SmokeFailure(f"batched: n_iter {its} (lanes must stop at "
                           f"different iterations), single-RHS {single}, "
                           f"max|x_0 - 1| {err0:.3e}")
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        want.update(fused_k1b=max(its), fused_k2b=max(its),
                    fused_k3b=max(its), batched_dia_spmv=2)
    if counts != want:
        bad = {c: (v, want[c]) for c, v in counts.items() if v != want[c]}
        raise SmokeFailure(f"batched: launches (got, expected) {bad}")
    _say("batched", k=k, dtype="float32", tol=tol, n_iter=its,
         single_rhs_n_iter=single, distinct_stops=len(set(its)),
         converged=report["converged"],
         max_true_relres=report["max_true_relres"],
         max_abs_x0_minus_1=err0, max_abs_err_all_lanes=err,
         solve_s=report["total_time_s"],
         launches=_launches(counts))
    return counts


def run_batched_lanes(n: int, dtype: str, device: str = "cuda",
                      workdir=None) -> dict:
    """The per-lane route: `solve --rhs-batch` with K_LANES lanes in
    float64 or df32 at LANES_TOL, each lane through the unfused classic
    solver over the DIA SpMV kernel of its type (2 SpMVs per iteration and
    2 per solve segment, r0 and the true residual; a lane restart adds a
    segment), no other kernel; every lane converged, true residual <= 100
    tol, lane 0 (x = ones) within 1e-6. Returns the counts."""
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    csr = transport_like(n)
    B, _ = batched_rhs(csr, K_LANES)
    report, res, counts = _rhs_batch_cli(n, B, dtype, LANES_TOL, device,
                                         workdir or _workdir())
    its = report["n_iter"]
    err0 = float((_f64(res.x[0]) - 1.0).abs().max())
    if not (all(report["converged"])
            and report["max_true_relres"] <= 100 * LANES_TOL
            and err0 < 1e-6):
        raise SmokeFailure(f"batched_{dtype}: {report}, max|x_0 - 1| "
                           f"{err0:.3e}")
    spmv = "dia_spmv_df" if dtype == "df32" else "dia_spmv"
    segs = counts[spmv] - 2 * sum(its)
    others = {c: v for c, v in counts.items() if v and c != spmv}
    ok = (counts[spmv] == 0 if device == "cpu"
          else segs % 2 == 0 and K_LANES <= segs // 2 <= 3 * K_LANES)
    if others or not ok:
        raise SmokeFailure(f"batched_{dtype}: launches {counts} for n_iter "
                           f"{its}")
    _say(f"batched_{'df32' if dtype == 'df32' else 'f64'}", k=K_LANES,
         dtype=dtype, tol=LANES_TOL, n_iter=its,
         converged=report["converged"],
         max_true_relres=report["max_true_relres"],
         max_abs_x0_minus_1=err0, solve_s=report["total_time_s"],
         launches=_launches(counts))
    return counts


def time_batched(csr, prob32, inp, single_dev_ms: float) -> None:
    """Time per batched iteration at K_MAIN lanes (tol=0 chains through
    bench_batched_iteration), eager and as replayed CUDA graphs, beside
    K_MAIN single-lane classic f32 iterations on the device and the
    batched iteration's byte floor (K1b + K2b + K3b)."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import \
        bench_batched_iteration
    kw = dict(k=K_MAIN, iters=60, prob=prob32)
    eager = bench_batched_iteration(csr, "float32", **kw)
    dev = bench_batched_iteration(csr, "float32", graph=True, **kw)
    ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
    nbytes = sum(work(k, inp)[0] for k in ("fused_k1b", "fused_k2b",
                                           "fused_k3b"))
    _say("batched_bench", k=K_MAIN, chain="tol=0x60",
         eager_ms_per_iter=f"{ms:.4f}", device_ms_per_iter=f"{dev_ms:.4f}",
         device_busy_share=f"{dev_ms / ms:.3f}",
         single_lane_x8_device_ms=f"{K_MAIN * single_dev_ms:.4f}",
         per_rhs_amortisation=f"{K_MAIN * single_dev_ms / dev_ms:.3f}",
         bound_ms_per_iter=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
         bytes_per_iter=nbytes)


def time_shifted(csr, probs: dict) -> None:
    """Time per shifted iteration at 512 shifts (tol=0 chains through
    bench_shifted_iteration), eager and, where two captured chains fit
    the card's memory, as replayed CUDA graphs, beside the floor of the
    shift update (4 S n elem bytes at 3.35 TB/s)."""
    import gc

    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import \
        bench_shifted_iteration
    # (dtype, shift_block, iters, graph): float64's per-iteration updates
    # hold ~26 GB of state and temporaries, so two captured chains (each
    # with its own memory pool) would not fit beside the eager pool
    for dtype, sb, iters, graph in (("df32", -1, 12, True),
                                    ("float32", -1, 192, True),
                                    ("float32", 0, 12, True),
                                    ("float64", -1, 12, False)):
        kw = dict(sigma_len=S_MAIN, seed=SEED_MAIN, iters=iters,
                  shift_block=sb, prob=probs[dtype])
        eager = bench_shifted_iteration(csr, dtype, **kw)
        dev = bench_shifted_iteration(csr, dtype, graph=True, **kw) \
            if graph else None
        gc.collect()
        torch.cuda.empty_cache()
        ms = eager["time_per_iter_s"] * 1e3
        floor = eager["shift_update_bytes"] / HBM_BYTES_PER_S * 1e3
        dev_ms = dev["time_per_iter_s"] * 1e3 if dev else None
        _say("times", shifted=dtype, shift_block=eager["shift_block"],
             sigma_len=S_MAIN, chains=f"tol=0x{eager['chains'][0]},"
             f"{eager['chains'][1]}", eager_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=(f"{dev_ms:.4f}" if dev else
                                 "not_measured(no_graph)"),
             device_busy_share=(f"{dev_ms / ms:.3f}" if dev else None),
             shift_update_floor_ms=f"{floor:.4f}",
             shift_update_bytes=eager["shift_update_bytes"],
             shift_update_GBps=f"{eager['shift_update_GBps']:.1f}")


# --- Chebyshev preconditioning and the DF pipelined bodies -----------------

def check_cheby_counts(what: str, method: str, dtype: str, it: int,
                       counts: dict, restarts: int, lanes: int = 1,
                       device: str = "cuda") -> None:
    """The launches of a converged preconditioned solve (`lanes` right-
    hand sides, `it` iterations over every lane and restart segment). One
    application of A p(A) is a chain and a SpMV: the chain kernel on a
    float32 or DF band, degree float64 SpMVs in float64. Per segment
    the classic solver applies it for r0 and the true residual and twice
    per iteration, df32 pipe_bicgstab also for w0 and t0 (its body kernels
    once each per iteration); each lane ends with one p(A) (the exit
    transform). Nothing else launches; on the CPU nothing at all."""
    if device == "cpu":
        if any(counts.values()):
            raise SmokeFailure(f"{what}: launches {counts} on the CPU")
        return
    d = CHEBY_DEGREE
    spmv = "dia_spmv_df" if dtype == "df32" else "dia_spmv"
    chain = {"float32": "cheby_chain", "df32": "cheby_chain_df"}.get(dtype)
    bodies = method == "pipe_bicgstab" and dtype == "df32"
    used = {spmv, chain} | ({"fused_body_a", "fused_body_b"} if bodies
                            else set())
    bad = {k: v for k, v in counts.items() if v and k not in used}
    if chain:
        applied = counts[spmv]
        ok = counts[chain] == applied + lanes
    else:
        applied, rest = divmod(counts[spmv] - d * lanes, d + 1)
        ok = rest == 0
    per_segment = 4 if method == "pipe_bicgstab" else 2
    segs, rest = divmod(applied - 2 * it, per_segment)
    ok = ok and rest == 0 and lanes <= segs <= lanes * (restarts + 1)
    if bodies:
        ok = ok and counts["fused_body_a"] == counts["fused_body_b"] == it
    if bad or not ok:
        raise SmokeFailure(f"{what}: launches {counts} do not fit {it} "
                           f"iterations of {method} {dtype} over {lanes} "
                           f"lane(s)")


def _launches(counts: dict) -> str:
    return json.dumps({c: v for c, v in counts.items() if v}).replace(" ",
                                                                       "")


def run_cheby_cli(n: int, device: str = "cuda"):
    """`[cheby]`: `solve --matrix transport-hard:n --method bicgstab
    --precond cheby:8 --dtype float32 --tol 1e-5` (AB_TOL) through the
    CLI's own code, every launch counter set to 0 just before and read
    just after: converged, true residual <= 100 tol, and the launches of
    check_cheby_counts. Returns the counts."""
    from mpi_bicgstab_tpu_torch import cli
    tol = AB_TOL
    args = cli.build_parser().parse_args(
        ["solve", "--matrix", f"transport-hard:{n}", "--method", "bicgstab",
         "--dtype", "float32", "--tol", str(tol), "--precond",
         f"cheby:{CHEBY_DEGREE}", "--max-iter", str(CHEBY_MAX_ITER),
         "--device", device])
    reset_counts()
    report, res = cli.run_solve(args)
    counts = read_counts()
    err = float((res.x.double() - 1.0).abs().max())
    if not (report["converged"] and report["true_relres"] <= 100 * tol):
        raise SmokeFailure(f"cheby: {report}")
    check_cheby_counts("cheby", "bicgstab", "float32", report["total_iter"],
                       counts, args.restarts, device=device)
    _say("cheby", method="bicgstab", dtype="float32", tol=tol,
         precond=report["precond"], n=report["n"],
         n_iter=report["total_iter"], converged=report["converged"],
         final_relres=report["final_relres"],
         true_relres=report["true_relres"], max_abs_x_minus_1=err,
         solve_s=report["total_time_s"], launches=_launches(counts))
    return counts


def run_cheby_api(phase: str, probs: dict, prec, device: str = "cuda"):
    """One of CHEBY_PATHS through api.solve on the built problem of its
    dtype, counted as run_cheby_cli. Returns the counts."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    method, dtype, tol = CHEBY_PATHS[phase]
    prob = probs[dtype]
    cfg = SolverConfig(tol=tol, max_iter=CHEBY_MAX_ITER, dtype=dtype)
    reset_counts()
    t0 = time.perf_counter()
    res = solve(prob.A, prob.b, method=method, cfg=cfg, precond=prec)
    converged = bool(res.converged)
    secs = time.perf_counter() - t0
    counts = read_counts()
    err = float((_f64(res.x) - 1.0).abs().max())
    true = float(res.true_relres)
    if not (converged and true <= 100 * tol):
        raise SmokeFailure(f"{phase}: converged {converged}, true residual "
                           f"{true:.3e} after {res.n_iter} iterations")
    check_cheby_counts(phase, method, dtype, res.n_iter, counts,
                       cfg.restarts, device=device)
    _say(phase, method=method, dtype=dtype, tol=tol, n_iter=res.n_iter,
         converged=converged, final_relres=float(res.final_relres),
         true_relres=true, max_abs_x_minus_1=err, solve_s=round(secs, 3),
         launches=_launches(counts))
    return counts


def run_cheby_batched(prob32, prec, device: str = "cuda"):
    """`[cheby_batched]`: api.solve_batched with K_LANES float32 right-hand
    sides B[j] = A x_j (batched_rhs) at AB_TOL and the preconditioner: a
    ChebyOperator solves lane by lane, and each lane ends with its own
    p(A). Every lane converged, its true residual <= 100 tol."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve_batched
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    k, tol = K_LANES, AB_TOL
    B, _ = batched_rhs(prob32.csr, k)
    Bt = torch.as_tensor(B, dtype=torch.float32, device=prob32.A.device)
    cfg = SolverConfig(tol=tol, max_iter=CHEBY_MAX_ITER, dtype="float32")
    reset_counts()
    t0 = time.perf_counter()
    res = solve_batched(prob32.A, Bt, cfg=cfg, precond=prec)
    conv = res.converged.cpu().tolist()
    secs = time.perf_counter() - t0
    counts = read_counts()
    its = res.n_iter.tolist()
    true = float(res.true_relres.max())
    err0 = float((res.x[0].double() - 1.0).abs().max())
    if not (all(conv) and true <= 100 * tol):
        raise SmokeFailure(f"cheby_batched: converged {conv}, n_iter {its}, "
                           f"max true residual {true:.3e}")
    check_cheby_counts("cheby_batched", "bicgstab", "float32", sum(its),
                       counts, cfg.restarts, lanes=k, device=device)
    _say("cheby_batched", k=k, dtype="float32", tol=tol, n_iter=its,
         converged=conv, max_true_relres=true, max_abs_x0_minus_1=err0,
         solve_s=round(secs, 3), launches=_launches(counts))


def run_pipe_df32_ell(csr, b, it_dia: int, device: str = "cuda"):
    """`[pipe_df32_ell]`: df32 pipe_bicgstab on the ELL layout of csr (no
    Chebyshev) at `[pipe_df32]`'s tol: the fused DF body kernels once each
    per iteration and no DIA kernel (the ELL SpMV is PyTorch code),
    converged, true residual <= 100 tol, n_iter within 2 of the fully
    fused DIA route's it_dia."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.ops.layout import build_operator
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    tol = PATHS["pipe_df32"][2]
    A = build_operator(csr, format="ell", dtype="df32", device=device)
    reset_counts()
    t0 = time.perf_counter()
    res = solve(A, b, method="pipe_bicgstab",
                cfg=SolverConfig(tol=tol, dtype="df32"))
    converged = bool(res.converged)
    secs = time.perf_counter() - t0
    counts = read_counts()
    true = float(res.true_relres)
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        want.update(fused_body_a=res.n_iter, fused_body_b=res.n_iter)
    if not (converged and true <= 100 * tol
            and abs(res.n_iter - it_dia) <= 2 and counts == want):
        raise SmokeFailure(f"pipe_df32_ell: converged {converged}, true "
                           f"residual {true:.3e}, {res.n_iter} iterations "
                           f"(DIA route {it_dia}), launches {counts}")
    _say("pipe_df32_ell", method="pipe_bicgstab", dtype="df32", tol=tol,
         layout=type(A).__name__, n_iter=res.n_iter, dia_n_iter=it_dia,
         converged=converged, true_relres=true,
         max_abs_x_minus_1=float((_f64(res.x) - 1.0).abs().max()),
         solve_s=round(secs, 3), launches=_launches(counts))


def run_cheby_ab(probs: dict, prec) -> None:
    """`[cheby_ab]`: the plain and the preconditioned classic solve on the
    hard matrix at AB_TOL, AB_MAX_ITER and restarts 0 (the A/B of the
    JAX bench.py:443-476), in float32 and, when the plain float32 run
    does not converge, again in df32. Prints iterations, wall seconds,
    residuals and the speedup of each dtype tried; the last
    preconditioned solve must converge."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    for dtype in ("float32", "df32"):
        prob = probs[dtype]
        cfg = SolverConfig(tol=AB_TOL, max_iter=AB_MAX_ITER, dtype=dtype,
                           restarts=0)
        rows = {}
        for label, p in (("plain", None), ("cheby", prec)):
            t0 = time.perf_counter()
            res = solve(prob.A, prob.b, cfg=cfg, precond=p)
            conv = bool(res.converged)
            rows[label] = (res.n_iter, time.perf_counter() - t0, conv,
                           float(res.final_relres), float(res.true_relres))
        (pi, ps, pc, pf, pt), (ci, cs, cc_, cf, ct) = (rows["plain"],
                                                       rows["cheby"])
        _say("cheby_ab", dtype=dtype, tol=AB_TOL, restarts=0,
             plain_n_iter=pi, plain_converged=pc, plain_final_relres=pf,
             plain_true_relres=pt, plain_s=round(ps, 3), cheby_n_iter=ci,
             cheby_converged=cc_, cheby_true_relres=ct, cheby_s=round(cs, 3),
             iteration_ratio=round(pi / max(ci, 1), 3),
             speedup=round(ps / cs, 3))
        if pc:
            break
    if not cc_:
        raise SmokeFailure(f"cheby_ab: the preconditioned {dtype} solve "
                           f"did not converge: {rows['cheby']}")


def time_cheby(inp: dict, prec) -> None:
    """The chain kernels beside the unfused chain (bench_cheby, graph
    replays); the float32 chain kernel at degrees 1, 2, 4 and 8 (it reads
    the band once per degree, so the slope over the degree is one step's
    cost and the intercept the launch's and the barriers' rest); and the
    preconditioned float32 classic, df32 classic and df32 pipelined
    iterations (tol=0 chains through bench_iteration), eager and as
    replayed CUDA graphs, beside their floor 2 x (chain + DIA SpMV)
    bytes."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_cheby,
                                                          bench_iteration,
                                                          time_call)
    from mpi_bicgstab_tpu_torch.ops.cuda_cheby import cheby_chain
    lo, hi = inp["h_lo"], inp["h_hi"]
    for prob in (inp["h_prob32"], inp["h_probdf"]):
        r = bench_cheby(prob, lo, hi, degree=CHEBY_DEGREE)
        _say("times", cheby_apply=r["dtype"], degree=CHEBY_DEGREE,
             chain_kernel_ms=f"{r['cheby_fused_apply_s'] * 1e3:.4f}",
             unfused_chain_ms=f"{r['cheby_unfused_apply_s'] * 1e3:.4f}",
             chain_speedup=f"{r['cheby_fused_speedup']:.3f}")
    H = inp["H32"]
    band_ms = 4 * H.n_diags * H.n_rows / HBM_BYTES_PER_S * 1e3
    for d in (1, 2, 4, CHEBY_DEGREE):
        ms = time_call(lambda: cheby_chain(H.vals, inp["h_v"], H.offsets, d,
                                           lo, hi), iters=30, graph=True) * 1e3
        _say("times", kernel="cheby_chain", degree=d, ms=f"{ms:.4f}",
             ms_per_degree=f"{ms / d:.4f}",
             band_read_floor_ms_per_degree=f"{band_ms:.4f}")
    spmv_bytes = 4 * (H.n_diags * H.n_rows + 2 * H.n_rows)
    nbytes = 2 * (work("cheby_chain", inp)[0] + spmv_bytes)
    for dtype, method, iters in (("float32", "bicgstab", 60),
                                 ("df32", "bicgstab", 30),
                                 ("df32", "pipe_bicgstab", 30)):
        prob = inp["h_prob32" if dtype == "float32" else "h_probdf"]
        kw = dict(method=method, iters=iters, precond=prec)
        eager = bench_iteration(prob, **kw)
        dev = bench_iteration(prob, graph=True, **kw)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        floor = nbytes * (1 if dtype == "float32" else 2)
        _say("times", method=f"{method}+cheby:{CHEBY_DEGREE}", dtype=dtype,
             eager_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain=f"tol=0x{iters}",
             bound_ms_per_iter=f"{floor / HBM_BYTES_PER_S * 1e3:.4f}",
             bytes_per_iter=floor)


# --- windowed-ELL (slice 6b) and the reorder path (slice 6a) ----------------

def window_inputs(csr, device="cuda", seed=0) -> dict:
    """The window kernels' inputs at the path's shapes: the layout of csr
    built once on the host in float64 (its seconds in "w_build_s") and
    cast to float32, float64 and DF pairs, and x from a NumPy generator
    seeded `seed`."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    from mpi_bicgstab_tpu_torch.ops.window_ell import (
        csr_to_window_ell, window_ell_with_values)
    t0 = time.perf_counter()
    host = csr_to_window_ell(csr, device="cpu")
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(seed).standard_normal(csr.nrows)
    return {"w_csr": csr, "w_build_s": build_s,
            "W32": window_ell_with_values(host, torch.float32, device),
            "W64": window_ell_with_values(host, torch.float64, device),
            "Wdf": window_ell_with_values(host, "df32", device),
            "wx32": torch.as_tensor(x, dtype=torch.float32, device=device),
            "wx64": torch.as_tensor(x, device=device),
            "wxdf": df_from_f64(x, device)}


def window_kernel_calls(inp: dict) -> dict:
    """The window kernels (the slab part of y = A x) beside their twins,
    as kernel_calls gives them; both must agree bit for bit."""
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    from mpi_bicgstab_tpu_torch.ops import window_spmv as wsp
    W32, W64, Wdf = inp["W32"], inp["W64"], inp["Wdf"]
    x32, x64, xdf = inp["wx32"], inp["wx64"], inp["wxdf"]
    return {
        "window_spmv_f32": (lambda: (cws.window_slabs(W32, x32),),
                            lambda: (wsp.window_slabs_plain(W32, x32),),
                            "bit_equal"),
        "window_spmv_f64": (lambda: (cws.window_slabs(W64, x64),),
                            lambda: (wsp.window_slabs_plain(W64, x64),),
                            "bit_equal"),
        "window_spmv_df": (lambda: (cws.window_slabs_df(Wdf, xdf),),
                           lambda: (wsp.window_slabs_df_plain(Wdf, xdf),),
                           "bit_equal")}


def check_window_spmv(inp: dict) -> float:
    """The whole float64 SpMV (kernel plus tail) against torch's CSR
    product on the card: within 1e-12 of the product's largest entry.
    Returns the relative error."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    y = spmv(inp["W64"], inp["wx64"])
    ref = torch_csr(inp["w_csr"], inp["wx64"].dtype, y.device) @ inp["wx64"]
    rel = _err(y, ref) / float(ref.abs().max())
    if not rel <= 1e-12:
        raise SmokeFailure(f"window SpMV with its tail: {rel:.3e} from the "
                           f"CSR product, relative (> 1e-12)")
    return rel


def window_work(name: str, inp: dict) -> tuple[float, float, str]:
    """(bytes, flops, dtype) of the slab part of y = A x: every slot's
    value, lane_idx and sub_sel, the window bases and x read once, y
    written once; operations on the slots that hold an entry of this
    matrix (the padding multiplies zeros)."""
    W = inp["W32"]
    slots = W.width * W.n_rows
    held = inp["w_csr"].nnz - sum(W.tail_counts)
    elem = 4 if name == "window_spmv_f32" else 8
    nbytes = slots * (elem + 2) + 4 * W.n_tiles + (W.n_cols + W.n_rows) * elem
    if name == "window_spmv_df":
        return nbytes, (DF_MUL_FLOPS + DF_ADD_FLOPS) * held, "df32"
    return nbytes, 2 * held, "float32" if elem == 4 else "float64"


def check_window_counts(what: str, method: str, dtype: str, it: int,
                        counts: dict, restarts: int,
                        device: str = "cuda") -> None:
    """The launches of a converged solve on the window layout: the window
    SpMV kernel (its DF form in df32) twice per iteration and, per solver
    segment, for r0 and the true residual (pipe_bicgstab also w0 and
    t0); df32 pipe_bicgstab its two body kernels once per iteration;
    nothing else. On the CPU nothing at all."""
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        spmv = "window_slabs_df" if dtype == "df32" else "window_slabs"
        if method == "pipe_bicgstab" and dtype == "df32":
            want.update(fused_body_a=it, fused_body_b=it)
        segs, rest = divmod(counts[spmv] - 2 * it,
                            4 if method == "pipe_bicgstab" else 2)
        if rest == 0 and 1 <= segs <= restarts + 1:
            want[spmv] = counts[spmv]
    if counts != want:
        raise SmokeFailure(f"{what}: launches {counts} do not fit {it} "
                           f"iterations of {method} {dtype} on the window "
                           f"layout")


def _layout_problems(csr, layouts: dict, device: str) -> dict:
    """Problems (b = A 1 from the host CSR, x0 = 0) over `layouts` (dtype
    -> operator) and over gather-ELL layouts of the same CSR, by dtype:
    {"float32": (layout, ell), ...}."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.models.problem import Problem
    from mpi_bicgstab_tpu_torch.ops.layout import build_operator
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, vzeros_like
    b_host = csr.matvec(np.ones(csr.nrows))
    out = {}
    for dtype, A in layouts.items():
        b = (df_from_f64(b_host, device) if dtype == "df32" else
             torch.as_tensor(b_host, dtype=getattr(torch, dtype),
                             device=device))
        ell = build_operator(csr, format="ell", device=device,
                             dtype=dtype if dtype == "df32"
                             else getattr(torch, dtype))
        out[dtype] = tuple(Problem(csr, op, b, vzeros_like(b), csr.nrows)
                           for op in (A, ell))
    return out


def window_problems(inp: dict, device: str = "cuda") -> dict:
    """Problems over the window layouts of window_inputs and over
    gather-ELL layouts of the same CSR, by dtype (_layout_problems)."""
    return _layout_problems(inp["w_csr"], {"float32": inp["W32"],
                                           "float64": inp["W64"],
                                           "df32": inp["Wdf"]}, device)


def _ell_iters(prob, method: str, dtype: str, tol: float) -> int:
    """n_iter of the same solve on gather-ELL (the plain PyTorch gather
    SpMV); it must converge."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    res = solve(prob.A, prob.b, method=method,
                cfg=SolverConfig(tol=tol, dtype=dtype))
    if not bool(res.converged):
        raise SmokeFailure(f"{method} {dtype} on gather-ELL did not "
                           f"converge: n_iter {res.n_iter}")
    return res.n_iter


def run_window_cli(n: int, ell_prob, device: str = "cuda") -> dict:
    """`[window]`: `solve --matrix clustered:n --dtype float32 --tol 1e-6`
    through the CLI's own code with its defaults (--format auto, --reorder
    auto), counted as run_main_path: the WindowEllMatrix route,
    converged, max|x-1| < 1e-3, the launches of check_window_counts, and
    n_iter within 2 of the same solve on gather-ELL. Returns the
    counts."""
    from mpi_bicgstab_tpu_torch import cli
    args = cli.build_parser().parse_args(
        ["solve", "--matrix", f"clustered:{n}", "--dtype", "float32",
         "--tol", str(WINDOW_TOL), "--device", device])
    reset_counts()
    report, res = cli.run_solve(args)
    counts = read_counts()
    err = float((res.x.double() - 1.0).abs().max())
    it = report["total_iter"]
    ell_it = _ell_iters(ell_prob, "bicgstab", "float32", WINDOW_TOL)
    if not (report["converged"] and report["layout"] == "WindowEllMatrix"
            and err < 1e-3 and abs(it - ell_it) <= 2):
        raise SmokeFailure(f"window: {report}, max|x-1| {err:.3e}, "
                           f"gather-ELL n_iter {ell_it}")
    check_window_counts("window", "bicgstab", "float32", it, counts,
                        args.restarts, device)
    _say("window", method="bicgstab", dtype="float32", tol=WINDOW_TOL,
         layout=report["layout"], n=report["n"], nnz=report["nnz"],
         reordered=report["reordered"], n_iter=it, ell_n_iter=ell_it,
         converged=report["converged"], final_relres=report["final_relres"],
         true_relres=report["true_relres"], max_abs_x_minus_1=err,
         io_time_s=report["io_time_s"], setup_s=report["setup_s"],
         solve_s=report["total_time_s"], launches=_launches(counts))
    return counts


def _run_layout_api(phase: str, method: str, dtype: str, tol: float,
                    pair: tuple, check_counts, device: str) -> dict:
    """api.solve on pair's layout problem, every launch counter set to 0
    just before and read just after: converged, max|x-1| < 1e-6, the
    launches check_counts allows, n_iter within 2 of the same solve on
    pair's gather-ELL problem. Returns the counts."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    prob, ell = pair
    cfg = SolverConfig(tol=tol, dtype=dtype)
    reset_counts()
    t0 = time.perf_counter()
    res = solve(prob.A, prob.b, method=method, cfg=cfg)
    converged = bool(res.converged)
    secs = time.perf_counter() - t0
    counts = read_counts()
    err = float((_f64(res.x) - 1.0).abs().max())
    ell_it = _ell_iters(ell, method, dtype, tol)
    if not (converged and err < 1e-6 and abs(res.n_iter - ell_it) <= 2):
        raise SmokeFailure(f"{phase}: converged {converged}, max|x-1| "
                           f"{err:.3e}, {res.n_iter} iterations (gather-ELL "
                           f"{ell_it})")
    check_counts(phase, method, dtype, res.n_iter, counts, cfg.restarts,
                 device)
    _say(phase, method=method, dtype=dtype, tol=tol, n_iter=res.n_iter,
         ell_n_iter=ell_it, converged=converged,
         final_relres=float(res.final_relres),
         true_relres=float(res.true_relres), max_abs_x_minus_1=err,
         solve_s=round(secs, 3), launches=_launches(counts))
    return counts


def run_window_api(phase: str, probs: dict, device: str = "cuda") -> dict:
    """One of WINDOW_PATHS through api.solve on the window problem of its
    dtype (_run_layout_api, with check_window_counts). Returns the
    counts."""
    method, dtype, tol = WINDOW_PATHS[phase]
    return _run_layout_api(phase, method, dtype, tol, probs[dtype],
                           check_window_counts, device)


def shuffled_banded(n: int):
    """banded_random(n, REORDER_OFFSETS, seed=3) in the order of
    default_rng(7).permutation(n)."""
    import numpy as np

    from mpi_bicgstab_tpu_torch.models.generators import banded_random
    from mpi_bicgstab_tpu_torch.ops.reorder import permute_csr
    seed, shuffle = REORDER_SEEDS
    return permute_csr(banded_random(n, REORDER_OFFSETS, seed=seed),
                       np.random.default_rng(shuffle).permutation(n))


def run_reorder_path(n: int, device: str = "cuda") -> dict:
    """`[reorder]`: the shuffled band written to an .npz in a temporary
    directory, then `solve --matrix X.npz --dtype float64 --tol 1e-10
    --write-solution x.npy` with the CLI defaults (--reorder auto):
    reordered, the DIA or hybrid route (the float64 DIA SpMV kernel and
    no window kernel; an ELL remainder is PyTorch code), converged, and
    the written solution (original order) within 1e-6 of ones. Returns
    the counts."""
    import tempfile

    import numpy as np

    from mpi_bicgstab_tpu_torch import cli
    t0 = time.perf_counter()
    csr = shuffled_banded(n)
    with tempfile.TemporaryDirectory() as tmp:
        path, xpath = Path(tmp) / "shuffled.npz", Path(tmp) / "x.npy"
        np.savez(path, ptr=csr.ptr, col=csr.col, val=csr.val,
                 shape=np.array(csr.shape))
        write_s = time.perf_counter() - t0
        args = cli.build_parser().parse_args(
            ["solve", "--matrix", str(path), "--dtype", "float64", "--tol",
             "1e-10", "--write-solution", str(xpath), "--device", device])
        reset_counts()
        report, _ = cli.run_solve(args)
        counts = read_counts()
        err = float(np.abs(np.load(xpath) - 1.0).max())
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        want["dia_spmv"] = counts["dia_spmv"]
    if not (report["converged"] and report["reordered"] and err < 1e-6
            and report["layout"] in ("DiaMatrix", "HybridMatrix")
            and counts == want
            and (device == "cpu"
                 or counts["dia_spmv"] >= 2 * report["total_iter"])):
        raise SmokeFailure(f"reorder: {report}, max|x-1| {err:.3e}, "
                           f"launches {counts}")
    _say("reorder", matrix="shuffled banded_random", n=report["n"],
         nnz=report["nnz"], reordered=report["reordered"],
         layout=report["layout"], dtype="float64", tol=1e-10,
         n_iter=report["total_iter"], converged=report["converged"],
         true_relres=report["true_relres"],
         max_abs_written_x_minus_1=err, io_time_s=report["io_time_s"],
         write_s=round(write_s, 3), setup_s=report["setup_s"],
         solve_s=report["total_time_s"],
         launches=_launches(counts))
    return counts


def time_routing(csr) -> None:
    """The host seconds of the two analyses the CLI's defaults run on a
    DIA matrix before its build (both inside every CLI phase's
    setup_s): maybe_reorder(csr, 'auto'), which keeps the ordering, and
    the 'auto' route decided on the matrix padded to 1024."""
    from mpi_bicgstab_tpu_torch.models.problem import pad_csr_identity
    from mpi_bicgstab_tpu_torch.ops.layout import auto_route
    from mpi_bicgstab_tpu_torch.ops.reorder import maybe_reorder
    t0 = time.perf_counter()
    _, perm = maybe_reorder(csr, "auto")
    t1 = time.perf_counter()
    route, _ = auto_route(pad_csr_identity(csr, 1024))
    t2 = time.perf_counter()
    if perm is not None or route != "hybrid":
        raise SmokeFailure(f"transport_like: reordered {perm is not None}, "
                           f"route {route}")
    _say("times", matrix="transport_like", n=csr.nrows,
         reorder_auto_host_s=round(t1 - t0, 3),
         route_padded_host_s=round(t2 - t1, 3))


def time_window(inp: dict, probs: dict) -> None:
    """The f32 and df32 classic iteration on the window layout (tol=0
    chains through bench_iteration, eager and as replayed CUDA graphs)
    beside 2 x the window SpMV's bytes, and the SpMV rate of
    bench_spmv."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_iteration,
                                                          bench_spmv)
    sp = bench_spmv(probs["float32"][0])
    _say("times", spmv_layout=sp["spmv_layout"],
         spmv_window_width=sp["spmv_window_width"],
         spmv_f32_nnz_per_s=f"{sp['spmv_nnz_per_s']:.4e}",
         window_build_host_s=round(inp["w_build_s"], 3))
    for dtype, name, iters in (("float32", "window_spmv_f32", 60),
                               ("df32", "window_spmv_df", 30)):
        prob = probs[dtype][0]
        eager = bench_iteration(prob, iters=iters)
        dev = bench_iteration(prob, iters=iters, graph=True)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        floor = 2 * window_work(name, inp)[0]
        _say("times", method="bicgstab", layout="WindowEllMatrix",
             dtype=dtype, eager_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain=f"tol=0x{iters}",
             two_spmv_bound_ms=f"{floor / HBM_BYTES_PER_S * 1e3:.4f}")


# --- the butterfly layout (slice 6c) ----------------------------------------

def uniform_csr(n: int):
    """uniform:n as the CLI builds it: random_diag_dominant(n, 8 nonzeros
    a row, seed 0), padded to a multiple of 1024 with identity rows."""
    from mpi_bicgstab_tpu_torch.models.generators import random_diag_dominant
    from mpi_bicgstab_tpu_torch.models.problem import pad_csr_identity
    return pad_csr_identity(random_diag_dominant(n, nnz_per_row=8, seed=0),
                            1024)


def butterfly_inputs(csr, device="cuda", seed=0) -> dict:
    """The butterfly kernels' inputs at the path's shapes: the layout of
    csr routed once on the host in float64 (its seconds in "b_build_s")
    and cast to float32, float64 and DF pairs; x from a NumPy generator
    seeded `seed`; and each stage's input as the twins route x: mid (K2's
    input, T1 of K1's output) and z (K3's), per dtype, DF as packed
    pairs."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import native_route
    from mpi_bicgstab_tpu_torch.ops.butterfly import (build_butterfly,
                                                      butterfly_with_values)
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    t0 = time.perf_counter()
    host = build_butterfly(csr, device="cpu")
    build_s = time.perf_counter() - t0
    if native_route.library.cache_info().currsize != 1:
        raise SmokeFailure("the butterfly build did not load the native "
                           "route assigner")
    x = np.random.default_rng(seed).standard_normal(csr.nrows)
    inp = {"b_csr": csr, "b_build_s": build_s,
           "B32": butterfly_with_values(host, torch.float32, device),
           "B64": butterfly_with_values(host, torch.float64, device),
           "Bdf": butterfly_with_values(host, "df32", device),
           "bx32": torch.as_tensor(x, dtype=torch.float32, device=device),
           "bx64": torch.as_tensor(x, device=device),
           "bxdf": df_from_f64(x, device)}
    for sfx, B, v in (("32", inp["B32"], inp["bx32"]),
                      ("64", inp["B64"], inp["bx64"]),
                      ("df", inp["Bdf"], bs.pack_df(inp["bxdf"]))):
        inp["bv" + sfx] = v
        inp["bmid" + sfx] = bs.transpose(B, bs.k1_plain(B, v))
        inp["bz" + sfx] = bs.transpose(B, bs.k2_plain(B, inp["bmid" + sfx]))
    return inp


def butterfly_kernel_calls(inp: dict) -> dict:
    """Kernels 25-28 in every dtype the path runs them (K1, K2 move a
    DF vector's packed pairs; K3 DF reads them) beside their twins, on
    the stage inputs of butterfly_inputs; each must equal its twin bit
    for bit."""
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    calls = {}
    for sfx, key in (("f32", "32"), ("f64", "64"), ("df", "df")):
        B, v, mid, z = (inp[k + key] for k in ("B", "bv", "bmid", "bz"))
        calls[f"butterfly_k1_{sfx}"] = (
            lambda B=B, v=v: (cbf.butterfly_k1(B, v),),
            lambda B=B, v=v: (bs.k1_plain(B, v),), "bit_equal")
        calls[f"butterfly_k2_{sfx}"] = (
            lambda B=B, m=mid: (cbf.butterfly_k2(B, m),),
            lambda B=B, m=mid: (bs.k2_plain(B, m),), "bit_equal")
        k3, k3_plain = ((cbf.butterfly_k3_df, bs.k3_df_plain) if sfx == "df"
                        else (cbf.butterfly_k3, bs.k3_plain))
        calls[f"butterfly_k3_{sfx}"] = (
            lambda B=B, z=z, f=k3: (f(B, z),),
            lambda B=B, z=z, f=k3_plain: (f(B, z),), "bit_equal")
    return calls


def check_butterfly_spmv(inp: dict) -> float:
    """The whole float64 SpMV (stages, transposes, tail) against torch's
    CSR product on the card: within 1e-12 of the product's largest
    entry. Returns the relative error."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    y = spmv(inp["B64"], inp["bx64"])
    ref = torch_csr(inp["b_csr"], inp["bx64"].dtype, y.device) @ inp["bx64"]
    rel = _err(y, ref) / float(ref.abs().max())
    if not rel <= 1e-12:
        raise SmokeFailure(f"butterfly SpMV with its tail: {rel:.3e} from "
                           f"the CSR product, relative (> 1e-12)")
    return rel


def butterfly_work(name: str, inp: dict) -> tuple[float, float, str]:
    """(bytes, flops, dtype) of one stage: K1 its two int8 tables, k1_src,
    x and u1; K2 the tables, mid and z1; K3 its three slab tables, the z
    windows its rows read (n_pad / rb of them) and y; each read or written
    once; an element of 4 bytes in float32, 8 in float64 and DF (a packed
    pair). Operations: K3's entries held in the slabs (2 each, a df_fma
    in DF); K1 and K2 only move data. "butterfly_spmv_*" is the whole
    SpMV: the three stages, the two transposes (each element read and
    written) and the tail (values, rows, columns, the x it reads, y's
    rows read and written)."""
    B = inp["B32"]
    slots, e = B.P * 1024, (4 if name.endswith("f32") else 8)
    k1 = 2 * slots + 4 * B.P + e * B.n_cols + e * slots
    k2 = 2 * slots + 2 * e * slots
    k3 = (2 + e) * B.width * B.n_pad + e * (B.n_pad // B.rb) * 1024 \
        + e * B.n_pad
    held = inp["b_csr"].nnz - B.tail_n
    flops = (DF_FMA_FLOPS if name.endswith("df") else 2) * held
    dt = {"f32": "float32", "f64": "float64", "df": "df32"}[
        name.rsplit("_", 1)[1]]
    if name.startswith("butterfly_k1"):
        return k1, 0, dt
    if name.startswith("butterfly_k2"):
        return k2, 0, dt
    if name.startswith("butterfly_k3"):
        return k3, flops, dt
    tail = B.tail_n * (e + 8 + 3 * e)
    return k1 + k2 + k3 + 2 * 2 * e * slots + tail, flops, dt


def check_butterfly_counts(what: str, method: str, dtype: str, it: int,
                           counts: dict, restarts: int,
                           device: str = "cuda") -> None:
    """The launches of a converged solve on the butterfly layout: per
    SpMV one K1, one K2 and one K3 (its DF form in df32; K1 and K2 move
    the packed pairs in one launch each), twice per iteration and, per
    solver segment, for r0 and the true residual (pipe_bicgstab also w0
    and t0); df32 pipe_bicgstab its two body kernels once per iteration;
    nothing else. On the CPU nothing at all."""
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        k3 = "butterfly_k3_df" if dtype == "df32" else "butterfly_k3"
        if method == "pipe_bicgstab" and dtype == "df32":
            want.update(fused_body_a=it, fused_body_b=it)
        spmvs = counts[k3]
        segs, rest = divmod(spmvs - 2 * it,
                            4 if method == "pipe_bicgstab" else 2)
        if rest == 0 and 1 <= segs <= restarts + 1:
            want.update({k3: spmvs, "butterfly_k1": spmvs,
                         "butterfly_k2": spmvs})
    if counts != want:
        raise SmokeFailure(f"{what}: launches {counts} do not fit {it} "
                           f"iterations of {method} {dtype} on the "
                           f"butterfly layout")


def butterfly_problems(inp: dict, device: str = "cuda") -> dict:
    """Problems (b = A 1 from the host CSR, x0 = 0) over the butterfly
    layouts of butterfly_inputs and over gather-ELL layouts of the same
    CSR, by dtype: {"float32": (butterfly, ell), ...}."""
    return _layout_problems(inp["b_csr"], {"float32": inp["B32"],
                                           "float64": inp["B64"],
                                           "df32": inp["Bdf"]}, device)


def dominance_margin(csr) -> float:
    """min_i (|a_ii| - sum_{j != i} |a_ij|): for a strictly diagonally
    dominant A, ||e||_inf <= ||A e||_inf / margin (Varah's bound)."""
    import numpy as np
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
    diag = rows == csr.col
    a = np.abs(csr.val)
    off = np.bincount(rows[~diag], a[~diag], minlength=csr.nrows)
    return float((np.bincount(rows[diag], a[diag], minlength=csr.nrows)
                  - off).min())


def run_butterfly_cli(n: int, ell_prob, device: str = "cuda") -> dict:
    """`[butterfly]`: `solve --matrix uniform:n --dtype float32 --tol
    1e-6` through the CLI's own code with its defaults (--format auto,
    --reorder auto), counted as run_main_path: the ButterflyMatrix route,
    converged, the launches of check_butterfly_counts, and n_iter within
    2 of the same solve on gather-ELL. The solution is held to its
    residual, computed apart from the butterfly kernels with torch's
    float64 CSR product on ell_prob's CSR (the same padded matrix): the
    relative residual within 10 tol, and max|x - 1| within the bound that
    residual allows (Varah: ||r||_inf / dominance_margin). (At tol 1e-6
    the stopping rule leaves max|x - 1| ~1e-3 on this matrix at n = 1.6M
    in float32, growing with n; the JAX package's solves leave the same
    error as the port's, tests/test_torch_butterfly.py.) Returns the
    counts."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch import cli
    args = cli.build_parser().parse_args(
        ["solve", "--matrix", f"uniform:{n}", "--dtype", "float32",
         "--tol", str(UNIFORM_TOL), "--device", device])
    reset_counts()
    report, res = cli.run_solve(args)
    counts = read_counts()
    csr = ell_prob.csr
    if report["reordered"] or res.x.shape != (csr.nrows,):
        raise SmokeFailure(f"butterfly: {report}: not the padded "
                           f"uniform:{n} (x {tuple(res.x.shape)})")
    exact = np.zeros(csr.nrows)
    exact[: report["n"]] = 1.0        # the identity pad rows' solution: 0
    A = torch_csr(csr, torch.float64, res.x.device)
    e = torch.as_tensor(exact, device=res.x.device)
    x = res.x.double()
    b = A @ e
    r = A @ x - b
    relres = float(r.norm() / b.norm())
    margin = dominance_margin(csr)
    bound = float(r.abs().max()) / margin
    err = float((x - e).abs().max())
    it = report["total_iter"]
    ell_it = _ell_iters(ell_prob, "bicgstab", "float32", UNIFORM_TOL)
    if not (report["converged"] and report["layout"] == "ButterflyMatrix"
            and relres <= 10 * UNIFORM_TOL and err <= bound
            and abs(it - ell_it) <= 2):
        raise SmokeFailure(f"butterfly: {report}, max|x-1| {err:.3e} "
                           f"(bound {bound:.3e}), CSR relres {relres:.3e}, "
                           f"gather-ELL n_iter {ell_it}")
    check_butterfly_counts("butterfly", "bicgstab", "float32", it, counts,
                           args.restarts, device)
    _say("butterfly", method="bicgstab", dtype="float32", tol=UNIFORM_TOL,
         layout=report["layout"], n=report["n"], nnz=report["nnz"],
         reordered=report["reordered"], n_iter=it, ell_n_iter=ell_it,
         converged=report["converged"], final_relres=report["final_relres"],
         true_relres=report["true_relres"], csr_f64_relres=f"{relres:.3e}",
         max_abs_x_minus_1=err, varah_bound=f"{bound:.3e}",
         dominance_margin=margin, io_time_s=report["io_time_s"],
         setup_s=report["setup_s"], solve_s=report["total_time_s"],
         launches=_launches(counts))
    return counts


def run_butterfly_api(phase: str, probs: dict, device: str = "cuda") -> dict:
    """One of BUTTERFLY_PATHS through api.solve on the butterfly problem
    of its dtype, counted as run_window_api: converged, max|x-1| < 1e-6,
    the launches of check_butterfly_counts, n_iter within 2 of
    gather-ELL's. Returns the counts."""
    method, dtype, tol = BUTTERFLY_PATHS[phase]
    return _run_layout_api(phase, method, dtype, tol, probs[dtype],
                           check_butterfly_counts, device)


def time_butterfly(inp: dict, probs: dict) -> None:
    """The whole SpMV (float32, float64 and DF; replayed CUDA graphs)
    beside its bound and torch's CSR product, the two transposes in each
    element size, the route build's host seconds, and the f32 and df32
    classic iterations on the butterfly layout (tol=0 chains, eager and
    as replayed CUDA graphs) beside two SpMVs' bytes."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_iteration,
                                                          bench_spmv,
                                                          time_call)
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    sp = bench_spmv(probs["float32"][0])
    _say("times", spmv_layout=sp["spmv_layout"],
         spmv_butterfly_P=sp["spmv_butterfly_P"],
         spmv_butterfly_width=sp["spmv_butterfly_width"],
         spmv_f32_nnz_per_s=f"{sp['spmv_nnz_per_s']:.4e}",
         butterfly_route_host_s=round(inp["b_build_s"], 3))
    csr = inp["b_csr"]
    for sfx, key in (("f32", "32"), ("f64", "64"), ("df", "df")):
        B, x, mid = inp["B" + key], inp["bx" + key], inp["bmid" + key]
        bound = butterfly_work(f"butterfly_spmv_{sfx}", inp)[0] \
            / HBM_BYTES_PER_S * 1e3
        t_bound = 2 * mid.element_size() * mid.numel() \
            / HBM_BYTES_PER_S * 1e3
        ms = time_call(lambda B=B, x=x: spmv(B, x), graph=True) * 1e3
        t_ms = time_call(lambda B=B, m=mid: bs.transpose(B, m),
                         graph=True) * 1e3
        lib = None
        if sfx != "df":
            A = torch_csr(csr, x.dtype, x.device)
            lib = time_call(lambda A=A, x=x: A @ x) * 1e3
        _say("times", butterfly_spmv=sfx, ms=f"{ms:.4f}",
             bound_ms=f"{bound:.4f}", bound_share=f"{bound / ms:.3f}",
             transpose_ms=f"{t_ms:.4f}", transpose_bound_ms=f"{t_bound:.4f}",
             torch_csr_ms=None if lib is None else f"{lib:.4f}",
             butterfly_over_csr=None if lib is None else f"{ms / lib:.3f}")
    for dtype, sfx, iters in (("float32", "f32", 60), ("df32", "df", 30)):
        prob = probs[dtype][0]
        eager = bench_iteration(prob, iters=iters)
        dev = bench_iteration(prob, iters=iters, graph=True)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        floor = 2 * butterfly_work(f"butterfly_spmv_{sfx}", inp)[0]
        _say("times", method="bicgstab", layout="ButterflyMatrix",
             dtype=dtype, eager_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain=f"tol=0x{iters}",
             two_spmv_bound_ms=f"{floor / HBM_BYTES_PER_S * 1e3:.4f}")


def main() -> int:
    import gc

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_iteration,
                                                          bench_spmv)
    from mpi_bicgstab_tpu_torch.models.generators import (clustered_random,
                                                          transport_hard,
                                                          transport_like)
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops import native_route
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    from mpi_bicgstab_tpu_torch.solvers.switching_blocked import \
        resolve_block
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig

    t_start = time.perf_counter()
    smi = probe()
    build()

    t0 = time.perf_counter()
    csr = transport_like(N_MAIN)
    inp = kernel_inputs(csr)
    _say("check", n=csr.nrows, nnz=csr.nnz, W=inp["A32"].n_diags,
         max_offset=max(abs(o) for o in inp["A32"].offsets),
         host_setup_s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    csr_h = transport_hard(N_HARD)
    prob64h = build_problem(csr_h, dtype=torch.float64, multiple=1)
    inp.update(cheby_inputs(prob64h))
    _say("check", matrix="transport_hard", n=csr_h.nrows, nnz=csr_h.nnz,
         W=inp["H32"].n_diags,
         max_offset=max(abs(o) for o in inp["H32"].offsets),
         bounds=f"[{inp['h_lo']},{inp['h_hi']}]", degree=CHEBY_DEGREE,
         host_setup_s=round(time.perf_counter() - t0, 3))
    calls = kernel_calls(inp)
    errs = check_kernels(calls, inp)
    check_frozen_lanes(calls, inp)
    errs["shift_update_df"], su_row = check_shift_update(csr.nrows)
    gc.collect()
    torch.cuda.empty_cache()
    # windowed-ELL: the layout built once on the host, in three dtypes
    t0 = time.perf_counter()
    csr_w = clustered_random(N_WINDOW)
    winp = window_inputs(csr_w)
    W = winp["W32"]
    _say("check", matrix="clustered_random", n=csr_w.nrows, nnz=csr_w.nnz,
         W=W.width, tiles=W.n_tiles, tail_counts=list(W.tail_counts),
         slots=W.width * W.n_rows,
         window_build_host_s=round(winp["w_build_s"], 3),
         host_setup_s=round(time.perf_counter() - t0, 3))
    wcalls = window_kernel_calls(winp)
    errs.update(check_kernels(wcalls, winp))
    _say("check", window_spmv_f64_with_tail_vs_torch_csr_rel_err=(
        f"{check_window_spmv(winp):.3e}"))
    # the butterfly layout: routed once on the host, in three dtypes
    t0 = time.perf_counter()
    csr_u = uniform_csr(N_UNIFORM)
    binp = butterfly_inputs(csr_u)
    B = binp["B32"]
    _say("check", matrix="random_diag_dominant", n=csr_u.nrows,
         nnz=csr_u.nnz, route_host_s=round(binp["b_build_s"], 3), P=B.P,
         G=B.G, rb=B.rb, W=B.width, n_pad=B.n_pad, nc_pad=B.nc_pad,
         tail_n=B.tail_n, tail_levels=B.tail_rows.shape[0],
         router=native_route.lib_path(),
         host_setup_s=round(time.perf_counter() - t0, 3))
    bcalls = butterfly_kernel_calls(binp)
    errs.update(check_kernels(bcalls, binp))
    _say("check", butterfly_spmv_f64_with_tail_vs_torch_csr_rel_err=(
        f"{check_butterfly_spmv(binp):.3e}"))

    runs, iters = {}, {}
    for phase, (method, dtype, tol, extra) in PATHS.items():
        report, counts, err = run_main_path(N_MAIN, dtype, tol,
                                            method=method, extra=extra)
        runs[phase], iters[phase] = counts, report["total_iter"]
        _say(phase, method=method, dtype=dtype, tol=tol,
             converged=report["converged"], n_iter=report["total_iter"],
             final_relres=report["final_relres"],
             true_relres=report["true_relres"], max_abs_x_minus_1=err,
             setup_s=report["setup_s"], solve_s=report["total_time_s"],
             launches=json.dumps(counts).replace(" ", ""))
    if abs(iters["df32"] - iters["f64"]) > 2:
        raise SmokeFailure(f"df32 classic took {iters['df32']} iterations, "
                           f"f64 {iters['f64']}: more than 2 apart")
    probdf = build_problem(csr, dtype="df32", multiple=1)
    for phase in ("ca_df32", "pipe_df32", "pipe_rr_df32"):
        k, conv = unfused_df_iters(probdf, phase)
        _say(phase, fused_n_iter=iters[phase], unfused_n_iter=k,
             unfused_converged=conv)
        if abs(iters[phase] - k) > 2:
            raise SmokeFailure(f"{phase}: the fused DF driver took "
                               f"{iters[phase]} iterations, the unfused DF "
                               f"solver {k}: more than 2 apart")
    run_pipe_df32_ell(csr, probdf.b, iters["pipe_df32"])

    # batched right-hand sides: the fused batched route, then lane by lane
    runs["batched"] = run_batched_path(N_MAIN, A32=inp["A32"])
    for dtype in ("float64", "df32"):
        run_batched_lanes(N_MAIN, dtype)
    gc.collect()
    torch.cuda.empty_cache()

    # Chebyshev preconditioning on the hard matrix
    prec = ChebyPrecond(CHEBY_DEGREE, inp["h_lo"], inp["h_hi"])
    runs["cheby"] = run_cheby_cli(N_HARD)
    probs_h = {"float32": inp["h_prob32"], "df32": inp["h_probdf"],
               "float64": prob64h}
    for phase in CHEBY_PATHS:
        runs[phase] = run_cheby_api(phase, probs_h, prec)
    run_cheby_batched(inp["h_prob32"], prec)
    run_cheby_ab(probs_h, prec)
    del prob64h, probs_h
    gc.collect()
    torch.cuda.empty_cache()

    # windowed-ELL solves, each beside gather-ELL; the reorder path
    wprobs = window_problems(winp)
    runs["window"] = run_window_cli(N_WINDOW, wprobs["float32"][1])
    for phase in WINDOW_PATHS:
        runs[phase] = run_window_api(phase, wprobs)
    runs["reorder"] = run_reorder_path(N_MAIN)
    gc.collect()
    torch.cuda.empty_cache()

    # butterfly solves, each beside gather-ELL
    bprobs = butterfly_problems(binp)
    runs["butterfly"] = run_butterfly_cli(N_UNIFORM, bprobs["float32"][1])
    for phase in BUTTERFLY_PATHS:
        runs[phase] = run_butterfly_api(phase, bprobs)
    gc.collect()
    torch.cuda.empty_cache()

    # the shifted family on the flagship ladder
    ss = float(flagship_ladder()[SEED_MAIN])
    A64 = inp["A64"]
    b64 = torch.as_tensor(csr.matvec(np.ones(csr.nrows)) + ss,
                          device="cuda")
    L = resolve_block(ShiftedConfig(dtype="float32"),
                      torch.ones(1, device="cuda"), S_MAIN)
    if L != 64:
        raise SmokeFailure(f"float32 switching on the card takes L = {L}, "
                           f"not the blocked L = 64")
    _say("shifted_f32", blocked_L=L)
    for phase in SHIFTED_PATHS:
        runs[phase] = run_shifted_path(phase, A64, b64)[1]
    prob32s = build_problem(csr, dtype=torch.float32, multiple=1,
                            sigma_seed=ss)
    run_refine_path(prob32s, A64, b64)
    prob64s = build_problem(csr, dtype=torch.float64, multiple=1,
                            sigma_seed=ss)
    run_other_shifted_methods(prob64s, A64, b64)
    run_checkpoint_path()

    prob32 = build_problem(csr, dtype=torch.float32, multiple=1)
    n = prob32.n
    floors = {   # bytes of one fused iteration; the pipelined one also
                 # forms z' and w' (3 vectors read, 1 written, each)
        "bicgstab": ("fused_k1", "fused_k2", "fused_k3"),
        "ca_bicgstab": ("fused_ca_k1", "fused_ca_k2"),
        "pipe_bicgstab": ("fused_phase_a", "fused_phase_b")}
    single_dev_ms = {}
    for method, kerns in floors.items():
        nbytes = sum(work(k, inp)[0] for k in kerns)
        if method == "pipe_bicgstab":
            nbytes += 2 * 4 * 4 * n
        eager = bench_iteration(prob32, method=method, iters=200)
        dev = bench_iteration(prob32, method=method, iters=200, graph=True)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        single_dev_ms[method] = dev_ms
        _say("times", method=method, f32_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain="tol=0x200",
             bound_ms_per_iter=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
             bytes_per_iter=nbytes)
    time_batched(csr, prob32, inp, single_dev_ms["bicgstab"])
    df_floors = {   # bytes of one fused DF iteration: its passes' bytes
        "bicgstab": ("fused_k1_df", "fused_k2_df", "fused_k3_df"),
        "ca_bicgstab": ("fused_ca_k1_df", "fused_ca_k2_df"),
        "pipe_bicgstab": ("fused_phase_a_df", "fused_phase_b_df")}
    for method, kerns in df_floors.items():
        nbytes = sum(work(k, inp)[0] for k in kerns)
        eager = bench_iteration(probdf, method=method, iters=200)
        dev = bench_iteration(probdf, method=method, iters=200, graph=True)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        _say("times", method=method, df32_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain="tol=0x200",
             bound_ms_per_iter=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
             bytes_per_iter=nbytes)
    del probdf
    time_cheby(inp, prec)
    time_shifted(csr, {
        "df32": build_problem(csr, dtype="df32", multiple=1, sigma_seed=ss),
        "float32": prob32s, "float64": prob64s})
    del prob64s, prob32s
    gc.collect()
    torch.cuda.empty_cache()
    sp = bench_spmv(prob32)
    _say("times", spmv_f32_nnz_per_s=f"{sp['spmv_nnz_per_s']:.4e}",
         spmv_layout=sp["spmv_layout"])
    times = time_kernels(calls, inp, csr)
    time_routing(csr)
    time_window(winp, wprobs)
    times.update(time_kernels(wcalls, winp, csr_w))
    time_butterfly(binp, bprobs)
    times.update(time_kernels(bcalls, binp, csr_u))
    _say("times", max_memory_allocated_gb_whole_run=round(
        torch.cuda.max_memory_allocated() / 1e9, 3))

    kernels = []
    for name, row in times.items():
        base = {"dia_spmv_f32": "dia_spmv", "dia_spmv_f64": "dia_spmv",
                "window_spmv_f32": "window_spmv",
                "window_spmv_f64": "window_spmv"}.get(name, name)
        if name.startswith("butterfly") and name != "butterfly_k3_df":
            base = name.rsplit("_", 1)[0]    # K1-K3 in each dtype
        phase, counter = LAUNCHES_FROM[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "launches": runs[phase][counter],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    kernels.append({
        "name": "shift_update_df", "route": "cuda",
        "source": SOURCES["shift_update_df"],
        "replaces": REPLACES["shift_update_df"],
        "launches": runs["shifted_df32"]["shift_update_df"],
        "max_abs_err": errs["shift_update_df"], "ms": su_row["ms"],
        "plain_ms": su_row["plain_ms"], "bound_ms": su_row["bound_ms"],
        "bound_by": su_row["bound_by"], "library_ms": None})
    _say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
