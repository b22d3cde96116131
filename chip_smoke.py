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
             15 diagonals (tolerances in TOL below); the Chebyshev chains
             on transport_hard(1602112) at degree 8 (their plan, the
             kernels' registers and blocks per SM printed; the float32
             chain's max |kernel - twin| beside its bar); the batched kernels
             at k = 8 lanes, two of them frozen (their outputs must be
             their old values bit for bit; K1b again with their beta NaN
             and omega inf, their dots NaN as the twin's). The double-float (DF)
             kernels take the band as DF pairs split from float64 and
             random DF vectors from a seeded NumPy generator; their output
             vectors must equal the twin's bit for bit, each dot must lie
             within 1e-12 sum|u_i v_i| of the twin's, and the scalar each
             pass folds into its finishing stage must equal the twin's
             formula (ops/precision.py) applied to the kernel's own dots.
             The windowed-ELL kernels (the whole y = A x over the
             layout's row-compacted copy; float32, float64, DF) on the
             layout of clustered_random(1602560) (W = 24), built once on
             the host in float64 and cast, with x from a seeded NumPy
             generator: bit-equal to their twins and to the padded slabs
             plus the leveled COO tail (the JAX order, as plain torch on
             the card); on x with a NaN and an inf planted bit-equal to
             their twins, non-finite exactly in the rows that hold an
             entry in those columns; the float64 SpMV within 1e-12 of
             torch's CSR product. The butterfly kernels on the layout of
             uniform:1602112 padded to 1,602,560 rows as the CLI pads it
             (P = 25,600, W = 16), routed once on the host in float64
             (the C++ router, built by g++), its column table built by
             the CPU twins, then cast to each dtype on the card, where
             K1, K2 and the decode build the table anew: that table
             equal to the CPU's; K1 and K2 (each writing its output
             transposed) on 4-byte (the table's iota) and 8-byte
             elements (a float64 x), the decode on the routed iota, and
             K3 in float32, float64 and DF on a seeded x, bit-equal to
             their twins; K3 on x with a NaN and an inf planted
             bit-equal to its twin and to the routed pipeline (x through
             K1, K2 and the z-form arithmetic, staged_slabs); the whole
             float64 SpMV (K3 and the tail) within 1e-12 of torch's CSR
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
             ButterflyMatrix route, one K1, one K2 and one decode
             launch for the layout it builds and one K3 launch per
             SpMV, x held to a residual taken with torch's float64 CSR
             product (<= 10 tol) and to the error bound it gives;
             `[butterfly_f64]`, `[butterfly_df32]` (K3 DF) and
             `[butterfly_pipe_df32]` (and the two DF body kernels once per
             iteration) through api.solve at 1e-10 on layouts built
             before the count (no K1, K2, decode), max|x-1| < 1e-6;
             each within 2 iterations of gather-ELL, launches in
             `check_butterfly_counts`.
             Every CLI solve runs once untimed, then --repeat times (as
             the JAX CLI does): its launch counts are checked per run
             (per_run). The single-device tooling (ROADMAP slice 9a):
             `[mtx]` writes transport_like(1602112) as a .mtx (write_mtx,
             the reader's bytes, 8 spawned formatters), parses it with the
             native reader bit-equal to the generator's CSR, then runs
             `solve --matrix X.mtx --dtype float32 --tol 1e-6 --json
             --repeat 2` through cli.main: the JAX package's JSON keys, the
             fused f32 launches in each of 3 runs, `[f32]`'s n_iter.
             `[layout_cache]` saves the float32 butterfly layout of
             uniform:1602112 and the window layout of clustered:1602560
             to the layout cache and loads each back on the card (the
             derived k3_col and rc_* rebuilt there): every field
             bit-equal, and a float32 solve from each the same n_iter and
             x bit for bit. `[tools]` prints `info`'s census, runs
             `selftest` on the card (every check PASS, exit 0), `bench
             --matrix transport-like:1602112 --what
             spmv,iter,batched,cheby,shifted` (its times finite and
             positive, every byte rate it allows reckoning at most 3.35
             TB/s, check_bench_line) and `bench --devices 1 --what
             overlap,scaling` in its own process (run_bench_dist: the
             JAX package's keys, the one-rank labels). The distributed
             layer (ROADMAP slices 8a, 8b) on one rank of a real NCCL
             process group met in this process (init_world; the card
             machine has one GPU): first `[halo_kernels]`: the halo
             forms of the DIA SpMV, the DF SpMV, the ten fused passes
             (solvers/fused_dist.py) and the batched kernels 19-22
             (solvers/batched_dist.py, k = 8, two lanes frozen) at the
             main path's n on a rank in the middle of a partition (inp's
             vectors and planes with random neighbour rows around them),
             the rank's rows of each output against the twin's, with
             device ms.
             `[dist]`, `[dist_ca]`, `[dist_pipe]`, `[dist_f64]`,
             `[dist_df32]`, `[dist_ring]` (DIST_PATHS) solve
             transport_like(1602112) partitioned for one rank (DIA halo
             mode) with solve_distributed, each converged with its true
             residual (float64, host CSR) <= 10 tol and n_iter within 2
             of the single-device unfused solve; the float32 and df32
             phases on the halo-fused route (DIST_ROUTES: each pass once
             per iteration, the SpMV kernel only at set-up and exit, and
             on one rank the single-device fused route's n_iter and
             history bit for bit), float64 on the unfused one (the DIA
             SpMV kernel, halo form, twice per iteration and per
             segment), nothing else; `[dist_window]`
             (clustered_random(1602560): kernel 23 once per SpMV) and
             `[dist_butterfly]` (uniform:1602112 padded: K3 once per
             SpMV, the column table built once on the shard);
             `[dist_shifted]` (512 shifts, seed 255, switching, df32:
             kernel 18 once per iteration, every shift's true residual
             <= 100 tol); `[dist_batched]` (8 f32 lanes on the blocked
             halo-fused route: K1b, K2b, K3b once per batch iteration,
             kernel 19 at set-up and exit, 3 reductions per iteration
             for all lanes, n_iter, history and x bit-equal to the
             single-device fused batch; eager and device ms per batch
             iteration); `[dist_cheby]` (cheby:8, f32,
             transport_hard(1602112), the residual <= 100 tol as
             `[cheby]`'s); `[dist_overlap]` (the split-phase Comm bit-
             equal to the blocking form, pipelined f32 with serialize_comm
             on and off bit-equal, then bench_overlap's overlap_gain and
             its label); `[dist_checkpoint]` (solve_with_checkpoints over
             the one-rank runner, cut after one segment and resumed,
             equal to the uninterrupted run, a foreign meta refused);
             each under no_twin_on_card (a plain twin given a CUDA
             tensor fails the phase), launches in check_dist_counts or
             the phase's own rule; the phases share their partitions
             (dist_partition). `[dist_cli]`:
             `solve --devices 1 --json` converges, `--devices 2` exits
             naming the single CUDA device. `[profile]`: `profile --json`
             in f32 on transport-like:1602112, with --sigma-len 64, and
             --trace (the Chrome trace must name dia_spmv_kernel).
             The last slice (ROADMAP slice 9b-ii): `[butterfly_numpy]`
             routes uniform:1602112 again with the NumPy router
             (MBT_NATIVE_ROUTE=0, in a process of its own that starts
             with the butterfly checks, start_numpy_route) and holds its
             layout on the card: the f32 bicgstab at 1e-6 converged
             within 2 iterations of `[butterfly]`, x held to torch's
             float64 CSR residual, K1, K2, the decode once and K3 per
             SpMV; the whole f32 SpMV bit-equal to its twin on a CPU
             copy, the f64 one within 1e-12 of the CSR product;
             simulate_numpy of the layout within 1e-12 of the CSR
             product's largest entry at full size; the route's host seconds, the tails and the
             f32 SpMV's ms beside the native layout's. `[curves]` runs
             scripts/record_curves_torch.py's method loop on
             transport_hard(1602112), df32, tol 1e-14, krr 400, nrr 8
             (the fused DF drivers, check_counts per method), each row
             beside the TPU record's iteration count: classic, CA and
             pipelined-RR converged with a true relres <= 1e-12.
             `[entry]`: entry()'s flagship step on the card and on the
             CPU, n_iter within 1, x_set within 1e-3, kernel 1 only.
             `[dryrun]`: dryrun_multichip(1) on the one-rank NCCL group,
             every assert of the JAX dry run, kernel 1, the DF SpMV and
             kernels 2-4, 7-8 and 9-11 (halo forms) launched.
             `[quickstart]`: `python examples/quickstart_torch.py` exits
             0 with every section's line, the mesh hint for one card
  5. times   CUDA-event slopes: time per iteration of f32 classic, CA and
             pipelined BiCGStab and of df32 classic, CA and pipelined
             (tol=0 chains of 200 iterations) as the host issues it and as
             a replayed CUDA graph (the device's own time; their ratio is
             the device's busy share), beside their byte floors; each
             kernel against its bound, its plain version and, for the
             f32/f64 SpMV, torch's CSR product (K1b and K2b also beside
             their design's floor, with each kernel they launch timed by
             torch.profiler); time per shifted
             iteration at 512 shifts (df32, float32 blocked and
             per-iteration, float64) beside the shift update's byte floor;
             time per batched iteration at k = 8 (eager and device) beside
             8 single-lane classic f32 iterations and its byte floor; the
             chain kernels beside the unfused chain (bench_cheby) and
             their design's floor (the band read once per degree), both
             chains at degrees 1, 2, 4 and 8 (at 1 and 8 on
             transport_hard(300763), whose band fits the L2), and the
             preconditioned f32 classic, df32 classic and df32 pipelined
             iterations (eager and device) beside 2 x (chain + DIA SpMV)
             bytes; the window kernels beside their bounds, twins and
             torch's CSR product, the window build's host seconds, and
             the f32 and df32 classic iterations on the window layout
             (eager and device) beside two window SpMVs' bytes; the
             butterfly kernels and the whole butterfly SpMV (f32, f64,
             DF) beside their bounds, the twins and torch's CSR product,
             the column table's build (K1, K2 and the decode, each
             beside its bound), the route's host seconds, and the
             f32 and df32 classic iterations on the butterfly layout
             beside two SpMVs' bytes; the one-rank distributed f32
             classic iteration (eager, and its kernels' device time by
             torch.profiler) beside the single-device unfused and fused
             routes, and one global dot over the group (the split-phase
             Comm, and the blocking list form it replaced) against one
             on the device
  6. report  the kernels JSON line, the card's name and power limit,
             and the final {"ok": true, "device": ...} line

    python3 chip_smoke.py --chain-times

times the Chebyshev chain kernels alone (chain_times), to compare two
trees in one call: copy this script into each tree and run it there.

    python3 chip_smoke.py --batched-times

does the same for the batched kernels 19-22 at k = 8 (batched_times):
held to their twins with two frozen lanes (finite, then NaN beta and inf
omega), a sha256 digest of each kernel's outputs and dots on those
seeded inputs, their times beside their bounds and K1b / K2b's design
floor, the device time of each kernel a pass launches (torch.profiler),
and the batched iteration, eager and device.

    python3 chip_smoke.py --route-times

does the same for the butterfly column table's build on uniform:1602112
(route_times): a sha256 digest of k3_col for the float32, float64 and DF
layouts routed on the card, the whole build's time beside its bound, the
device time of each kernel the build launches (torch.profiler), and,
where the tree has the decode kernel, K1, K2 (4- and 8-byte elements)
and the decode timed alone, each held to its twin.

    python3 chip_smoke.py --band-times

does the same for the DIA SpMV and the fused classic, CA, pipelined and
DF classic passes (band_times): each held to its twin on the main path's
inputs, then its device ms per call, three replayed-graph timings each,
as one JSON line ("band_times": name -> [ms, ms, ms]).

    python3 chip_smoke.py --io-times

times the reader and the layout cache at full width (io_times): the
native parse against the NumPy parse of the .mtx of
transport_like(1602112), and the CLI's setup_s cold against warm
(--layout-cache) on uniform:1602112 (butterfly) and clustered:1602560
(window), the warm report equal to the cold one apart from its times.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
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
# the passes of df32 classic BiCGStab around an operator
# (ops/cuda_classic_df_bodies.py); kernel 11 (fused_k3_df) is its pass X
CLASSIC_BODIES = ("classic_df_p", "classic_df_a", "classic_df_q",
                  "classic_df_o")
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
    # the classic DF bodies replace no Pallas kernel: XLA fuses the JAX
    # loop's DF vector ops, dots and scalars (solvers/bicgstab.py:145-157)
    **dict.fromkeys(CLASSIC_BODIES, "none (XLA fusion of "
                    "mpi_bicgstab_tpu/solvers/bicgstab.py:145-157)"),
    "cheby_chain": "mpi_bicgstab_tpu/ops/pallas_cheby.py:141",
    "cheby_chain_df": "mpi_bicgstab_tpu/ops/pallas_cheby_df.py:105",
    "window_spmv": "mpi_bicgstab_tpu/ops/pallas_window_spmv.py:43",
    "window_spmv_df": "mpi_bicgstab_tpu/ops/pallas_window_spmv.py:122",
    "butterfly_k1": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:87",
    "butterfly_k2": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:133",
    "butterfly_k3": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:163",
    "butterfly_k3_df": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:327",
    # the decode is no Pallas kernel: the part of _k3_kernel's gather (its
    # 'lane' form) that the port moved into the column table
    "butterfly_decode": "mpi_bicgstab_tpu/ops/pallas_butterfly.py:199",
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
    **dict.fromkeys(CLASSIC_BODIES, _CSRC + "classic_df_bodies.cu"),
    "cheby_chain": _CSRC + "cheby.cu",
    "cheby_chain_df": _CSRC + "cheby.cu",
    "window_spmv": _CSRC + "window_spmv.cu",
    "window_spmv_df": _CSRC + "window_spmv.cu",
    "butterfly_k1": _CSRC + "butterfly.cu",
    "butterfly_k2": _CSRC + "butterfly.cu",
    "butterfly_k3": _CSRC + "butterfly.cu",
    "butterfly_k3_df": _CSRC + "butterfly.cu",
    "butterfly_decode": _CSRC + "butterfly.cu",
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
                 **{k: ("cheby_df32", k) for k in CLASSIC_BODIES},
                 "window_spmv_f32": ("window", "window_rows"),
                 "window_spmv_f64": ("window_f64", "window_rows"),
                 "window_spmv_df": ("window_df32", "window_rows_df"),
                 "butterfly_k1": ("butterfly", "butterfly_k1"),
                 "butterfly_k2": ("butterfly", "butterfly_k2"),
                 "butterfly_decode": ("butterfly", "butterfly_decode"),
                 "butterfly_k3_f32": ("butterfly", "butterfly_k3"),
                 "butterfly_k3_f64": ("butterfly_f64", "butterfly_k3"),
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
# a transport_hard size whose float32 band (15.6 MB) fits the 50 MB L2
N_HARD_L2 = 300_763
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


# a CLI solve runs once untimed, then --repeat (default 1) times
CLI_RUNS = 2
# kernels of a butterfly layout's build: once per command, not per run
BUILD_ONCE = ("butterfly_k1", "butterfly_k2", "butterfly_decode")


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
    from mpi_bicgstab_tpu_torch.ops import cuda_classic_df_bodies as ccb
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
            **{k: getattr(ccb, k) for k in CLASSIC_BODIES},
            "cheby_chain": cc.cheby_chain,
            "cheby_chain_df": cc.cheby_chain_df,
            "window_rows": cws.window_rows,
            "window_rows_df": cws.window_rows_df,
            "butterfly_k1": cbf.butterfly_k1,
            "butterfly_k2": cbf.butterfly_k2,
            "butterfly_decode": cbf.butterfly_decode,
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


def say_chain_info() -> None:
    """Print the chain kernels' registers and resident blocks per SM (the
    card has no ncu)."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    for name, df in (("cheby_chain", False), ("cheby_chain_df", True)):
        _say("check", chain=name, degree=CHEBY_DEGREE, **cc.kernel_info(df))


def say_chain_plan(inp: dict) -> None:
    """Print the chains' schedule on inp's hard band (ops/cuda_cheby
    .chain_plan for this card's resident grid): rows a task, tiles, the
    reach in tiles."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    H = inp["H32"]
    for name, df in (("cheby_chain", False), ("cheby_chain_df", True)):
        grid = cc.resident_blocks(0, df)
        p = cc.chain_plan(H.n_rows, tuple(H.offsets), grid)
        _say("check", chain_plan=name, n=H.n_rows, grid=grid,
             tile_rows=p.tile, tiles=p.n_tiles, reach_tiles=p.reach,
             tasks=p.n_tiles * CHEBY_DEGREE)


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


def nonfinite_frozen_inputs(inp: dict) -> dict:
    """inp with the frozen lanes' beta NaN and omega inf: a frozen lane's
    recurrences may be either (solvers/batched_fused.py)."""
    out = dict(inp)
    for key, val in (("b_beta", float("nan")), ("b_omega", float("inf"))):
        out[key] = inp[key].clone()
        out[key][list(FROZEN_LANES)] = val
    return out


def check_nonfinite_frozen(inp: dict) -> None:
    """K1b on nonfinite_frozen_inputs: the frozen lanes' P2 and S2 bit
    for bit p and s, their dots NaN as the twin's (the dots of the
    unmasked p'), the active lanes within TOL of the twin."""
    import torch
    kern, plain, _ = batched_kernel_calls(inp)["fused_k1b"]
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    fz = list(FROZEN_LANES)
    act = [j for j in range(K_MAIN) if j not in FROZEN_LANES]
    for i, old in enumerate(("p", "s")):
        if not torch.equal(got[i][fz], inp["b_" + old][fz]):
            raise SmokeFailure(f"fused_k1b output {i}: a frozen lane with "
                               f"NaN beta and inf omega changed")
        _close(f"fused_k1b output {i}", got[i][act], want[i][act],
               **TOL["float32"])
    if not (got[2][fz].isnan().all() and want[2][fz].isnan().all()):
        raise SmokeFailure(f"fused_k1b: frozen dots {got[2][fz].tolist()}, "
                           f"twin {want[2][fz].tolist()}, both NaN wanted")
    _close("fused_k1b output 2", got[2][act], want[2][act],
           TOL["float32_dot"]["rtol"], 0.0)
    _say("batched_kernels", k=K_MAIN, frozen_lanes=fz, frozen_beta="nan",
         frozen_omega="inf", frozen="bit-unchanged", frozen_dots="nan")


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
        **classic_body_calls(inp),
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


def classic_body_calls(inp: dict) -> dict:
    """The classic DF bodies' entries of kernel_calls (CLASSIC_BODIES):
    each call returns its vector, or its dots one by one and then the
    folded scalar."""
    from mpi_bicgstab_tpu_torch.ops import cuda_classic_df_bodies as ccb
    r, p, s, rh, q, y = (inp["df_" + k] for k in
                         ("r", "p", "s", "r_hat", "q", "y"))
    a, b, w, rtr = (inp["df_" + k] for k in
                    ("alpha", "beta", "omega", "rTr"))
    args = {"classic_df_p": (r, p, s, (b, w)),
            "classic_df_a": (rh, s, (rtr,)),
            "classic_df_q": (r, s, (a,)), "classic_df_o": (q, y)}

    def flat(out):      # dots and a folded scalar, or one vector
        return (*out[0], out[1]) if isinstance(out, tuple) else (out,)

    return {name: (lambda f=getattr(ccb, name), a=a_: flat(f(*a)),
                   lambda f=getattr(ccb, name + "_plain"), a=a_:
                   flat(f(*a)), "df32")
            for name, a_ in args.items()}


def df_outputs(name: str, out: tuple, inp: dict):
    """What a DF kernel's outputs are: (number of vectors, the (u, v)
    pair of each dot, the folded scalars recomputed from the outputs'
    own dots with the twin's formulas, ops/precision.py)."""
    from mpi_bicgstab_tpu_torch.ops.precision import df_div, df_mul
    from mpi_bicgstab_tpu_torch.solvers.base import fold_beta_alpha
    if name in ("dia_spmv_df", "cheby_chain_df", "classic_df_p",
                "classic_df_q"):
        return 1, [], []
    a, w, rtr, rh, s, z = (inp["df_" + k] for k in
                           ("alpha", "omega", "rTr", "r_hat", "s", "z"))
    if name == "classic_df_a":      # (r^, s), alpha
        return 0, [(rh, s)], [df_div(rtr, out[0])]
    if name == "classic_df_o":      # (q, y), (y, y), omega
        q, y = inp["df_q"], inp["df_y"]
        return 0, [(q, y), (y, y)], [df_div(out[0], out[1])]
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


def halo_inputs(inp: dict, seed: int = 7) -> dict:
    """The halo forms' inputs (solvers/fused_dist.py): the band of inp,
    a Halo of a rank with both neighbours (h the partition's halo for the
    band's reach), and each of inp's vectors with h random rows of each
    neighbour around it ("h_" keys, "h_df_" for the DF ones)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo
    from mpi_bicgstab_tpu_torch.ops.precision import DF, df_from_f64
    reach = max(abs(o) for o in inp["A32"].offsets)
    h = -(-reach // 128) * 128
    rng = np.random.default_rng(seed)

    def ext(v):
        if hasattr(v, "hi"):
            lo, hi = (df_from_f64(rng.standard_normal(h), v.hi.device)
                      for _ in range(2))
            return DF(torch.cat([lo.hi, v.hi, hi.hi]),
                      torch.cat([lo.lo, v.lo, hi.lo]))
        lo, hi = (torch.as_tensor(rng.standard_normal(h), dtype=v.dtype,
                                  device=v.device) for _ in range(2))
        return torch.cat([lo, v, hi])

    out = {"halo": Halo(h, True, True)}
    for k in ("r", "p", "s", "r_hat", "x", "q", "y", "w", "z"):
        out["h_" + k] = ext(inp[k])
        out["h_df_" + k] = ext(inp["df_" + k])
    for k in ("r", "p", "s", "r_hat", "x", "q", "y"):   # batched planes
        P = inp["b_" + k]
        lo, hi = (torch.as_tensor(rng.standard_normal((P.shape[0], h)),
                                  dtype=P.dtype, device=P.device)
                  for _ in range(2))
        out["hb_" + k] = torch.cat([lo, P, hi], 1)
    return out


def halo_batched_calls(inp: dict, hinp: dict) -> dict:
    """name -> (kernel call, plain call, which outputs hold the halo rows
    too) of the batched kernels' halo forms (kernels 19-22, the
    row-partitioned batch of solvers/batched_dist.py) on halo_inputs'
    K_MAIN-lane planes, two lanes frozen: the SpMV over the halo-form X
    (its [k, n] result), K1b and K2b (stage 0 writes P2 and Q over the
    halo rows too), K3b on the rank's rows."""
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fbat
    H = hinp["halo"]
    v, o = inp["A32"].vals, inp["A32"].offsets
    r, p, s, rh, x, q, y = (hinp["hb_" + k] for k in
                            ("r", "p", "s", "r_hat", "x", "q", "y"))
    a, b, w, act = (inp["b_" + k] for k in
                    ("alpha", "beta", "omega", "active"))
    k1 = (v, r, p, s, rh, (b, w, act), o)
    k2 = (v, r, s, (a,), o)
    k3 = (x, p, q, y, rh, (a, w, act))
    return {
        "batched_dia_spmv": (
            lambda: (cbs.batched_dia_spmv(v, o, x, H),),
            lambda: (cbs.batched_dia_spmv_plain(v, o, x, H),), ()),
        "fused_k1b": (lambda: fbat.fused_k1b(*k1, halo=H),
                      lambda: fbat.fused_k1b_plain(*k1, halo=H), (0,)),
        "fused_k2b": (lambda: fbat.fused_k2b(*k2, halo=H),
                      lambda: fbat.fused_k2b_plain(*k2, halo=H), (0,)),
        "fused_k3b": (lambda: fbat.fused_k3b(*k3, halo=H),
                      lambda: fbat.fused_k3b_plain(*k3, halo=H), ()),
    }


def check_halo_batched(inp: dict, hinp: dict) -> None:
    """`[halo_kernels]`, kernels 19-22: each batched halo form against its
    twin on the same halo-form planes; an output's rank rows (and the
    halo rows of P2 and Q, which stage 0 writes) within TOL["float32"],
    the per-lane dots within TOL["float32_dot"], the frozen lanes' P2,
    S2, X2 and R2 bit-unchanged; then its device ms per call (a replayed
    graph)."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    H = hinp["halo"]
    n = inp["A32"].vals.shape[1]
    fz = list(FROZEN_LANES)
    olds = {"fused_k1b": ("hb_p", "hb_s"), "fused_k3b": ("hb_x", "hb_q")}
    for name, (kern, plain, whole) in halo_batched_calls(inp,
                                                         hinp).items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        errs = []
        for i, (g, w) in enumerate(zip(got, want)):
            what = f"{name} (halo form) output {i}"
            if g.dim() == 1:
                _close(what, g, w, TOL["float32_dot"]["rtol"], 0.0)
            else:
                if g.shape[1] != n and i not in whole:
                    g, w = g[:, H.h:H.h + n], w[:, H.h:H.h + n]
                _close(what, g, w, **TOL["float32"])
            errs.append(_err(g.double(), w.double()))
        for i, key in enumerate(olds.get(name, ())):
            old = hinp[key]
            if not torch.equal(got[i][fz, H.h:H.h + n],
                               old[fz, H.h:H.h + n]):
                raise SmokeFailure(f"{name} (halo form) output {i}: a "
                                   f"frozen lane changed")
        _say("halo_kernels", kernel=name, ok=True, halo=H.h,
             neighbours="both", lanes=K_MAIN, frozen_lanes=fz, rows=n,
             halo_rows_compared=bool(whole),
             ms=f"{time_call(kern, graph=True) * 1e3:.4f}",
             max_abs_err_per_output="[" + ",".join(
                 f"{e:.3e}" for e in errs) + "]")


def halo_kernel_calls(inp: dict, hinp: dict) -> dict:
    """name -> (kernel call, plain call, DF?, dot pairs) of the halo
    forms: the DIA SpMV's (float32 and DF, the row-partitioned SpMV's band
    multiply) and the ten passes of the halo-fused route, on halo_inputs.
    A DF pass's dot pairs name the vectors of each dot, for its bar."""
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
    H = hinp["halo"]
    v, o, vdf = inp["A32"].vals, inp["A32"].offsets, inp["Adf"].vals
    r, p, s, rh, x, q, y, wv, z = (
        hinp["h_" + k] for k in ("r", "p", "s", "r_hat", "x", "q", "y",
                                 "w", "z"))
    dr, dp, ds, drh, dx, dq, dy = (
        hinp["h_df_" + k] for k in ("r", "p", "s", "r_hat", "x", "q", "y"))
    a, b, w = inp["alpha"], inp["beta"], inp["omega"]
    da, db, dw, rtr = (inp["df_" + k] for k in
                       ("alpha", "beta", "omega", "rTr"))

    def pair(kern, plain, *args, df=False, dots=None):
        return (lambda: kern(*args, halo=H), lambda: plain(*args, halo=H),
                df, dots)

    return {
        "dia_spmv_f32": (
            lambda: (cuda_spmv.dia_spmv(v, o, x, halo=H.h),),
            lambda: (cuda_spmv.dia_spmv_plain(v, o, x, halo=H.h),),
            False, None),
        "dia_spmv_df": (
            lambda: (cuda_spmv.dia_spmv_df(vdf, o, dx, halo=H.h),),
            lambda: (cuda_spmv.dia_spmv_df_plain(vdf, o, dx, halo=H.h),),
            True, lambda out: []),
        "fused_k1": pair(fcl.fused_k1, fcl.fused_k1_plain, v, r, p, s, rh,
                         (b, w), o),
        "fused_k2": pair(fcl.fused_k2, fcl.fused_k2_plain, v, r, s, (a,),
                         o),
        "fused_k3": pair(fcl.fused_k3, fcl.fused_k3_plain, x, p, q, y, rh,
                         (a, w)),
        "fused_ca_k1": pair(fca.fused_ca_k1, fca.fused_ca_k1_plain, v, r,
                            p, s, wv, z, (a, b, w), o),
        "fused_ca_k2": pair(fca.fused_ca_k2, fca.fused_ca_k2_plain, v, q,
                            y, x, p, rh, s, z, (a, w), o),
        "fused_phase_a": pair(fpipe.fused_phase_a,
                              fpipe.fused_phase_a_plain, v, z, r, p, s, wv,
                              x, (a, b, w), o),
        "fused_phase_b": pair(fpipe.fused_phase_b,
                              fpipe.fused_phase_b_plain, v, wv, x, p, q, y,
                              rh, s, z, (a, w), o),
        "fused_k1_df": pair(fcldf.fused_k1_df, fcldf.fused_k1_df_plain,
                            vdf, dr, dp, ds, drh, (db, dw, rtr), o,
                            df=True, dots=lambda out: [(drh, out[1])]),
        "fused_k2_df": pair(fcldf.fused_k2_df, fcldf.fused_k2_df_plain,
                            vdf, dr, ds, (da,), o, df=True,
                            dots=lambda out: [(out[0], out[1]),
                                              (out[1], out[1])]),
        "fused_k3_df": pair(fcldf.fused_k3_df, fcldf.fused_k3_df_plain,
                            dx, dp, dq, dy, drh, (da, dw, rtr), df=True,
                            dots=lambda out: [(out[1], out[1]),
                                              (drh, out[1])]),
    }


def check_halo_kernels(inp: dict) -> None:
    """`[halo_kernels]`: each halo form against its twin on the same
    halo-form inputs (then kernels 19-22's, check_halo_batched), the
    rank's rows of every output vector compared:
    float32 with the kernels' tolerances (TOL), DF bit-equal, each DF dot
    within TOL["df32_dot"] x sum |u_i v_i| over the rank's rows, a folded
    scalar within the same bar relative to its value; then its device ms
    per call (a replayed graph, as time_kernels times the plain form)."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops.cuda_spmv import center
    hinp = halo_inputs(inp)
    H = hinp["halo"]
    n = inp["A32"].vals.shape[1]

    def rows(t):
        """The rank's rows of a halo-form vector (an SpMV's [n] result
        as it is, a dot too)."""
        h = t.hi if hasattr(t, "hi") else t
        return center(t, H) if h.dim() and h.shape[0] == n + 2 * H.h \
            else t

    for name, (kern, plain, df, dots) in halo_kernel_calls(inp,
                                                           hinp).items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        vecs = [i for i, t in enumerate(want)
                if (t.hi if hasattr(t, "hi") else t).dim()]
        errs = [_err(_f64(rows(g)), _f64(rows(w)))
                for g, w in zip(got, want)]
        for i, (g, w) in enumerate(zip(got, want)):
            what = f"{name} (halo form) output {i}"
            if i in vecs:
                if df and not _same(rows(g), rows(w)):
                    raise SmokeFailure(f"{what}: kernel and twin rows "
                                       f"differ, {errs[i]:.3e}")
                if not df:
                    _close(what, rows(g), rows(w), **TOL["float32"])
            elif not df:
                _close(what, g, w, TOL["float32_dot"]["rtol"], 0.0)
        if df:
            pairs = dots(got)
            for j, (u, v) in enumerate(pairs):
                k = len(vecs) + j
                bar = TOL["df32_dot"] * float(
                    (_f64(rows(u)) * _f64(rows(v))).abs().sum())
                if not errs[k] <= bar:
                    raise SmokeFailure(f"{name} (halo form) dot {j}: "
                                       f"{errs[k]:.3e} > {bar:.3e}")
            for k in range(len(vecs) + len(pairs), len(want)):
                bar = 1e-9 * float(_f64(want[k]).abs())
                if not errs[k] <= bar:
                    raise SmokeFailure(f"{name} (halo form) folded scalar: "
                                       f"{errs[k]:.3e} > {bar:.3e}")
        _say("halo_kernels", kernel=name, ok=True, halo=H.h,
             neighbours="both", rows=rows(got[0]).shape[0] if not df
             else rows(got[0]).hi.shape[0],
             ms=f"{time_call(kern, graph=True) * 1e3:.4f}",
             max_abs_err_per_output="[" + ",".join(
                 f"{e:.3e}" for e in errs) + "]")
    check_halo_batched(inp, hinp)


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
                 bar=f"{TOL[dt] * scale:.3e}", bit_equal=torch.equal(g, w))
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


def per_run(counts: dict, what: str, runs: int = CLI_RUNS,
            once=()) -> dict:
    """The launches of one of `runs` identical runs of a solve (the CLI
    solves once untimed, then --repeat times, as the JAX CLI does; every
    run launches the same kernels): each count divided by runs, but those
    in `once` (the layout's build, once per command); SmokeFailure where
    a count does not divide."""
    out = {}
    for k, v in counts.items():
        if k in once:
            out[k] = v
        elif v % runs:
            raise SmokeFailure(f"{what}: {k} launched {v} times, not the "
                               f"same in each of {runs} runs")
        else:
            out[k] = v // runs
    return out


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
    check_counts(method, dtype, report["total_iter"],
                 per_run(counts, f"{method} {dtype}"), args.restarts,
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
    if name in ("cheby_chain", "cheby_chain_df"):
        # the band once, v in, x out; operations of this run's chain: the
        # band product at every step but the last, 2 flops per entry (one
        # df_fma in DF), and 5 (in DF 4 df_fma) updates per row and step
        H = inp["H32"]
        n, W, nz, d = H.n_rows, H.n_diags, _band_nnz(H), CHEBY_DEGREE
        if name == "cheby_chain":
            return 4 * (W * n + 2 * n), 2 * nz * d + 5 * n * d, "float32"
        return (8 * (W * n + 2 * n), DF_FMA_FLOPS * (nz * d + 4 * n * d),
                "df32")
    fma, dot = DF_FMA_FLOPS, DF_DOT_FLOPS
    if name in CLASSIC_BODIES:
        # (DF vectors in, out, scalars in and out, df_fma, dots) a row:
        # P r p s in, p' out; A r^ s in, rTr, alpha; Q r s in, q out; O q y
        n = inp["df_r"].hi.shape[0]
        n_in, n_out, n_sc, n_fma, n_dot = {
            "classic_df_p": (3, 1, 2, 2, 0), "classic_df_a": (2, 0, 3, 0, 1),
            "classic_df_q": (2, 1, 1, 1, 0),
            "classic_df_o": (2, 0, 3, 0, 2)}[name]
        return (8 * ((n_in + n_out) * n + n_sc),
                (fma * n_fma + dot * n_dot) * n, "df32")
    A = inp["A32"]
    n, W = A.n_rows, A.n_diags
    nz = _band_nnz(A)
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
    if name in ("window_spmv_f32", "window_spmv_f64"):   # the whole SpMV
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
        if name in ("fused_k1b", "fused_k2b"):
            # the floor of the staged design: the bound plus one re-read of
            # the plane stage 0 stored (p' or q)
            A = inp["A32"]
            row["design_floor_ms"] = (nbytes + 4 * K_MAIN * A.n_rows) \
                / HBM_BYTES_PER_S * 1e3
            extra = {"design_floor_ms": f"{row['design_floor_ms']:.4f}"}
        if name.startswith("window_spmv"):
            # this design's floor (the compacted slots) and the padded
            # slab kernel's, beside bound_ms, the nonzeros' bytes
            b = window_bytes(name, inp)
            row.update(slots_bound_ms=b["slots"] / HBM_BYTES_PER_S * 1e3,
                       padded_bound_ms=b["padded"] / HBM_BYTES_PER_S * 1e3)
            extra = {k: f"{row[k]:.4f}"
                     for k in ("slots_bound_ms", "padded_bound_ms")}
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
    check_shifted_counts(phase, dtype, it, per_run(counts, phase))
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
    segment), in df32 the classic bodies' passes once per iteration
    (df32_passes), no other kernel; every lane converged, true residual
    <= 100 tol, lane 0 (x = ones) within 1e-6. Returns the counts."""
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
    passes = df32_passes("bicgstab", dtype) if device != "cpu" else ()
    others = {c: v for c, v in counts.items()
              if v and c != spmv and (c not in passes or v != sum(its))}
    ok = (counts[spmv] == 0 if device == "cpu"
          else segs % 2 == 0 and K_LANES <= segs // 2 <= 3 * K_LANES
          and all(counts[c] == sum(its) for c in passes))
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

def df32_passes(method: str, dtype: str) -> tuple:
    """The passes the unfused route of `method` launches once an
    iteration around its operator (solvers/bicgstab.py): df32
    pipe_bicgstab its two body kernels, df32 classic the classic bodies
    and kernel 11 as pass X; none in another dtype."""
    if dtype != "df32":
        return ()
    return {"pipe_bicgstab": ("fused_body_a", "fused_body_b"),
            "bicgstab": (*CLASSIC_BODIES, "fused_k3_df")}.get(method, ())


def check_cheby_counts(what: str, method: str, dtype: str, it: int,
                       counts: dict, restarts: int, lanes: int = 1,
                       device: str = "cuda") -> None:
    """The launches of a converged preconditioned solve (`lanes` right-
    hand sides, `it` iterations over every lane and restart segment). One
    application of A p(A) is a chain and a SpMV: the chain kernel on a
    float32 or DF band, degree float64 SpMVs in float64. Per segment
    the classic solver applies it for r0 and the true residual and twice
    per iteration, df32 pipe_bicgstab also for w0 and t0; df32_passes
    launch once each per iteration; each lane ends with one p(A) (the
    exit transform). Nothing else launches; on the CPU nothing at all."""
    if device == "cpu":
        if any(counts.values()):
            raise SmokeFailure(f"{what}: launches {counts} on the CPU")
        return
    d = CHEBY_DEGREE
    spmv = "dia_spmv_df" if dtype == "df32" else "dia_spmv"
    chain = {"float32": "cheby_chain", "df32": "cheby_chain_df"}.get(dtype)
    passes = df32_passes(method, dtype)
    used = {spmv, chain, *passes}
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
    ok = ok and all(counts.get(k, 0) == it for k in passes)
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
                       per_run(counts, "cheby"), args.restarts,
                       device=device)
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


def time_chain_degrees(inp: dict, degrees) -> None:
    """Both chain kernels on inp's hard band at each degree (replayed CUDA
    graphs of 30 calls), beside one band's read time from HBM, and the
    wrapper's workspace fill alone (at most as many ints as a 256-row
    plan)."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops.cuda_cheby import (cheby_chain,
                                                       cheby_chain_df)
    lo, hi = inp["h_lo"], inp["h_hi"]
    for fn, A, v, elem in ((cheby_chain, inp["H32"], inp["h_v"], 4),
                           (cheby_chain_df, inp["Hdf"], inp["h_vdf"], 8)):
        band = elem * A.n_diags * A.n_rows
        for d in degrees:
            ms = time_call(lambda: fn(A.vals, v, A.offsets, d, lo, hi),
                           iters=30, graph=True) * 1e3
            _say("times", kernel=fn.__name__, n=A.n_rows, degree=d,
                 ms=f"{ms:.4f}", ms_per_degree=f"{ms / d:.4f}",
                 band_hbm_ms=f"{band / HBM_BYTES_PER_S * 1e3:.4f}")
    # the wrapper's zeroed workspace (flags and ticket counter) alone
    tiles = -(-inp["H32"].n_rows // 256)
    ms = time_call(lambda: torch.zeros(tiles + 1, dtype=torch.int32,
                                       device="cuda"),
                   iters=30, graph=True) * 1e3
    _say("times", chain_workspace_fill_ms=f"{ms:.4f}", ints=tiles + 1)


def chain_times() -> int:
    """`chip_smoke.py --chain-times`: the chain kernels alone, so that two
    trees can be compared in one call (copy this script into each and run
    it there): the card, the build, both chains held to their twins at
    CHEBY_DEGREE on transport_hard(N_HARD), their plan, registers and
    blocks per SM, and time_cheby. Prints no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.models.generators import transport_hard
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    print(probe())
    build()
    inp = cheby_inputs(build_problem(transport_hard(N_HARD),
                                     dtype=torch.float64, multiple=1))
    check_kernels(cheby_kernel_calls(inp), inp)
    say_chain_plan(inp)
    say_chain_info()
    time_cheby(inp, ChebyPrecond(CHEBY_DEGREE, inp["h_lo"], inp["h_hi"]))
    return 0


BAND_KERNELS = ("dia_spmv_f32", "fused_k1", "fused_k2", "fused_k3",
                "fused_ca_k1", "fused_ca_k2", "fused_phase_a",
                "fused_phase_b", "dia_spmv_df", "fused_k1_df",
                "fused_k2_df", "fused_k3_df")


def band_times() -> int:
    """`chip_smoke.py --band-times`: the DIA SpMV and the fused band
    passes alone on transport_like(N_MAIN), so that two trees can be
    compared in one call (copy this script into each and run it there):
    each held to its twin (check_kernels), then three replayed-graph
    timings of each (time_call). Prints one JSON line, no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    print(probe())
    build()
    inp = kernel_inputs(transport_like(N_MAIN))
    calls = {k: v for k, v in kernel_calls(inp).items()
             if k in BAND_KERNELS}
    check_kernels(calls, inp)
    print(json.dumps({"band_times": {
        k: [round(time_call(calls[k][0], graph=True) * 1e3, 5)
            for _ in range(3)] for k in BAND_KERNELS}}))
    return 0


def time_classic_loops(prob, prec, iters: int = 30) -> None:
    """`[classic_bodies]`: df32 classic BiCGStab with prec on prob by
    its two loops over the same operator, solvers/bicgstab.bicgstab (the
    classic bodies) and _classic (the unfused DF steps, the route before
    the bodies): a solve at CHEBY_PATHS' tol by each (converged, n_iter
    within 5% of each other: the bodies' dots sum in another order,
    seconds, the largest difference of their iterates), then each loop's
    time per iteration from tol=0 chains of `iters`, eager and as
    replayed CUDA graphs."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import _graph, _slope_time
    from mpi_bicgstab_tpu_torch.ops.cheby import wrap_operator
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import _classic, bicgstab
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    _, dtype, tol = CHEBY_PATHS["cheby_df32"]
    A = wrap_operator(prob.A, prec)

    def op(v):
        return spmv(A, v)

    out, xs = {}, {}
    for name, fn in (("bodies", bicgstab), ("unfused", _classic)):
        cfg = SolverConfig(tol=tol, max_iter=CHEBY_MAX_ITER, dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(op, Comm(), prob.b, prob.x0, cfg)
        conv = bool(res.converged)
        secs = time.perf_counter() - t0

        def make_chain(K, graph=False, fn=fn):
            c = SolverConfig(tol=0.0, max_iter=K, dtype=dtype)
            run = lambda: fn(op, Comm(), prob.b, prob.x0, c)  # noqa: E731
            return _graph(run) if graph else run

        eager = _slope_time(make_chain, max(2, iters // 6), iters, reps=3)
        dev = _slope_time(lambda K: make_chain(K, True), max(2, iters // 6),
                          iters, reps=3)
        xs[name] = _f64(res.x)
        out[name] = dict(converged=conv, n_iter=res.n_iter,
                         true_relres=f"{float(res.true_relres):.3e}",
                         solve_s=round(secs, 3),
                         eager_ms_per_iter=f"{eager * 1e3:.4f}",
                         device_ms_per_iter=f"{dev * 1e3:.4f}")
    diff = float((xs["bodies"] - xs["unfused"]).abs().max())
    b, u = out["bodies"], out["unfused"]
    _say("classic_bodies", degree=CHEBY_DEGREE, tol=tol,
         chain=f"tol=0x{iters}", max_abs_x_diff=f"{diff:.3e}",
         **{f"{k}_{f}": v for k, row in out.items() for f, v in row.items()})
    if not (b["converged"] and u["converged"]
            and abs(b["n_iter"] - u["n_iter"]) <= 0.05 * u["n_iter"]):
        raise SmokeFailure(f"classic_bodies: bodies {b}, unfused {u}")


def classic_bodies() -> int:
    """`chip_smoke.py --classic-bodies`: df32 classic BiCGStab's bodies
    (CLASSIC_BODIES, and kernel 11 as pass X) alone on
    transport_hard(N_HARD), a few minutes: each held to its twin
    (check_kernels: vectors and folded scalars bit-equal, dots within
    TOL["df32_dot"] of sum |u v|), `[cheby_df32]` (the df32 classic +
    cheby solve through api.solve, each pass once an iteration:
    check_cheby_counts), time_classic_loops, and each pass's time beside
    its byte bound and its twin's (time_kernels). Prints no result
    line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.models.generators import transport_hard
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    print(probe())
    build()
    csr = transport_hard(N_HARD)
    inp = kernel_inputs(csr)
    inp.update(cheby_inputs(build_problem(csr, dtype=torch.float64,
                                          multiple=1)))
    calls = {k: v for k, v in df_kernel_calls(inp).items()
             if k in (*CLASSIC_BODIES, "fused_k3_df")}
    check_kernels(calls, inp)
    prec = ChebyPrecond(CHEBY_DEGREE, inp["h_lo"], inp["h_hi"])
    with no_twin_on_card():
        run_cheby_api("cheby_df32", {"df32": inp["h_probdf"]}, prec)
    time_classic_loops(inp["h_probdf"], prec)
    time_kernels(calls, inp, csr)
    return 0


def say_batched_digests(calls: dict, what: str) -> None:
    """A sha256 digest of each batched kernel's outputs and dots, to be
    held equal across two trees on the same seeded inputs."""
    import torch
    for name in BATCHED:
        out = calls[name][0]()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in out:
            h.update(t.contiguous().cpu().numpy().tobytes())
        _say("digest", kernel=name, inputs=what, sha256=h.hexdigest())


def say_kernels_of(of: str, fn, calls_each: int = 20) -> None:
    """The device time of each kernel fn() launches, per call
    (torch.profiler over calls_each calls; "not measured" where the trace
    holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls_each):
            fn()
        torch.cuda.synchronize()
    seen = False
    for e in prof.key_averages():
        us = e.device_time_total
        if us:
            seen = True
            _say("stages", of=of, kernel=repr(e.key[:70]),
                 launches_per_call=e.count / calls_each,
                 device_ms_per_call=f"{us / 1e3 / calls_each:.4f}")
    if not seen:
        _say("stages", of=of, device_ms_per_call="not measured")


def say_pass_kernels(calls: dict, calls_each: int = 20) -> None:
    """The device time of each kernel that K1b and K2b launch, per call
    of the pass (say_kernels_of)."""
    for name in ("fused_k1b", "fused_k2b"):
        say_kernels_of(name, calls[name][0], calls_each)


def batched_times() -> int:
    """`chip_smoke.py --batched-times`: kernels 19-22 alone at K_MAIN
    lanes on transport_like(N_MAIN), so that two trees can be compared in
    one call (copy this script into each and run it there): the card, the
    build, the kernels held to their twins with FROZEN_LANES frozen
    (finite, then NaN beta and inf omega), their digests on both inputs,
    their times (time_kernels, K1b / K2b beside their design floor), the
    kernels each pass launches (say_pass_kernels), and the batched
    iteration beside K_MAIN single-lane classic iterations
    (time_batched). Prints no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.benchmarks.runner import bench_iteration
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    print(probe())
    build()
    csr = transport_like(N_MAIN)
    inp = kernel_inputs(csr)
    calls = batched_kernel_calls(inp)
    check_kernels(calls, inp)
    check_frozen_lanes(calls, inp)
    nf = nonfinite_frozen_inputs(inp)
    check_nonfinite_frozen(nf)
    say_batched_digests(calls, "finite")
    say_batched_digests(batched_kernel_calls(nf), "nan_beta_inf_omega")
    time_kernels(calls, inp, csr)
    say_pass_kernels(calls)
    prob32 = build_problem(csr, dtype=torch.float32, multiple=1)
    single = bench_iteration(prob32, method="bicgstab", iters=200,
                             graph=True)
    time_batched(csr, prob32, inp, single["time_per_iter_s"] * 1e3)
    return 0


def time_route_stages(B, x64) -> None:
    """K1 and K2 on B's tables, 4-byte elements on the int32 iota and
    8-byte ones on x64, then the decode on the routed iota: each held
    bit-equal to its twin and timed alone (replayed CUDA graphs)."""
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    iota = torch.arange(1, B.n_cols + 1, dtype=torch.int32, device=B.device)
    for x in (iota, x64):
        mid = cbf.butterfly_k1(B, x)
        z = cbf.butterfly_k2(B, mid)
        if not (torch.equal(mid, bs.k1_plain(B, x))
                and torch.equal(z, bs.k2_plain(B, mid))):
            raise SmokeFailure(f"K1 / K2 on {x.dtype} differ from their "
                               f"twins")
        k1 = time_call(lambda: cbf.butterfly_k1(B, x), graph=True) * 1e3
        k2 = time_call(lambda: cbf.butterfly_k2(B, mid), graph=True) * 1e3
        _say("stages", element_bytes=x.element_size(), k1_ms=f"{k1:.4f}",
             k2_ms=f"{k2:.4f}", bit_equal_twins=True)
    z = bs.route(B, iota)
    if not torch.equal(cbf.butterfly_decode(B, z), bs.decode_plain(B, z)):
        raise SmokeFailure("the decode differs from its twin")
    ms = time_call(lambda: cbf.butterfly_decode(B, z), graph=True) * 1e3
    _say("stages", kernel="butterfly_decode", ms=f"{ms:.4f}",
         bit_equal_twin=True)


def route_times() -> int:
    """`chip_smoke.py --route-times`: the butterfly column table's build
    alone on uniform:N_UNIFORM, so that two trees can be compared in one
    call (copy this script into each and run it there): the card, the
    build, the host layout routed once (its table built by the CPU
    twins), the float32, float64 and DF layouts cast to the card, each
    building its table there, with a sha256 digest of each k3_col (held
    equal to the host's); the whole build's time beside its bound; the
    device time of each kernel a build launches (say_kernels_of); and,
    where the tree has the decode kernel, K1, K2 and the decode each timed
    alone (time_route_stages). Prints no result line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    from mpi_bicgstab_tpu_torch.ops.butterfly import (build_butterfly,
                                                      butterfly_with_values)
    print(probe())
    build()
    host = build_butterfly(uniform_csr(N_UNIFORM), device="cpu")
    for key, dt in (("B32", torch.float32), ("B64", torch.float64),
                    ("Bdf", "df32")):
        col = butterfly_with_values(host, dt, "cuda").k3_col.cpu()
        if not same_bits(col, host.k3_col):
            raise SmokeFailure(f"butterfly {key}: the column table built "
                               f"on the card differs from the CPU twins'")
        _say("digest", layout=key, k3_col_sha256=hashlib.sha256(
            col.numpy().tobytes()).hexdigest())
    B = butterfly_with_values(host, torch.float32, "cuda")
    inp = {"B32": B, "b_zread": z_elements_read(B)}
    ms = time_call(lambda: bs.column_table(B), iters=12, reps=3,
                   graph=True) * 1e3
    bound = build_bound_ms(inp)
    _say("times", column_table_build_ms=f"{ms:.4f}",
         build_bound_ms=f"{bound:.4f}", bound_share=f"{bound / ms:.3f}",
         z_elements_read=inp["b_zread"])
    say_kernels_of("column_table", lambda: bs.column_table(B), 10)
    if hasattr(cbf, "butterfly_decode"):
        x64 = torch.as_tensor(np.random.default_rng(0).standard_normal(
            B.n_cols), device="cuda")
        time_route_stages(B, x64)
    return 0


def time_chains_l2() -> None:
    """Both chain kernels held to their twins at CHEBY_DEGREE on
    transport_hard(N_HARD_L2), whose band fits the L2, with their plan,
    and timed at degrees 1 and CHEBY_DEGREE (time_chain_degrees)."""
    import torch

    from mpi_bicgstab_tpu_torch.models.generators import transport_hard
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    inp = cheby_inputs(build_problem(transport_hard(N_HARD_L2),
                                     dtype=torch.float64, multiple=1))
    check_kernels(cheby_kernel_calls(inp), inp)
    say_chain_plan(inp)
    time_chain_degrees(inp, (1, CHEBY_DEGREE))


def time_cheby(inp: dict, prec) -> None:
    """The chain kernels beside the unfused chain (bench_cheby, graph
    replays); both chain kernels at degrees 1, 2, 4 and 8 beside one
    band's read time from HBM (the band is read once per degree, so the
    slope over the degree is one step's cost and the intercept the
    launch's and the schedule's rest), and on a band that fits the L2
    (time_chains_l2); and the preconditioned float32
    classic, df32 classic and df32 pipelined iterations (tol=0 chains
    through bench_iteration), eager and as replayed CUDA graphs, beside
    their floor 2 x (chain + DIA SpMV) bytes."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_cheby,
                                                          bench_iteration)
    lo, hi = inp["h_lo"], inp["h_hi"]
    for prob in (inp["h_prob32"], inp["h_probdf"]):
        r = bench_cheby(prob, lo, hi, degree=CHEBY_DEGREE)
        _say("times", cheby_apply=r["dtype"], degree=CHEBY_DEGREE,
             chain_kernel_ms=f"{r['cheby_fused_apply_s'] * 1e3:.4f}",
             unfused_chain_ms=f"{r['cheby_unfused_apply_s'] * 1e3:.4f}",
             chain_speedup=f"{r['cheby_fused_speedup']:.3f}")
    time_chain_degrees(inp, (1, 2, 4, CHEBY_DEGREE))
    time_chains_l2()
    H = inp["H32"]
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
    cast to float32, float64 and DF pairs, x from a NumPy generator
    seeded `seed` ("wx" keys) and x with a NaN and an inf planted ("wn"
    keys; on the host in "wn_host")."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    from mpi_bicgstab_tpu_torch.ops.window_ell import (
        csr_to_window_ell, window_ell_with_values)
    t0 = time.perf_counter()
    host = csr_to_window_ell(csr, device="cpu")
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(seed).standard_normal(csr.nrows)
    xn = planted(x, seed + 1)
    inp = {"w_csr": csr, "w_build_s": build_s, "wn_host": xn,
           "W32": window_ell_with_values(host, torch.float32, device),
           "W64": window_ell_with_values(host, torch.float64, device),
           "Wdf": window_ell_with_values(host, "df32", device)}
    for key, v in (("wx", x), ("wn", xn)):
        inp[key + "32"] = torch.as_tensor(v, dtype=torch.float32,
                                          device=device)
        inp[key + "64"] = torch.as_tensor(v, device=device)
        inp[key + "df"] = df_from_f64(v, device)
    return inp


def window_kernel_calls(inp: dict) -> dict:
    """The window kernels (the whole y = A x over the row-compacted copy)
    beside their twins, as kernel_calls gives them; both must agree bit
    for bit."""
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    from mpi_bicgstab_tpu_torch.ops import window_spmv as wsp
    W32, W64, Wdf = inp["W32"], inp["W64"], inp["Wdf"]
    x32, x64, xdf = inp["wx32"], inp["wx64"], inp["wxdf"]
    return {
        "window_spmv_f32": (lambda: (cws.window_rows(W32, x32),),
                            lambda: (wsp.window_rows_plain(W32, x32),),
                            "bit_equal"),
        "window_spmv_f64": (lambda: (cws.window_rows(W64, x64),),
                            lambda: (wsp.window_rows_plain(W64, x64),),
                            "bit_equal"),
        "window_spmv_df": (lambda: (cws.window_rows_df(Wdf, xdf),),
                           lambda: (wsp.window_rows_df_plain(Wdf, xdf),),
                           "bit_equal")}


def _window_pairs(inp: dict, key: str):
    """(dtype suffix, layout, x) per dtype, x from inp[key + suffix]."""
    return [(sfx, inp["W" + sfx], inp[key + sfx])
            for sfx in ("32", "64", "df")]


def check_window_padded(inp: dict) -> None:
    """The SpMV (the kernel on the card, its twin on the CPU) bit-equal
    to the padded slabs plus the leveled tail (window_padded_plain, the
    JAX kernel's order, as plain torch on the same device) on the path's
    finite x, in float32, float64 and DF."""
    from mpi_bicgstab_tpu_torch.ops import window_spmv as wsp
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    for sfx, A, x in _window_pairs(inp, "wx"):
        if not same_bits(spmv(A, x), wsp.window_padded_plain(A, x)):
            raise SmokeFailure(f"window {sfx}: the SpMV and the padded "
                               f"slabs plus the leveled tail differ")
    _say("check", window_spmv="f32,f64,df", x="finite",
         bit_equal_padded_slabs_plus_leveled_tail=True)


def check_window_nonfinite(inp: dict) -> None:
    """On x with a NaN and an inf planted: the SpMV bit-equal to its twin
    (window_rows_plain / window_rows_df_plain on the same device), and
    non-finite in exactly the rows that hold an entry in one of those
    columns (from the host CSR), every other row finite."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops import window_spmv as wsp
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    csr = inp["w_csr"]
    bad = np.flatnonzero(~np.isfinite(inp["wn_host"]))
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
    want = np.zeros(csr.nrows, dtype=bool)
    want[rows[np.isin(csr.col, bad) & (csr.val != 0)]] = True
    for sfx, A, x in _window_pairs(inp, "wn"):
        got = spmv(A, x)
        twin = (wsp.window_rows_df_plain if sfx == "df"
                else wsp.window_rows_plain)(A, x)
        hi = got.hi if sfx == "df" else got
        nonfinite = (~torch.isfinite(hi)).cpu().numpy()
        if not same_bits(got, twin) or not np.array_equal(nonfinite, want):
            raise SmokeFailure(
                f"window {sfx} on x with NaN and inf: bit-equal to the twin "
                f"{same_bits(got, twin)}, {int(nonfinite.sum())} non-finite "
                f"rows where {int(want.sum())} read those columns")
        _say("check", window_spmv=sfx, x="nan_and_inf_planted",
             bit_equal_twin=True, nonfinite_rows=int(nonfinite.sum()),
             rows_reading_them=int(want.sum()))


def check_window_spmv(inp: dict) -> float:
    """The whole float64 SpMV against torch's CSR product on the card:
    within 1e-12 of the product's largest entry. Returns the relative
    error."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    y = spmv(inp["W64"], inp["wx64"])
    ref = torch_csr(inp["w_csr"], inp["wx64"].dtype, y.device) @ inp["wx64"]
    rel = _err(y, ref) / float(ref.abs().max())
    if not rel <= 1e-12:
        raise SmokeFailure(f"window SpMV: {rel:.3e} from the CSR product, "
                           f"relative (> 1e-12)")
    return rel


def window_bytes(name: str, inp: dict) -> dict:
    """Bytes of one y = A x on the window layout, x read once and y
    written once: "nnz" what the work needs (each held entry's value and
    int32 column), "slots" what the kernel streams (every slot of the
    row-compacted copy, a value and a column, and rc_off), "padded" what
    a kernel over the padded slab arrays streams for the slab part alone
    (every slab slot's value, lane_idx and sub_sel, and the window
    bases): the JAX kernel's layout."""
    W = inp["W32"]
    elem = 4 if name == "window_spmv_f32" else 8
    xy = (W.n_cols + W.n_rows) * elem
    return {"nnz": int((W.rc_col >= 0).sum()) * (elem + 4) + xy,
            "slots": W.rc_col.numel() * (elem + 4) + 8 * W.rc_off.numel()
            + xy,
            "padded": W.width * W.n_rows * (elem + 2) + 4 * W.n_tiles + xy}


def window_work(name: str, inp: dict) -> tuple[float, float, str]:
    """(bytes, flops, dtype) of y = A x: the nonzeros' bytes
    (window_bytes "nnz"), 2 flops a held entry (DF: one df_mul and one
    df_add)."""
    held = int((inp["W32"].rc_col >= 0).sum())
    nbytes = window_bytes(name, inp)["nnz"]
    if name == "window_spmv_df":
        return nbytes, (DF_MUL_FLOPS + DF_ADD_FLOPS) * held, "df32"
    return nbytes, 2 * held, ("float32" if name == "window_spmv_f32"
                              else "float64")


def check_window_counts(what: str, method: str, dtype: str, it: int,
                        counts: dict, restarts: int,
                        device: str = "cuda") -> None:
    """The launches of a converged solve on the window layout: one window
    kernel launch per SpMV (its DF form in df32), twice per iteration
    and, per solver segment, for r0 and the true residual (pipe_bicgstab
    also w0 and t0); df32_passes once per iteration; nothing else. On the
    CPU nothing at all."""
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        spmv = "window_rows_df" if dtype == "df32" else "window_rows"
        want.update(dict.fromkeys(df32_passes(method, dtype), it))
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
    check_window_counts("window", "bicgstab", "float32", it,
                        per_run(counts, "window"), args.restarts, device)
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
    beside 2 x the window SpMV's bytes (the nonzeros' and the padded
    slabs', window_bytes), and the SpMV rate of bench_spmv."""
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
        b = window_bytes(name, inp)
        _say("times", method="bicgstab", layout="WindowEllMatrix",
             dtype=dtype, eager_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain=f"tol=0x{iters}",
             two_spmv_bound_ms=f"{2 * b['nnz'] / HBM_BYTES_PER_S * 1e3:.4f}",
             two_spmv_padded_bound_ms=(
                 f"{2 * b['padded'] / HBM_BYTES_PER_S * 1e3:.4f}"))


# --- the butterfly layout (slice 6c) ----------------------------------------

def uniform_csr(n: int):
    """uniform:n as the CLI builds it: random_diag_dominant(n, 8 nonzeros
    a row, seed 0), padded to a multiple of 1024 with identity rows."""
    from mpi_bicgstab_tpu_torch.models.generators import random_diag_dominant
    from mpi_bicgstab_tpu_torch.models.problem import pad_csr_identity
    return pad_csr_identity(random_diag_dominant(n, nnz_per_row=8, seed=0),
                            1024)


def planted(x, seed: int):
    """x (host float64) with one NaN and one inf at seeded positions."""
    import numpy as np
    x = x.copy()
    i, j = np.random.default_rng(seed).choice(x.size, 2, replace=False)
    x[i], x[j] = np.nan, np.inf
    return x


def butterfly_inputs(csr, device="cuda", seed=0) -> dict:
    """The butterfly kernels' inputs at the path's shapes: the layout of
    csr routed once on the host in float64 (its seconds in "b_build_s"),
    its column table built by the CPU twins, and the layout cast to
    float32, float64 and DF pairs on `device` (each table routed anew
    there); x from a NumPy generator seeded `seed`, and x with a NaN and
    an inf planted ("bn" keys); the table build's input (the int32 iota),
    K2's input for it and for the float64 x and the decode's (the routed
    iota), routed by the twins; "b_zread": the elements of z the decode
    reads."""
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
    xn = planted(x, seed + 1)
    inp = {"b_csr": csr, "b_build_s": build_s, "b_host": host,
           "B32": butterfly_with_values(host, torch.float32, device),
           "B64": butterfly_with_values(host, torch.float64, device),
           "Bdf": butterfly_with_values(host, "df32", device)}
    for key, v in (("bx", x), ("bn", xn)):
        inp[key + "32"] = torch.as_tensor(v, dtype=torch.float32,
                                          device=device)
        inp[key + "64"] = torch.as_tensor(v, device=device)
        inp[key + "df"] = df_from_f64(v, device)
    B = inp["B32"]
    inp["biota"] = torch.arange(1, B.n_cols + 1, dtype=torch.int32,
                                device=device)
    for key, v in (("iota", inp["biota"]), ("64", inp["bx64"])):
        inp["bmid" + key] = bs.k1_plain(B, v)
    inp["bziota"] = bs.k2_plain(B, inp["bmidiota"])
    inp["b_zread"] = z_elements_read(B)
    return inp


def z_elements_read(B) -> int:
    """The distinct elements of z that B's K3 slots name (the decode's
    reads of z; a slab's padded slots in one row tile share one)."""
    import torch

    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    seen = torch.zeros(B.P * 1024, dtype=torch.bool, device=B.device)
    for c in range(B.width // 8):
        seen[bs.k3_elem(B, c)] = True
    return int(seen.sum())


def pack_df(x):
    """x's (hi, lo) pairs as one int64 [n] vector (the bits of each pair
    side by side, hi first): how the routed pipeline moved a DF vector."""
    import torch
    return torch.stack((x.hi, x.lo), dim=-1).view(torch.int64).view(-1)


def staged_slabs(A, x):
    """The slab part of A x as the routed pipeline computes it (the port's
    SpMV before its column table, and JAX's 'lane' form): x routed to z
    through K1 and K2, which write their outputs transposed as JAX's T1
    and T2 do (ops/butterfly_spmv.route: the kernels on the card, a DF
    vector as packed pairs) and K3's arithmetic on z, each
    slot reading z element ops/butterfly_spmv.k3_elem. The reference the
    column-table kernels and twins must equal bit for bit."""
    import torch

    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_fma, df_zeros,
                                                      is_df, two_sum)
    shape = A.k3_lane.shape[1:]
    C = A.width // 8
    if not is_df(x):
        z = bs.route(A, x)
        acc = z.new_zeros(shape)
        for c in range(C):
            acc = acc + A.k3_vals[c] * z.index_select(
                0, bs.k3_elem(A, c)).view(shape)
        for h in (4, 2, 1):
            acc = acc[:h] + acc[h:2 * h]
        return acc[0].reshape(-1)
    zf = bs.route(A, pack_df(x)).view(torch.float32).view(-1, 2)
    zh, zl = zf[:, 0], zf[:, 1]
    acc = df_zeros(shape, zh.device)
    for c in range(C):
        e = bs.k3_elem(A, c)
        acc = df_fma(acc, A.k3_vals[c],
                     DF(zh.index_select(0, e).view(shape),
                        zl.index_select(0, e).view(shape)))
    p, lo = acc.hi, acc.lo
    for h in (4, 2, 1):
        s, err = two_sum(p[:h], p[h:2 * h])
        p, lo = s, (lo[:h] + lo[h:2 * h]) + err
    return DF(p[0].reshape(-1), lo[0].reshape(-1))


def x_on_card(x) -> bool:
    return (x.hi if hasattr(x, "hi") else x).is_cuda


def same_bits(a, b) -> bool:
    """a and b (tensors or DF pairs) equal bit for bit, NaN included."""
    import torch
    if hasattr(a, "hi"):
        return same_bits(a.hi, b.hi) and same_bits(a.lo, b.lo)
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def butterfly_kernel_calls(inp: dict) -> dict:
    """Kernels 25-28 and the decode beside their twins on the path's
    inputs, each to equal its twin bit for bit: K1 and K2 moving 4-byte
    elements (the table build's iota) and 8-byte elements (the float64 x,
    routed as the JAX pipeline routes it); the decode on the routed iota;
    K3 in float32 and float64 and K3 DF, on x."""
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    B = inp["B32"]
    calls = {}
    for name, v, mid in (("", inp["biota"], inp["bmidiota"]),
                         ("_b64", inp["bx64"], inp["bmid64"])):
        calls["butterfly_k1" + name] = (
            lambda v=v: (cbf.butterfly_k1(B, v),),
            lambda v=v: (bs.k1_plain(B, v),), "bit_equal")
        calls["butterfly_k2" + name] = (
            lambda m=mid: (cbf.butterfly_k2(B, m),),
            lambda m=mid: (bs.k2_plain(B, m),), "bit_equal")
    z = inp["bziota"]
    calls["butterfly_decode"] = (lambda: (cbf.butterfly_decode(B, z),),
                                 lambda: (bs.decode_plain(B, z),),
                                 "bit_equal")
    for sfx, key in (("f32", "32"), ("f64", "64"), ("df", "df")):
        A, x = inp["B" + key], inp["bx" + key]
        k3, k3_plain = ((cbf.butterfly_k3_df, bs.k3_df_plain) if sfx == "df"
                        else (cbf.butterfly_k3, bs.k3_plain))
        calls[f"butterfly_k3_{sfx}"] = (
            lambda A=A, x=x, f=k3: (f(A, x),),
            lambda A=A, x=x, f=k3_plain: (f(A, x),), "bit_equal")
    return calls


# the kernels line's butterfly entries: the forms the path launches (K1
# and K2 on 4-byte elements and the decode, once per layout; K3 per SpMV)
BUTTERFLY_TIMED = ("butterfly_k1", "butterfly_k2", "butterfly_decode",
                   "butterfly_k3_f32", "butterfly_k3_f64", "butterfly_k3_df")
# the column table's build: its stages, each once per layout
BUILD_STAGES = ("butterfly_k1", "butterfly_k2", "butterfly_decode")


def check_column_tables(inp: dict) -> None:
    """The column table each card layout built with K1, K2 and the
    decode equals the one the CPU twins built for the host layout."""
    host = inp["b_host"].k3_col
    for key in ("B32", "B64", "Bdf"):
        if not same_bits(inp[key].k3_col.cpu(), host):
            raise SmokeFailure(f"butterfly {key}: the column table built "
                               f"on the card differs from the CPU twins'")


def check_butterfly_staged(inp: dict) -> None:
    """K3 (f32, f64) and K3 DF on x with a NaN and an inf planted, bit for
    bit against their twins and against the routed pipeline on the same
    x (staged_slabs: K1, K2 and the z-form arithmetic)."""
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    for sfx, key in (("f32", "32"), ("f64", "64"), ("df", "df")):
        A, x = inp["B" + key], inp["bn" + key]
        df = sfx == "df"
        kernels = ((cbf.butterfly_k3_df, cbf.butterfly_k3) if x_on_card(x)
                   else (bs.k3_df_plain, bs.k3_plain))   # the CPU test
        got = kernels[0 if df else 1](A, x)
        twin = (bs.k3_df_plain if df else bs.k3_plain)(A, x)
        staged = staged_slabs(A, x)
        nan = int(((got.hi if df else got) != (got.hi if df else got)).sum())
        if not (same_bits(got, twin) and same_bits(got, staged)):
            raise SmokeFailure(f"butterfly_k3_{sfx}: on x with NaN and inf "
                               f"the kernel, its twin and the routed "
                               f"pipeline differ")
        _say("check", kernel=f"butterfly_k3_{sfx}", x="nan_and_inf_planted",
             bit_equal_twin=True, bit_equal_routed_pipeline=True,
             nan_rows=nan)


def check_butterfly_spmv(inp: dict) -> float:
    """The whole float64 SpMV (K3 and the tail) against torch's CSR
    product on the card: within 1e-12 of the product's largest entry.
    Returns the relative error."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    y = spmv(inp["B64"], inp["bx64"])
    ref = torch_csr(inp["b_csr"], inp["bx64"].dtype, y.device) @ inp["bx64"]
    rel = _err(y, ref) / float(ref.abs().max())
    if not rel <= 1e-12:
        raise SmokeFailure(f"butterfly SpMV with its tail: {rel:.3e} from "
                           f"the CSR product, relative (> 1e-12)")
    return rel


def butterfly_work(name: str, inp: dict) -> tuple[float, float, str]:
    """(bytes, flops, dtype) of one stage, each input read once and each
    output written once. K1 (4-byte elements; "_b64" 8): its two int8
    tables, k1_src, x and mid; K2: the tables, mid and z; K1 and K2 only
    move data. The decode: K3's two int8 tables, the elements of z its
    slots name (inp["b_zread"], int32) and k3_col. K3: the column table
    (4 bytes a slot), the values (4 bytes in float32, 8 in float64 and
    DF), x and y (8 bytes an element in float64 and DF); operations: the
    nonzeros the slabs hold, 2 each (a df_fma in DF). "butterfly_spmv_*"
    is the whole SpMV: K3 and the tail (values, rows, columns, the x it
    reads, y's rows read and written)."""
    B = inp["B32"]
    slots = B.P * 1024
    if name.startswith(("butterfly_k1", "butterfly_k2")):
        e = 8 if name.endswith("_b64") else 4
        dt = "float64" if e == 8 else "float32"
        if name.startswith("butterfly_k1"):
            return 2 * slots + 4 * B.P + e * B.n_cols + e * slots, 0, dt
        return 2 * slots + 2 * e * slots, 0, dt
    if name == "butterfly_decode":
        return (6 * B.width * B.n_pad + 4 * inp["b_zread"], 0, "float32")
    sfx = name.rsplit("_", 1)[1]
    e = 4 if sfx == "f32" else 8
    dt = {"f32": "float32", "f64": "float64", "df": "df32"}[sfx]
    k3 = (4 + e) * B.width * B.n_pad + e * B.n_cols + e * B.n_pad
    held = inp["b_csr"].nnz - B.tail_n
    flops = (DF_FMA_FLOPS if sfx == "df" else 2) * held
    if name.startswith("butterfly_k3"):
        return k3, flops, dt
    return k3 + B.tail_n * (e + 8 + 3 * e), flops, dt


def build_bound_ms(inp: dict) -> float:
    """The column table's build at 3.35 TB/s: its stages' bytes."""
    return sum(butterfly_work(k, inp)[0] for k in BUILD_STAGES) \
        / HBM_BYTES_PER_S * 1e3


def say_build_split(inp: dict, calls: dict) -> None:
    """The column table's build on the card (B32's, on the int32 iota;
    replayed CUDA graphs): each stage alone (K1, K2, the decode) and the
    whole build (ops/butterfly_spmv.column_table), each beside its bound
    and its share of it."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    B = inp["B32"]
    for name in BUILD_STAGES:
        ms = time_call(calls[name][0], graph=True) * 1e3
        bound = butterfly_work(name, inp)[0] / HBM_BYTES_PER_S * 1e3
        _say("times", build_stage=name, ms=f"{ms:.4f}",
             bound_ms=f"{bound:.4f}", bound_share=f"{bound / ms:.3f}")
    ms = time_call(lambda: bs.column_table(B), iters=12, reps=3,
                   graph=True) * 1e3
    bound = build_bound_ms(inp)
    _say("times", column_table_build_ms=f"{ms:.4f}",
         build_bound_ms=f"{bound:.4f}", bound_share=f"{bound / ms:.3f}",
         z_elements_read=inp["b_zread"],
         table_mb=round(B.k3_col.numel() * 4 / 1e6, 1),
         input=f"iota {B.n_cols}")


def check_butterfly_counts(what: str, method: str, dtype: str, it: int,
                           counts: dict, restarts: int,
                           device: str = "cuda", layouts: int = 0) -> None:
    """The launches of a converged solve on the butterfly layout: one K1,
    one K2 and one decode per layout built inside the counted window
    (`layouts`: 1
    when the run builds its layout, 0 when it was built before the
    counters were reset), and per SpMV one K3 (its DF form in df32), twice
    per iteration and, per solver segment, for r0 and the true residual
    (pipe_bicgstab also w0 and t0); df32_passes once per iteration;
    nothing else. On the CPU nothing at all."""
    want = dict.fromkeys(counts, 0)
    if device != "cpu":
        k3 = "butterfly_k3_df" if dtype == "df32" else "butterfly_k3"
        want.update(dict.fromkeys(df32_passes(method, dtype), it))
        want.update(butterfly_k1=layouts, butterfly_k2=layouts,
                    butterfly_decode=layouts)
        spmvs = counts[k3]
        segs, rest = divmod(spmvs - 2 * it,
                            4 if method == "pipe_bicgstab" else 2)
        if rest == 0 and 1 <= segs <= restarts + 1:
            want[k3] = spmvs
    if counts != want:
        raise SmokeFailure(f"{what}: launches {counts} do not fit {it} "
                           f"iterations of {method} {dtype} on the "
                           f"butterfly layout ({layouts} built)")


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


def held_to_csr(csr, x, n_logical: int) -> tuple:
    """x (float32 or float64, on any device) held to its residual,
    computed apart from the butterfly kernels with torch's float64 CSR
    product of csr (the padded matrix): (relative residual of A x = A e,
    max|x - e|, Varah's bound ||r||_inf / margin on it, the margin), e
    the exact solution (1 on the n_logical rows, 0 on the identity pad
    rows)."""
    import numpy as np
    import torch
    exact = np.zeros(csr.nrows)
    exact[:n_logical] = 1.0
    A = torch_csr(csr, torch.float64, x.device)
    e = torch.as_tensor(exact, device=x.device)
    x = x.double()
    b = A @ e
    r = A @ x - b
    margin = dominance_margin(csr)
    return (float(r.norm() / b.norm()), float((x - e).abs().max()),
            float(r.abs().max()) / margin, margin)


def run_butterfly_cli(n: int, ell_prob, device: str = "cuda",
                      out: dict | None = None) -> dict:
    """`[butterfly]`: `solve --matrix uniform:n --dtype float32 --tol
    1e-6` through the CLI's own code with its defaults (--format auto,
    --reorder auto), counted as run_main_path: the ButterflyMatrix route,
    converged, the launches of check_butterfly_counts (the run builds its
    layout: one K1, one K2 and one decode), and n_iter within 2 of the
    same solve on gather-ELL. The solution is held to its
    residual, computed apart from the butterfly kernels with torch's
    float64 CSR product on ell_prob's CSR (the same padded matrix): the
    relative residual within 10 tol, and max|x - 1| within the bound that
    residual allows (Varah: ||r||_inf / dominance_margin). (At tol 1e-6
    the stopping rule leaves max|x - 1| ~1e-3 on this matrix at n = 1.6M
    in float32, growing with n; the JAX package's solves leave the same
    error as the port's, tests/test_torch_butterfly.py.) Returns the
    counts; `out`, when given, receives the run's n_iter."""
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
    relres, err, bound, margin = held_to_csr(csr, res.x, report["n"])
    it = report["total_iter"]
    ell_it = _ell_iters(ell_prob, "bicgstab", "float32", UNIFORM_TOL)
    if not (report["converged"] and report["layout"] == "ButterflyMatrix"
            and relres <= 10 * UNIFORM_TOL and err <= bound
            and abs(it - ell_it) <= 2):
        raise SmokeFailure(f"butterfly: {report}, max|x-1| {err:.3e} "
                           f"(bound {bound:.3e}), CSR relres {relres:.3e}, "
                           f"gather-ELL n_iter {ell_it}")
    check_butterfly_counts("butterfly", "bicgstab", "float32", it,
                           per_run(counts, "butterfly", once=BUILD_ONCE),
                           args.restarts, device, layouts=1)
    _say("butterfly", method="bicgstab", dtype="float32", tol=UNIFORM_TOL,
         layout=report["layout"], n=report["n"], nnz=report["nnz"],
         reordered=report["reordered"], n_iter=it, ell_n_iter=ell_it,
         converged=report["converged"], final_relres=report["final_relres"],
         true_relres=report["true_relres"], csr_f64_relres=f"{relres:.3e}",
         max_abs_x_minus_1=err, varah_bound=f"{bound:.3e}",
         dominance_margin=margin, io_time_s=report["io_time_s"],
         setup_s=report["setup_s"], solve_s=report["total_time_s"],
         launches=_launches(counts))
    if out is not None:
        out["n_iter"] = it
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
    """The butterfly SpMV on the card (K3 alone is timed in the kernels
    line): the whole SpMV (float32, float64 and DF; replayed CUDA
    graphs) beside its bound and torch's CSR product; the column table's
    build (say_build_split; once per layout) and the route's host
    seconds; the f32 and df32 classic iterations on the butterfly
    layout (tol=0 chains, eager and as replayed CUDA graphs) beside two
    SpMVs' bytes."""
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
        B, x = inp["B" + key], inp["bx" + key]
        bound = butterfly_work(f"butterfly_spmv_{sfx}", inp)[0] \
            / HBM_BYTES_PER_S * 1e3
        ms = time_call(lambda B=B, x=x: spmv(B, x), graph=True) * 1e3
        lib = None
        if sfx != "df":
            A = torch_csr(csr, x.dtype, x.device)
            lib = time_call(lambda A=A, x=x: A @ x) * 1e3
        _say("times", butterfly_spmv=sfx, ms=f"{ms:.4f}",
             bound_ms=f"{bound:.4f}", bound_share=f"{bound / ms:.3f}",
             torch_csr_ms=None if lib is None else f"{lib:.4f}",
             butterfly_over_csr=None if lib is None else f"{ms / lib:.3f}")
    say_build_split(inp, butterfly_kernel_calls(inp))
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


# --- the single-device tooling (slice 9a) ------------------------------------

def _write_mtx_lines(path, rows, cols, vals) -> None:
    with open(path, "wb") as f:
        f.write("".join([f"{r + 1} {c + 1} {v:.17g}\n" for r, c, v in
                         zip(rows.tolist(), cols.tolist(),
                             vals.tolist())]).encode())


def write_mtx(path, csr, procs: int = 8) -> float:
    """csr as a general real coordinate .mtx, the bytes
    io/mmio.write_matrix_market writes (`r c v` a line, 1-based, v as
    %.17g, which round-trips float64), its lines formatted by `procs`
    spawned processes into part files (one process formats ~1M lines a
    second), joined after. Returns the seconds."""
    import multiprocessing
    import shutil

    import numpy as np
    t0 = time.perf_counter()
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
    edges = np.linspace(0, csr.nnz, procs + 1).astype(np.int64)
    parts = [Path(f"{path}.part{i}") for i in range(procs)]
    ctx = multiprocessing.get_context("spawn")
    workers = [ctx.Process(target=_write_mtx_lines,
                           args=(part, rows[lo:hi], csr.col[lo:hi],
                                 csr.val[lo:hi]))
               for part, lo, hi in zip(parts, edges[:-1], edges[1:])]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        if any(w.exitcode != 0 for w in workers):
            raise SmokeFailure(f"write_mtx: a formatter failed: "
                               f"{[w.exitcode for w in workers]}")
        with open(path, "wb") as f:
            f.write(b"%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{csr.shape[0]} {csr.shape[1]} {csr.nnz}\n".encode())
            for part in parts:
                with open(part, "rb") as g:
                    shutil.copyfileobj(g, f, 1 << 24)
    finally:
        for w in workers:
            if w.is_alive():
                w.kill()
                w.join()
        for part in parts:
            part.unlink(missing_ok=True)
    return time.perf_counter() - t0


def same_csr(a, b) -> bool:
    import numpy as np
    return (a.shape == b.shape and a.ptr.dtype == b.ptr.dtype
            and a.val.dtype == b.val.dtype
            and np.array_equal(a.ptr, b.ptr) and np.array_equal(a.col, b.col)
            and np.array_equal(a.val, b.val))


def parse_mtx(path, csr, use_native: bool = True) -> tuple[float, float]:
    """(parse seconds, COO-to-CSR seconds) of `path` through the reader
    (io/mmio.read_matrix_market, the native parser unless use_native is
    False); the CSR must equal csr bit for bit."""
    from mpi_bicgstab_tpu_torch.io.mmio import read_matrix_market
    from mpi_bicgstab_tpu_torch.ops.sparse import COOMatrix, coo_to_csr
    t0 = time.perf_counter()
    rows, cols, vals, shape = read_matrix_market(str(path),
                                                 use_native=use_native)
    t1 = time.perf_counter()
    got = coo_to_csr(COOMatrix(rows, cols, vals, shape))
    t2 = time.perf_counter()
    if not same_csr(got, csr):
        raise SmokeFailure(f"{path}: the parsed CSR differs from the "
                           f"generator's (use_native={use_native})")
    return t1 - t0, t2 - t1


def _main_json(argv) -> tuple[int, str]:
    """(exit code, standard output) of cli.main(argv)."""
    import contextlib
    import io

    from mpi_bicgstab_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    return code, out.getvalue()


def run_mtx_path(csr, it_f32: int, workdir, device: str = "cuda") -> dict:
    """`[mtx]`: csr (transport_like(N_MAIN), the reference's Transport
    shape) written as a .mtx (write_mtx), parsed by the native reader bit
    for bit back into csr, then `solve --matrix X.mtx --dtype float32
    --tol 1e-6 --json --repeat 2` through cli.main, every launch counter
    set to 0 just before and read just after: the JSON line's keys, the
    fused f32 route's launches in each of its 3 runs, and total_iter
    equal to the `[f32]` phase's it_f32. Returns the counts."""
    from mpi_bicgstab_tpu_torch.io import native
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "transport_like.mtx"
    write_s = write_mtx(path, csr)
    size = path.stat().st_size
    parse_s, csr_s = parse_mtx(path, csr)
    if native.library.cache_info().currsize != 1:
        raise SmokeFailure("mtx: the reader did not load the native parser")
    reset_counts()
    code, out = _main_json(["solve", "--matrix", str(path), "--dtype",
                            "float32", "--tol", "1e-6", "--json", "--repeat",
                            "2", "--device", device])
    counts = read_counts()
    path.unlink()
    rep = json.loads(out.strip().splitlines()[-1])
    from mpi_bicgstab_tpu_torch.cli import SOLVE_JSON_KEYS
    if not (code == 0 and tuple(rep) == SOLVE_JSON_KEYS
            and rep["total_iter"] == it_f32 and rep["converged"]
            and rep["n"] == csr.nrows and rep["nnz"] == csr.nnz):
        raise SmokeFailure(f"mtx: exit {code}, {rep}; [f32] took {it_f32} "
                           f"iterations")
    check_counts("bicgstab", "float32", rep["total_iter"],
                 per_run(counts, "mtx", runs=3), 2, device)
    _say("mtx", n=csr.nrows, nnz=csr.nnz, file_bytes=size,
         write_s=round(write_s, 3), parse_native_s=round(parse_s, 3),
         parse_mb_per_s=round(size / parse_s / 1e6, 1),
         parse_entries_per_s=f"{csr.nnz / parse_s:.4e}",
         coo_to_csr_s=round(csr_s, 3), bit_equal=True,
         cli_io_time_s=rep["io_time_s"], n_iter=rep["total_iter"],
         f32_n_iter=it_f32, solve_s=rep["total_time_s"],
         launches=_launches(counts),
         seconds=round(time.perf_counter() - t_phase, 3))
    return counts


def _fields_equal(a, b, path: str = "op") -> None:
    """Every field of two layouts (derived ones too) equal bit for bit,
    on the same device; SmokeFailure naming the first that differs."""
    import dataclasses

    import torch
    if dataclasses.is_dataclass(a):
        if type(a) is not type(b):
            raise SmokeFailure(f"{path}: {type(a).__name__} against "
                               f"{type(b).__name__}")
        for f in dataclasses.fields(a):
            _fields_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{path}.{f.name}")
    elif torch.is_tensor(a):
        if not (a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device
                and (same_bits(a, b) if a.is_floating_point()
                     else torch.equal(a, b))):
            raise SmokeFailure(f"{path}: the loaded tensor differs")
    elif a != b:
        raise SmokeFailure(f"{path}: {a!r} against {b!r}")


def run_layout_cache_path(name: str, A, csr, build_s: float, tol: float,
                          workdir, device: str = "cuda") -> None:
    """`[layout_cache]`: the float32 layout A of csr (built on the card)
    saved to the layout cache and loaded back on the card
    (utils/opcache.py; the load rebuilds the derived fields there: a
    butterfly's k3_col by K1, K2 and the decode, a window's rc_*): every
    field, derived ones included, bit-equal to A's, and a float32 solve
    at `tol` from each: the same n_iter, x bit-equal."""
    import shutil

    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils import opcache
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    t_phase = time.perf_counter()
    cache = workdir / "layout_cache"
    key = opcache.operator_key(csr, format=name, dtype="float32")
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    path = opcache.save_operator(str(cache), key, A)
    save_s = time.perf_counter() - t0
    if path is None:
        raise SmokeFailure(f"layout_cache: {name}: the save failed")
    size = Path(path).stat().st_size
    t0 = time.perf_counter()
    L = opcache.load_operator(str(cache), key, device)
    sync()
    load_s = time.perf_counter() - t0
    shutil.rmtree(cache)
    if L is None:
        raise SmokeFailure(f"layout_cache: {name}: the load failed")
    _fields_equal(A, L)
    b = torch.as_tensor(csr.matvec(np.ones(csr.nrows)), dtype=torch.float32,
                        device=device)
    cfg = SolverConfig(tol=tol, dtype=torch.float32)
    r0, r1 = (solve(op, b, method="bicgstab", cfg=cfg) for op in (A, L))
    if not (r0.n_iter == r1.n_iter and bool(r1.converged)
            and same_bits(r0.x, r1.x)):
        raise SmokeFailure(f"layout_cache: {name}: the solve from the "
                           f"loaded layout differs (n_iter {r1.n_iter} "
                           f"against {r0.n_iter})")
    _say("layout_cache", layout=type(A).__name__, matrix=name, n=csr.nrows,
         file_mb=round(size / 1e6, 1), save_s=round(save_s, 3),
         load_s=round(load_s, 3), host_build_s=round(build_s, 3),
         fields="bit-equal", n_iter=r1.n_iter, x="bit-equal",
         seconds=round(time.perf_counter() - t_phase, 3))


BENCH_TIMES = ("spmv_s", "time_per_iter_s", "cheby_xla_apply_s",
               "cheby_fused_apply_s", "batched8_single_time_per_iter_s",
               "batched8_time_per_iter_s")


def check_bench_line(line: dict, inp: dict) -> dict:
    """The bench line's times finite and positive, and each rate of bytes
    the line lets us reckon at most the HBM peak: the DIA SpMV's (the
    band, x and y once), the batched iteration's (K1b, K2b and K3b), the
    shift update's (the [S, n] state read and written once per
    iteration, 4 S n elem bytes (shift_update_GBps); the blocked path
    (shift_block L > 0) passes over it once per L iterations, so 1 / L of
    that). (The JAX package's line keeps one time_per_iter_s: the shifted
    section's overwrites the iter section's.) Returns those rates,
    bytes/s."""
    import math
    bad = {k: line.get(k) for k in BENCH_TIMES
           if not (isinstance(line.get(k), float)
                   and math.isfinite(line[k]) and line[k] > 0)}
    if bad:
        raise SmokeFailure(f"bench: times not finite and positive: {bad}")
    A = inp["A32"]
    n, W = A.n_rows, A.n_diags
    L = line["shift_block"]
    rates = {"spmv": 4 * (W * n + 2 * n) / line["spmv_s"],
             "batched8": sum(work(k, inp)[0] for k in (
                 "fused_k1b", "fused_k2b", "fused_k3b"))
             / line["batched8_time_per_iter_s"],
             "shift_update": line["shift_update_GBps"] * 1e9
             / (L if L > 0 else 1)}
    over = {k: v for k, v in rates.items() if not v <= HBM_BYTES_PER_S}
    if over:
        raise SmokeFailure(f"bench: rates above the HBM peak: {over}")
    return rates


def run_tools(inp: dict) -> None:
    """`[tools]`: `info` (its JSON census on one line), `selftest` on the
    card (every check PASS, exit 0) and `bench --matrix
    transport-like:N_MAIN --dtype float32 --what
    spmv,iter,batched,cheby,shifted --json` through cli.main, the line as
    it comes, held by check_bench_line."""
    import torch
    t0 = time.perf_counter()
    code, out = _main_json(["info"])
    info = json.loads(out)
    if code != 0 or info["devices"][:1] != [torch.cuda.get_device_name(0)]:
        raise SmokeFailure(f"info: exit {code}: {info}")
    _say("tools", info=json.dumps(info, separators=(",", ":")),
         seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    code, out = _main_json(["selftest"])
    lines = out.strip().splitlines()
    for line in lines:
        if line.strip():
            print(f"[tools] selftest: {line}")
    from mpi_bicgstab_tpu_torch.cli import SELFTEST
    passed = [ln for ln in lines if ln.startswith("PASS")]
    if code != 0 or len(passed) != len(SELFTEST):
        raise SmokeFailure(f"selftest: exit {code}, {len(passed)} of "
                           f"{len(SELFTEST)} checks passed")
    _say("tools", selftest="every check PASS", exit=code,
         seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    code, out = _main_json(["bench", "--matrix", f"transport-like:{N_MAIN}",
                            "--dtype", "float32", "--what",
                            "spmv,iter,batched,cheby,shifted", "--json"])
    print(f"[tools] bench: {out.strip()}", flush=True)
    line = json.loads(out.strip().splitlines()[-1])
    if code != 0:
        raise SmokeFailure(f"bench: exit {code}")
    rates = check_bench_line(line, inp)
    _say("tools", bench_rates_tb_per_s=json.dumps(
        {k: round(v / 1e12, 4) for k, v in rates.items()},
        separators=(",", ":")), hbm_peak_tb_per_s=HBM_BYTES_PER_S / 1e12,
        seconds=round(time.perf_counter() - t0, 3))
    run_bench_dist()


def run_bench_dist(n: int = N_MAIN, device: str = "cuda",
                   iters: int = 12) -> dict:
    """`[tools]`: `bench --devices 1 --what overlap,scaling` in its own
    process (the CLI spawns the rank, whose standard output is the
    line): the JAX package's overlap and scaling keys, finite positive
    times, and the one-rank labels (no fabric exercised)."""
    import math
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_bicgstab_tpu_torch", "bench", "--matrix",
         f"transport-like:{n}", "--dtype", "float32", "--devices", "1",
         "--what", "overlap,scaling", "--iters", str(iters), "--device",
         device], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        raise SmokeFailure(f"bench --devices 1: exit {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    line = json.loads(lines[-1])
    times = ("time_per_iter_overlap_s", "time_per_iter_serialized_s",
             "time_per_iter_s_d1")
    label = "single-device (no fabric exercised)"
    if not (all(math.isfinite(line[k]) and line[k] > 0 for k in times)
            and line["scaling_devices"] == [1]
            and line["scaling_fabric"] == label
            and line["overlap_fabric"] == label):
        raise SmokeFailure(f"bench --devices 1 --what overlap,scaling: "
                           f"{line}")
    print(f"[tools] bench_dist: {lines[-1]}", flush=True)
    out = {k: line[k] for k in ("overlap_gain", "speedup_d1")}
    _say("tools", bench_devices=1, **out,
         seconds=round(time.perf_counter() - t0, 3))
    return line


# --- the distributed layer (slice 8a): one rank of a real process group ------

# phase: (method, dtype, tol, halo) through parallel/driver.solve_distributed
# on transport_like(N_MAIN) partitioned as the CLI's --devices path does
# (DIA halo mode); each beside the port's single-device unfused solve
DIST_PATHS = {"dist": ("bicgstab", "float32", 1e-6, "allgather"),
              "dist_ca": ("ca_bicgstab", "float32", 1e-6, "allgather"),
              "dist_pipe": ("pipe_bicgstab", "float32", 1e-6, "allgather"),
              "dist_f64": ("bicgstab", "float64", 1e-10, "allgather"),
              "dist_df32": ("bicgstab", "df32", 1e-10, "allgather"),
              "dist_ring": ("bicgstab", "float32", 1e-6, "ring")}
# (method, dtype) -> the halo-fused route's launches (solvers/fused_dist.py):
# its SpMV kernel, that kernel's launches a segment (the set-up SpMVs and
# the exit true residual), and the passes launched once an iteration
DIST_ROUTES = {
    ("bicgstab", "float32"): ("dia_spmv", 2,
                              ("fused_k1", "fused_k2", "fused_k3")),
    ("ca_bicgstab", "float32"): ("dia_spmv", 3,
                                 ("fused_ca_k1", "fused_ca_k2")),
    ("pipe_bicgstab", "float32"): ("dia_spmv", 4,
                                   ("fused_phase_a", "fused_phase_b")),
    ("bicgstab", "df32"): ("dia_spmv_df", 2,
                           ("fused_k1_df", "fused_k2_df", "fused_k3_df"))}
DIST_LANES, DIST_SHIFT_TOL, PROFILE_SIGMA_LEN = 8, 1e-10, 64
DIST_CHAINS = (8, 48)    # tol=0 chain lengths of the one-rank split
# the plain twins a distributed path could reach: (module, names)
TWINS = (("mpi_bicgstab_tpu_torch.ops.cuda_spmv",
          ("dia_spmv_plain", "dia_spmv_df_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_fused_classic",
          ("fused_k1_plain", "fused_k2_plain", "fused_k3_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_fused_ca",
          ("fused_ca_k1_plain", "fused_ca_k2_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_fused_pipe",
          ("fused_phase_a_plain", "fused_phase_b_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_fused_classic_df",
          ("fused_k1_df_plain", "fused_k2_df_plain", "fused_k3_df_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_classic_df_bodies",
          tuple(k + "_plain" for k in CLASSIC_BODIES)),
         ("mpi_bicgstab_tpu_torch.ops.window_spmv",
          ("window_rows_plain", "window_rows_df_plain")),
         ("mpi_bicgstab_tpu_torch.ops.butterfly_spmv",
          ("k1_plain", "k2_plain", "decode_plain", "k3_plain",
           "k3_df_plain")),
         ("mpi_bicgstab_tpu_torch.ops.cuda_shift_update",
          ("fused_shift_update_df_plain",)),
         ("mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv",
          ("batched_dia_spmv_plain",)),
         ("mpi_bicgstab_tpu_torch.ops.cuda_fused_batched",
          ("fused_k1b_plain", "fused_k2b_plain", "fused_k3b_plain")))


def init_world(device: str) -> None:
    """A process group of one rank in this process unless one is up:
    NCCL on the card, gloo on the CPU, met through a file:// store in the
    work directory (no port)."""
    import os

    import torch.distributed as dist
    if dist.is_initialized():
        return
    store = _workdir() / f"dist_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)


def end_world() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _on_card(x) -> bool:
    dev = getattr(x, "device", None)
    return getattr(dev, "type", None) == "cuda"


@contextlib.contextmanager
def no_twin_on_card():
    """Within: any plain twin of TWINS given a CUDA tensor (or a layout
    on the card) raises SmokeFailure, so a phase shows that its path ran
    the kernels and no plain version on the card."""
    import importlib
    saved = []

    def guarded(name, fn):
        def twin(*args, **kw):
            if any(_on_card(a) for a in (*args, *kw.values())):
                raise SmokeFailure(f"{name}, a plain twin, ran on the card")
            return fn(*args, **kw)
        return twin

    for mod_name, names in TWINS:
        mod = importlib.import_module(mod_name)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, guarded(name, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_dist_counts(what: str, kernel: str, it: int, counts: dict,
                      restarts: int, lanes: int = 1, per_op: int = 1,
                      exit_launches: int = 0, device: str = "cuda",
                      also=None, per_iter: int = 2, per_seg: int = 2,
                      passes=()) -> None:
    """The launches of converged distributed classic solves (`lanes`
    right-hand sides, `it` iterations over every lane and restart
    segment): `kernel` per_op times per operator application, per_iter
    applications per iteration and per_seg per segment (r0, the true
    residual and any other set-up SpMV), 1 to 1 + restarts segments a
    lane, and exit_launches more; each of `passes` (a fused route's,
    per_iter 0) once per iteration; `also` the other kernels' exact
    counts; nothing else. On the CPU nothing at all."""
    if device == "cpu":
        if any(counts.values()):
            raise SmokeFailure(f"{what}: launches {counts} on the CPU")
        return
    want = dict.fromkeys(counts, 0)
    want.update(also or {})
    want.update(dict.fromkeys(passes, it))
    applied, rest = divmod(counts[kernel] - exit_launches, per_op)
    segs, rest2 = divmod(applied - per_iter * it, per_seg)
    ok = not rest and not rest2 and lanes <= segs <= lanes * (restarts + 1)
    bad = {k: (v, want[k]) for k, v in counts.items()
           if k != kernel and v != want[k]}
    if bad or not ok:
        raise SmokeFailure(f"{what}: launches {counts} do not fit {it} "
                           f"iterations over {lanes} lane(s) ({bad})")


def _true_relres(csr, b, x) -> float:
    """||b - A x|| / ||b|| with A the host CSR and x in float64."""
    import numpy as np

    from mpi_bicgstab_tpu_torch.parallel.launch import result_array
    x = result_array(_host(x))[: csr.nrows]
    return float(np.linalg.norm(b - csr.matvec(x)) / np.linalg.norm(b))


def _host(x):
    from mpi_bicgstab_tpu_torch.parallel.launch import to_host
    return to_host(x)


def _dist_solve(part, b, n_devices, device, **kw):
    """solve_distributed on this rank, counted from the shard's placement
    (a window shard derives its copy and a butterfly shard routes its
    table there) to the result, under no_twin_on_card. Returns (result,
    counts, its per-iteration times, solve_times)."""
    from mpi_bicgstab_tpu_torch.parallel.driver import (put_partitioned,
                                                        solve_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    mesh = make_row_mesh(n_devices, device)
    reset_counts()
    with no_twin_on_card():
        shard = put_partitioned(part, mesh)
        res = solve_distributed(shard, b, mesh=mesh, **kw)
        bool(res.converged)
    counts = read_counts()

    def run():
        bool(solve_distributed(shard, b, mesh=mesh, **kw).converged)
    return res, counts, solve_times(run, res.n_iter, device)


def solve_times(run, it, device: str) -> dict:
    """Eager and device ms per iteration of a solve run() (set-up and
    exit included, over its `it` iterations, summed over lanes): one more
    run's wall time, and on the card its kernels' device time by
    torch.profiler (NCCL's included) in a run after that."""
    t0 = time.perf_counter()
    run()
    eager = (time.perf_counter() - t0) * 1e3 / max(it, 1)
    dev = "not measured"
    if device == "cuda":
        dev = f"{_kernel_ms(run) / max(it, 1):.4f}"
    return {"eager_ms_per_iter": f"{eager:.4f}", "device_ms_per_iter": dev}


def _unfused_iters(A, b, method: str, cfg) -> int:
    """n_iter of the port's single-device unfused solve A x = b (the
    classic solver over layout.spmv, with api's restarts), A a device
    layout, b its right-hand side there."""
    from mpi_bicgstab_tpu_torch.api import _restarted
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.ops.precision import vzeros_like
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS

    def once(x0, c):
        return CLASSIC_SOLVERS[method](lambda v: spmv(A, v), Comm(), b, x0,
                                       c)

    return _restarted(once, cfg, once(vzeros_like(b), cfg)).n_iter


def _dtype(name: str):
    import torch
    return name if name == "df32" else getattr(torch, name)


def _say0(phase: str, **fields) -> None:
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _say(phase, **fields)


def run_dist_path(phase: str, csr, n_devices: int = 1,
                  device: str = "cuda") -> dict:
    """A DIST_PATHS phase on every rank of the world: converged, the true
    residual (float64, host CSR) within 10 tol, n_iter within 2 of the
    single-device unfused solve, the launches of check_dist_counts (the
    DIA SpMV kernel, halo form, or the DF SpMV, and a DIST_ROUTES
    route's passes). On a halo-fused route with one rank, n_iter and the
    history equal the single-device fused route's (api.solve): the same
    passes over the columns [0, n), reductions over one rank. Returns a
    summary."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    method, dtype, tol, halo = DIST_PATHS[phase]
    dt = _dtype(dtype)
    cfg = SolverConfig(tol=tol, max_iter=1000, dtype=dt)
    part = dist_partition(csr, n_devices, dt)
    if part.dia_mode != "halo":
        raise SmokeFailure(f"{phase}: partition in {part.dia_mode} mode")
    b = csr.matvec(np.ones(csr.nrows))
    res, counts, times = _dist_solve(part, b, n_devices, device,
                                     method=method, cfg=cfg, halo=halo)
    it = res.n_iter
    route = DIST_ROUTES.get((method, dtype))
    if route is None:
        check_dist_counts(phase, "dia_spmv", it, counts, cfg.restarts,
                          device=device)
    else:
        check_dist_counts(phase, route[0], it, counts, cfg.restarts,
                          device=device, per_iter=0, per_seg=route[1],
                          passes=route[2])
    true = _true_relres(csr, b, res.x)
    prob = build_problem(csr, dtype=dt, multiple=1, device=device)
    single = _unfused_iters(prob.A, prob.b, method, cfg)
    fused = {}
    if route is not None and n_devices == 1:
        ref = solve(prob.A, prob.b, method=method, cfg=cfg)
        same = ref.n_iter == it and torch.equal(ref.history[:it].cpu(),
                                                res.history[:it].cpu())
        fused = {"single_device_fused_n_iter": ref.n_iter,
                 "history_equals_single_device_fused": same}
        if not same:
            raise SmokeFailure(f"{phase}: one rank took {it} iterations, "
                               f"the single-device fused route "
                               f"{ref.n_iter}, or their histories differ")
    if not bool(res.converged) or true > 10 * tol or abs(it - single) > 2:
        raise SmokeFailure(f"{phase}: converged {bool(res.converged)}, "
                           f"true relres {true:.3e} (tol {tol}), n_iter "
                           f"{it} against {single} single-device")
    out = dict(method=method, dtype=dtype, tol=tol, halo=halo,
               ranks=n_devices, halo_width=part.halo,
               route="halo-fused" if route else "unfused", n_iter=it,
               single_device_unfused_n_iter=single, **fused, **times,
               true_relres_f64=f"{true:.3e}", launches=_launches(counts))
    _say0(phase, **out)
    return {**out, "counts": counts}


def run_dist_layout(phase: str, csr, n_devices: int = 1,
                    device: str = "cuda", tol: float = 1e-6,
                    layout=None) -> dict:
    """`[dist_window]` (fmt window: kernel 23 once per SpMV) or
    `[dist_butterfly]` (K3 once per SpMV over the gathered iterate; the
    column table built once, inside the count): f32 classic, converged,
    the true residual within 10 tol, n_iter within 2 of the single-
    device unfused solve on the same layout (`layout`, the float32
    layout of csr already on the device, or built here)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    fmt = phase.removeprefix("dist_")
    cfg = SolverConfig(tol=tol, max_iter=1000, dtype=torch.float32)
    t0 = time.perf_counter()
    part = partition_csr(csr, n_devices, dtype=torch.float32, format=fmt)
    host_s = time.perf_counter() - t0
    b = csr.matvec(np.ones(csr.nrows))
    res, counts, times = _dist_solve(part, b, n_devices, device, cfg=cfg)
    it = res.n_iter
    if fmt == "window":
        kernel, also = "window_rows", {}
    else:
        kernel = "butterfly_k3"
        also = dict.fromkeys(BUILD_ONCE, 1)
    check_dist_counts(phase, kernel, it, counts, cfg.restarts,
                      device=device, also=also)
    true = _true_relres(csr, b, res.x)
    if layout is None:
        layout = build_problem(csr, dtype=torch.float32, multiple=1,
                               device=device, format=fmt).A
    single = _unfused_iters(layout, torch.as_tensor(
        b, dtype=torch.float32, device=device), "bicgstab", cfg)
    if not bool(res.converged) or true > 10 * tol or abs(it - single) > 2:
        raise SmokeFailure(f"{phase}: converged {bool(res.converged)}, "
                           f"true relres {true:.3e}, n_iter {it} against "
                           f"{single} single-device")
    out = dict(layout=fmt, ranks=n_devices, n=csr.nrows, n_iter=it,
               single_device_unfused_n_iter=single, **times,
               true_relres_f64=f"{true:.3e}",
               partition_host_s=round(host_s, 3), launches=_launches(counts))
    _say0(phase, **out)
    return {**out, "counts": counts}


def run_dist_shifted(csr, n_devices: int = 1, device: str = "cuda",
                     S: int = S_MAIN, seed: int = SEED_MAIN) -> dict:
    """`[dist_shifted]`: solve_shifted_distributed with the flagship
    ladder (S shifts, switching, df32 at DIST_SHIFT_TOL): every shift
    converged, every shift's true residual (float64, on the device)
    within 100 tol, the launches of check_shifted_counts (the DF shift
    update, kernel 18, once per iteration)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.parallel.driver import \
        solve_shifted_distributed
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    sigma = flagship_ladder(S)
    b = csr.matvec(np.ones(csr.nrows)) + sigma[seed]
    part = dist_partition(csr, n_devices, "df32")
    mesh = make_row_mesh(n_devices, device)
    cfg = ShiftedConfig(tol=DIST_SHIFT_TOL, max_iter=1000, dtype="df32")
    reset_counts()
    t0 = time.perf_counter()
    with no_twin_on_card():
        res = solve_shifted_distributed(part, b, sigma, seed=seed, cfg=cfg,
                                        mesh=mesh)
        float(res.final_relres)
    secs = time.perf_counter() - t0
    counts = read_counts()
    it = res.n_iter
    worst = shifted_residuals(res.x_set, sigma, build_problem(
        csr, dtype=torch.float64, multiple=1, device=device).A,
        torch.as_tensor(b, device=device))
    all_stop, final_seed = bool(res.stop_flags.all()), res.final_seed
    del res
    times = solve_times(lambda: float(solve_shifted_distributed(
        part, b, sigma, seed=seed, cfg=cfg, mesh=mesh).final_relres), it,
        device)
    if device == "cpu":
        check_dist_counts("dist_shifted", "shift_update_df", it, counts, 0,
                          device=device)
    else:
        check_shifted_counts("dist_shifted", "df32", it, counts)
    if not all_stop or worst > 100 * DIST_SHIFT_TOL:
        raise SmokeFailure(f"dist_shifted: all converged {all_stop}, "
                           f"worst shift's true residual {worst:.3e}")
    out = dict(shifts=S, seed=seed, dtype="df32", ranks=n_devices,
               n_iter=it, final_seed=final_seed, **times,
               worst_shift_true_relres=f"{worst:.3e}",
               solve_s=round(secs, 3), launches=_launches(counts))
    _say0("dist_shifted", **out)
    return {**out, "counts": counts}


_PARTS: dict = {}


def dist_partition(csr, n_devices: int, dtype):
    """partition_csr(csr, n_devices, dtype), built once per run for each
    matrix, rank count and dtype (the distributed phases share them)."""
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    key = (id(csr), n_devices, str(dtype))
    if key not in _PARTS:
        _PARTS[key] = (csr, partition_csr(csr, n_devices, dtype=dtype))
    return _PARTS[key][1]


def _chain_ms(make_chain, device: str) -> dict:
    """Eager and device ms per iteration of tol = 0 chains (make_chain(K)
    runs K iterations) of DIST_CHAINS lengths: the slope of CUDA-event
    (on the CPU host-clock) times, and on the card the slope of the
    kernels' device time by torch.profiler."""
    from mpi_bicgstab_tpu_torch.benchmarks.runner import _slope_time
    K1, K2 = DIST_CHAINS
    eager = _slope_time(make_chain, K1, K2, reps=3, device=device) * 1e3
    dev = "not measured"
    if device == "cuda":
        k1, k2 = (_kernel_ms(make_chain(K)) for K in (K1, K2))
        dev = f"{(k2 - k1) / (K2 - K1):.4f}"
    return {"eager_ms_per_batch_iter": f"{eager:.4f}",
            "device_ms_per_batch_iter": dev,
            "chains": f"tol=0x{K1},{K2}"}


def run_dist_batched(csr, n_devices: int = 1, device: str = "cuda",
                     k: int = DIST_LANES, tol: float = 1e-6) -> dict:
    """`[dist_batched]`: solve_batched_distributed with k float32 lanes
    (batched_rhs) on transport_like's DIA halo partition, the blocked
    halo-fused route (solvers/batched_dist.py): every lane converged with
    its true residual within 10 tol; on the card K1b, K2b and K3b once per
    batch iteration for all k lanes (the largest n_iter) and kernel 19
    twice (r0 and the exit true residuals), nothing else; 3 reductions per
    batch iteration for all lanes (comm.counted: 3 per iteration, r0's,
    the exit's and the gather of X); on one rank n_iter, history and x
    bit-equal to the single-device fused batch (api.solve_batched, the
    `[batched]` route); eager and device ms per batch iteration."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.api import solve_batched
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.parallel.comm import counted
    from mpi_bicgstab_tpu_torch.parallel.driver import (
        put_partitioned, solve_batched_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    B, _ = batched_rhs(csr, k)
    part = dist_partition(csr, n_devices, torch.float32)
    mesh = make_row_mesh(n_devices, device)
    cfg = SolverConfig(tol=tol, max_iter=1000, dtype=torch.float32)
    reset_counts()
    with no_twin_on_card():
        shard = put_partitioned(part, mesh)
        res, issued = counted(solve_batched_distributed, shard, B, cfg=cfg,
                              mesh=mesh)
        conv = res.converged.cpu().numpy()
    counts = read_counts()
    its = [int(v) for v in res.n_iter]
    it = max(its)
    want = dict.fromkeys(counts, 0)
    if device == "cuda":
        want.update(fused_k1b=it, fused_k2b=it, fused_k3b=it,
                    batched_dia_spmv=2)
    if counts != want or issued != 3 * it + 3:
        bad = {c: (v, want[c]) for c, v in counts.items() if v != want[c]}
        raise SmokeFailure(f"dist_batched: launches (got, expected) {bad}, "
                           f"{issued} collectives for {it} iterations "
                           f"(3 per iteration + 3 expected)")
    trues = [_true_relres(csr, B[j], res.x[j]) for j in range(k)]
    if not conv.all() or max(trues) > 10 * tol:
        raise SmokeFailure(f"dist_batched: converged {conv.tolist()}, "
                           f"true residuals {trues}")
    same = {}
    if n_devices == 1:
        prob = build_problem(csr, dtype=torch.float32, multiple=1,
                             device=device)
        ref = solve_batched(prob.A, torch.as_tensor(
            B, dtype=torch.float32, device=device), cfg=cfg)
        eq = (ref.n_iter.tolist() == its
              and np.array_equal(ref.history.cpu().numpy(),
                                 res.history.cpu().numpy(), equal_nan=True)
              and np.array_equal(ref.x.cpu().numpy(),
                                 res.x.cpu().numpy()[:, :csr.nrows]))
        if not eq:
            raise SmokeFailure(f"dist_batched: one rank's n_iter {its} "
                               f"against the single-device batch's "
                               f"{ref.n_iter.tolist()}, or their histories "
                               f"or x differ")
        same = {"equals_single_device_fused_batch": "bit for bit"}

    def chain(K):
        c = cfg.replace(tol=0.0, max_iter=K)
        return lambda: solve_batched_distributed(shard, B, cfg=c, mesh=mesh)

    out = dict(lanes=k, ranks=n_devices, route="halo-fused batch",
               n_iter=its, collectives=issued,
               reductions_per_batch_iter=3, **same, **_chain_ms(chain,
                                                                device),
               max_true_relres_f64=f"{max(trues):.3e}",
               launches=_launches(counts))
    _say0("dist_batched", **out)
    return {**out, "counts": counts}


def check_split_phase(n_devices: int = 1, device: str = "cuda",
                      m: int = 7) -> dict:
    """The split-phase reductions and gathers of parallel/comm.Comm on
    every rank of the world: Comm.start(x), a matrix product on the
    device while it is in flight, then wait(), equal bit for bit to the
    serialized Comm's (every collective waited at once) and to the ranks'
    values summed in rank order here (each rank makes every rank's seeded
    values): float32, float64 and a double-float pair of [m]; the
    gathers' concatenation bit for bit."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_from_f64,
                                                      df_renorm, df_sum)
    from mpi_bicgstab_tpu_torch.parallel.driver import row_comm
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    mesh = make_row_mesh(n_devices, device)
    if not mesh.member:
        return None
    dev = mesh.device
    comm, ser = row_comm(mesh), row_comm(mesh).with_serialize(True)

    def value(r, kind):
        x = np.random.default_rng(100 + r).standard_normal(m)
        if kind == "df32":
            return df_from_f64(x, dev)
        return torch.as_tensor(x, dtype=getattr(torch, kind), device=dev)

    def host(v):
        return (torch.stack([v.hi, v.lo]) if hasattr(v, "hi") else v).cpu()

    busy = torch.randn(512, 512, device=dev)
    for kind in ("float32", "float64", "df32"):
        mine = value(mesh.row_index, kind)
        pend = comm.start(mine)
        busy = busy @ busy / 512.0         # device work beside it
        split = pend.wait()
        blocking = ser.allreduce(mine)
        parts = [value(r, kind) for r in range(n_devices)]
        if kind == "df32":
            st = DF(torch.stack([p.hi for p in parts]),
                    torch.stack([p.lo for p in parts]))
            ref = df_renorm(df_sum(st, axis=0))
        else:
            ref = parts[0]
            for p in parts[1:]:
                ref = ref + p
        gathered = comm.allgather(mine)
        cat = (DF(torch.cat([p.hi for p in parts]),
                  torch.cat([p.lo for p in parts])) if kind == "df32"
               else torch.cat(parts))
        if not (torch.equal(host(split), host(blocking))
                and torch.equal(host(split), host(ref))
                and torch.equal(host(gathered), host(cat))):
            raise SmokeFailure(f"split phase: the {kind} reduction or "
                               f"gather differs from the blocking form or "
                               f"the rank-order sum")
    return {"split_phase": "bit-equal to blocking and rank-order sums",
            "kinds": "float32,float64,df32"}


def run_dist_overlap(csr, n_devices: int = 1, device: str = "cuda",
                     tol: float = 1e-6, iters: int = 24) -> dict:
    """`[dist_overlap]`: check_split_phase, then pipelined BiCGStab in
    float32 on transport_like's DIA partition, the unfused distributed
    solver with its reductions overlapped (solve_distributed(unfused=
    True)) against serialize_comm: n_iter, history and x bit-equal, the
    DIA SpMV kernel's halo form the only kernel (2 per iteration, 4 per
    segment); then bench_overlap's line (both sides unfused), with
    overlap_gain and the label of what the collectives crossed (on one
    rank no fabric)."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import bench_overlap
    from mpi_bicgstab_tpu_torch.parallel.driver import (put_partitioned,
                                                        solve_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    split = check_split_phase(n_devices, device)
    part = dist_partition(csr, n_devices, torch.float32)
    mesh = make_row_mesh(n_devices, device)
    b = csr.matvec(np.ones(csr.nrows))
    cfg = SolverConfig(tol=tol, max_iter=1000, dtype=torch.float32)
    reset_counts()
    with no_twin_on_card():
        shard = put_partitioned(part, mesh)
        over = solve_distributed(shard, b, method="pipe_bicgstab", cfg=cfg,
                                 mesh=mesh, unfused=True)
        ser = solve_distributed(shard, b, method="pipe_bicgstab",
                                cfg=cfg.replace(serialize_comm=True),
                                mesh=mesh)
        bool(ser.converged)
    counts = read_counts()
    it = over.n_iter
    check_dist_counts("dist_overlap", "dia_spmv", 2 * it, counts,
                      cfg.restarts, lanes=2, per_seg=4, device=device)
    same = (over.n_iter == ser.n_iter
            and np.array_equal(over.history.cpu().numpy(),
                               ser.history.cpu().numpy(), equal_nan=True)
            and torch.equal(over.x.cpu(), ser.x.cpu()))
    true = _true_relres(csr, b, over.x)
    if not same or not bool(over.converged) or true > 10 * tol:
        raise SmokeFailure(f"dist_overlap: overlapped and serialized "
                           f"solves differ ({over.n_iter} against "
                           f"{ser.n_iter} iterations) or did not converge "
                           f"(true relres {true:.3e})")
    line = bench_overlap(csr, torch.float32, n_devices, iters=iters,
                         device=device)
    out = dict(ranks=n_devices, **split, method="pipe_bicgstab",
               dtype="float32", n_iter=it, serialize_on_off="bit-equal",
               true_relres_f64=f"{true:.3e}",
               overlap_gain=f"{line['overlap_gain']:.4f}",
               time_per_iter_overlap_ms=(
                   f"{line['time_per_iter_overlap_s'] * 1e3:.4f}"),
               time_per_iter_serialized_ms=(
                   f"{line['time_per_iter_serialized_s'] * 1e3:.4f}"),
               overlap_fabric=repr(line["overlap_fabric"]),
               launches=_launches(counts))
    _say0("dist_overlap", **out)
    return {**out, "counts": counts}


def run_dist_checkpoint(csr, n_devices: int = 1, device: str = "cuda",
                        tol: float = 1e-6, every: int = 3,
                        workdir=None) -> dict:
    """`[dist_checkpoint]`: utils/checkpoint.solve_with_checkpoints over
    the distributed runner (float32 classic, segments of `every`
    iterations, rank 0 writing the file): a run cut after one segment and
    resumed from the file ends with the uninterrupted run's x, total
    iterations and cum_rel, bit for bit; a different meta is refused on
    every rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi_bicgstab_tpu_torch.parallel.driver import (put_partitioned,
                                                        solve_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.utils.checkpoint import \
        solve_with_checkpoints
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    part = dist_partition(csr, n_devices, torch.float32)
    mesh = make_row_mesh(n_devices, device)
    shard = put_partitioned(part, mesh)
    b = csr.matvec(np.ones(csr.nrows))
    cfg = SolverConfig(tol=tol, max_iter=1000, dtype=torch.float32)
    meta = {"n": part.n_global, "matrix": "transport_like", "method":
            "bicgstab", "dtype": "float32"}
    wd = Path(workdir or _workdir())
    wd.mkdir(parents=True, exist_ok=True)
    paths = [wd / f"dist_ck_{n_devices}_{name}.npz" for name in
             ("whole", "cut")]
    if dist.get_rank() == 0:
        for path in paths:
            path.unlink(missing_ok=True)
    dist.barrier()

    def runner(x0, budget, tol_seg):
        return solve_distributed(shard, b, x0=x0, mesh=mesh,
                                 cfg=cfg.replace(max_iter=budget,
                                                 tol=tol_seg))

    def run(path, max_iter, m=meta):
        return solve_with_checkpoints(runner, str(path), every, max_iter,
                                      m, tol, group=dist.group.WORLD)

    reset_counts()
    with no_twin_on_card():
        whole, done, cum = run(paths[0], cfg.max_iter)
        run(paths[1], every)                     # cut after one segment
        cut, done2, cum2 = run(paths[1], cfg.max_iter)
    counts = read_counts()
    try:
        run(paths[1], cfg.max_iter, dict(meta, method="ca_bicgstab"))
        refused = None
    except ValueError as e:
        refused = str(e)
    if not (done == done2 and cum == cum2 and refused
            and torch.equal(whole.x.cpu(), cut.x.cpu())
            and bool(whole.converged)):
        raise SmokeFailure(f"dist_checkpoint: resumed run {done2} "
                           f"iterations, cum_rel {cum2}, uninterrupted "
                           f"{done}, {cum}, x equal "
                           f"{torch.equal(whole.x.cpu(), cut.x.cpu())}, "
                           f"meta mismatch refused: {refused!r}")
    if dist.get_rank() == 0:
        for path in paths:
            path.unlink(missing_ok=True)
    out = dict(ranks=n_devices, every=every, total_iter=done,
               cum_rel=f"{cum:.3e}", resumed="bit-equal x, total_iter, "
               "cum_rel", meta_mismatch="refused",
               launches=_launches(counts))
    _say0("dist_checkpoint", **out)
    return {**out, "counts": counts}


def run_dist_cheby(csr, lo: float, hi: float, n_devices: int = 1,
                   device: str = "cuda", tol: float = 1e-5) -> dict:
    """`[dist_cheby]`: solve_distributed with cheby:CHEBY_DEGREE in
    float32: converged, the true residual (float64, host CSR) within 100
    tol, the bar of `[cheby]` (float32's floor on transport_hard); the
    DIA SpMV kernel degree + 1 times per application of A p(A) and
    degree times for the exit transform."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    d = CHEBY_DEGREE
    cfg = SolverConfig(tol=tol, max_iter=CHEBY_MAX_ITER,
                       dtype=torch.float32)
    part = partition_csr(csr, n_devices, dtype=torch.float32)
    b = csr.matvec(np.ones(csr.nrows))
    res, counts, times = _dist_solve(part, b, n_devices, device, cfg=cfg,
                                     precond=ChebyPrecond(d, lo, hi))
    it = res.n_iter
    check_dist_counts("dist_cheby", "dia_spmv", it, counts, cfg.restarts,
                      per_op=d + 1, exit_launches=d, device=device)
    true = _true_relres(csr, b, res.x)
    if not bool(res.converged) or true > 100 * tol:
        raise SmokeFailure(f"dist_cheby: converged {bool(res.converged)}, "
                           f"true relres {true:.3e}")
    out = dict(degree=d, ranks=n_devices, n_iter=it, **times,
               true_relres_f64=f"{true:.3e}", launches=_launches(counts))
    _say0("dist_cheby", **out)
    return {**out, "counts": counts}


def run_dist_cli(n: int, device: str = "cuda") -> dict:
    """`[dist_cli]`: `solve --devices 1 --json` through cli.main (the
    single-device path, as in the JAX CLI) converges and reports devices
    1; `--devices 2` on the card exits naming the one CUDA device (on the
    CPU it starts two gloo ranks and converges)."""
    from mpi_bicgstab_tpu_torch import cli
    base = ["solve", "--matrix", f"transport-like:{n}", "--dtype",
            "float32", "--tol", "1e-6", "--json", "--device", device]
    rc, out = _main_json(base + ["--devices", "1"])
    one = json.loads(out.strip().splitlines()[-1])
    if rc or one["devices"] != 1 or not one["converged"]:
        raise SmokeFailure(f"dist_cli: --devices 1 exit {rc}: {out}")
    if device == "cuda":
        try:
            cli.main(base + ["--devices", "2"])
        except SystemExit as e:
            refusal = str(e.code)
        else:
            raise SmokeFailure("dist_cli: --devices 2 ran on one card")
        if "only 1 CUDA device" not in refusal:
            raise SmokeFailure(f"dist_cli: --devices 2 said {refusal!r}")
        two = {"refused": refusal}
    else:
        # the ranks print themselves: rank 0's exit code comes back
        rc2 = cli.main(base + ["--devices", "2"])
        if rc2:
            raise SmokeFailure(f"dist_cli: --devices 2 exit {rc2}")
        two = {"exit": rc2}
    out = dict(devices_1_n_iter=one["total_iter"],
               devices_2=repr(two.get("refused", two.get("exit"))))
    _say("dist_cli", **out)
    return out


def run_profile_path(n: int, device: str = "cuda", workdir=None) -> dict:
    """`[profile]`: `profile --matrix transport-like:n --json` in float32
    through cli.main, then with --sigma-len PROFILE_SIGMA_LEN, then
    --trace: every phase time positive, and the trace file there, naming
    the DIA SpMV kernel's symbol on the card."""
    workdir = Path(workdir or _workdir())
    base = ["profile", "--matrix", f"transport-like:{n}", "--json",
            "--device", device]
    rc, line = _main_json(base)
    plain = json.loads(line.strip().splitlines()[-1])
    rc2, line2 = _main_json(base + ["--sigma-len", str(PROFILE_SIGMA_LEN)])
    shifted = json.loads(line2.strip().splitlines()[-1])
    trace_dir = workdir / "profile_trace"
    rc3, _ = _main_json(base + ["--iters", "4", "--trace", str(trace_dir)])
    trace = trace_dir / "trace.json"
    names_kernel = trace.exists() and "dia_spmv_kernel" in trace.read_text()
    phases = {k: v for d in (plain, shifted) for k, v in d.items()
              if k.endswith("_s")}
    if rc or rc2 or rc3 or not all(v > 0 for k, v in phases.items()
                                   if k != "shift_update_s") \
            or not trace.exists() or (device == "cuda" and not names_kernel):
        raise SmokeFailure(f"profile: exits {rc, rc2, rc3}, phases "
                           f"{phases}, trace {trace.exists()}, names the "
                           f"DIA SpMV kernel {names_kernel}")
    out = {**{k: f"{v:.4e}" for k, v in phases.items()},
           "trace_mb": round(trace.stat().st_size / 1e6, 2),
           "trace_names_dia_spmv_kernel": names_kernel}
    _say("profile", **out)
    return out


def _kernel_ms(fn) -> float:
    """The device time of every kernel fn() launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


class _ListComm:
    """A reduction in the blocking list form the distributed layer had
    before its split-phase Comm (one dist.all_gather into a Python list
    of P tensors, waited at once, summed in rank order), to time the
    two side by side in one run."""

    def __init__(self, comm):
        self.comm = comm

    def dot(self, u, v):
        import torch
        import torch.distributed as dist
        t = torch.dot(u, v).contiguous()
        out = [torch.empty_like(t) for _ in range(self.comm.size)]
        dist.all_gather(out, t, group=self.comm.group)
        acc = out[0]
        for p in out[1:]:
            acc = acc + p
        return acc


def time_dist_iteration(csr, prob32) -> None:
    """The one-rank distributed f32 classic iteration (the halo-fused
    route) beside the single-device routes, ms per iteration from tol=0
    chains of DIST_CHAINS iterations: the distributed solve eager (CUDA
    events) and its device time (the kernels' sum by torch.profiler:
    NCCL's cannot be captured in a graph with the solve's host-to-device
    copies); the single-device unfused solver eager and as a replayed
    graph; the single-device fused route, the same passes, eager and as a
    replayed graph; and one global dot alone, over the one-rank group
    (the split-phase Comm, and the blocking list form it replaced,
    _ListComm) and on the single device, eager."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.benchmarks.runner import (_graph,
                                                          _slope_time,
                                                          bench_iteration)
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.ops.precision import vzeros_like
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.parallel.driver import (put_partitioned,
                                                        row_comm,
                                                        solve_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import bicgstab
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    K1, K2 = DIST_CHAINS
    mesh = make_row_mesh(1, "cuda")
    shard = put_partitioned(dist_partition(csr, 1, torch.float32), mesh)
    b = csr.matvec(np.ones(csr.nrows))

    def cfg(K):
        return SolverConfig(tol=0.0, max_iter=K, dtype=torch.float32)

    def dist_chain(K):
        return lambda: solve_distributed(shard, b, cfg=cfg(K), mesh=mesh)

    def unfused_chain(K, graph=False):
        def run():
            bicgstab(lambda v: spmv(prob32.A, v), Comm(), prob32.b,
                     vzeros_like(prob32.b), cfg(K))
        return _graph(run) if graph else run

    dist_eager = _slope_time(dist_chain, K1, K2) * 1e3
    k1, k2 = (_kernel_ms(dist_chain(K)) for K in (K1, K2))
    dist_dev = (k2 - k1) / (K2 - K1)
    unf_eager = _slope_time(unfused_chain, K1, K2) * 1e3
    unf_dev = _slope_time(lambda K: unfused_chain(K, True), K1, K2) * 1e3
    fused = {g: bench_iteration(prob32, "bicgstab", iters=K2,
                                graph=g)["time_per_iter_s"] * 1e3
             for g in (False, True)}
    dots = {}
    for name, comm in (("dist", row_comm(mesh)), ("single", Comm()),
                       ("list", _ListComm(row_comm(mesh)))):
        def dot_chain(K, comm=comm):
            return lambda: [comm.dot(prob32.b, prob32.b) for _ in range(K)]
        dots[name] = _slope_time(dot_chain, K1, K2) * 1e3
    _say("times", dist_one_rank_f32_eager_ms_per_iter=f"{dist_eager:.4f}",
         dist_one_rank_f32_device_kernels_ms_per_iter=f"{dist_dev:.4f}",
         single_unfused_f32_eager_ms_per_iter=f"{unf_eager:.4f}",
         single_unfused_f32_device_ms_per_iter=f"{unf_dev:.4f}",
         single_fused_f32_eager_ms_per_iter=f"{fused[False]:.4f}",
         single_fused_f32_device_ms_per_iter=f"{fused[True]:.4f}",
         one_rank_overhead_eager_ms=f"{dist_eager - fused[False]:.4f}",
         dist_dot_eager_ms=f"{dots['dist']:.4f}",
         dist_dot_list_all_gather_eager_ms=f"{dots['list']:.4f}",
         single_dot_eager_ms=f"{dots['single']:.4f}",
         chains=f"tol=0x{K1},{K2}")


# --- the last slice (9b-ii): the NumPy router, the curves, the hooks --------

# the JAX package's TPU v5e record of the residual curves (the committed
# CSVs; their iteration counts are quoted as trajectories, no time)
CURVES_TOL, CURVES_MAX_ITER = 1e-14, 6000
CURVES_GATED = ("bicgstab", "ca_bicgstab", "pipe_bicgstab_rr")
# the lines examples/quickstart_torch.py prints with one rank, in order
QUICKSTART_LINES = ("pipe_bicgstab: ", "shifted (4 shifts): ",
                    "df32: relres ", "hard regime: ", "batched 4-RHS: ",
                    "(1 device visible", "skew-dominant spectrum: ")
# the kernels dryrun_multichip(1) must launch on the card: kernel 1 and
# the DF SpMV (the small partition's unfused solves, halo form), the
# halo-fused float32 classic and pipelined passes and the DF classic ones
DRYRUN_KERNELS = ("dia_spmv", "dia_spmv_df", "fused_k1", "fused_k2",
                  "fused_k3", "fused_phase_a", "fused_phase_b",
                  "fused_k1_df", "fused_k2_df", "fused_k3_df")


def _here() -> Path:
    return Path(__file__).resolve().parent


def numpy_route(n: int, out: str) -> None:
    """Route uniform_csr(n) with the NumPy router (this process must run
    with MBT_NATIVE_ROUTE=0) and save its float64 tables and the route's
    host seconds ("route_s") to `out` (.npz)."""
    import numpy as np

    from mpi_bicgstab_tpu_torch.ops import native_route
    from mpi_bicgstab_tpu_torch.ops.butterfly import butterfly_tables
    if native_route.native_enabled():
        raise SmokeFailure("numpy_route: MBT_NATIVE_ROUTE is not 0")
    csr = uniform_csr(n)
    t0 = time.perf_counter()
    tables = butterfly_tables(csr)
    np.savez(out, route_s=time.perf_counter() - t0, **tables)


def start_numpy_route(n: int, out: Path):
    """numpy_route(n, out) in a process of its own under
    MBT_NATIVE_ROUTE=0, so that the route's host seconds overlap the
    phases that run meanwhile. Returns the Popen."""
    import atexit
    import os
    out.parent.mkdir(parents=True, exist_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(_here())!r}); "
            f"import chip_smoke; chip_smoke.numpy_route({n}, {str(out)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=_here(),
                            env={**os.environ, "MBT_NATIVE_ROUTE": "0"})
    atexit.register(proc.kill)      # a failed run leaves no route behind
    return proc


def finish_numpy_route(proc, out: Path):
    """(the NumPy-routed float64 layout on the CPU, its column table
    built by the twins; the route's host seconds) from start_numpy_route."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.ops.butterfly import ButterflyMatrix
    if proc.wait(timeout=900):
        raise SmokeFailure(f"the NumPy route exited {proc.returncode}")
    with np.load(out) as z:
        fields = {k: (torch.from_numpy(z[k]) if z[k].ndim else int(z[k]))
                  for k in z.files if k != "route_s"}
        route_s = float(z["route_s"])
    out.unlink()
    return ButterflyMatrix(**fields), route_s


def run_butterfly_numpy(binp: dict, host, route_s: float, it_native: int,
                        device: str = "cuda") -> dict:
    """`[butterfly_numpy]`: the NumPy router's layout of binp's matrix
    (host: float64 on the CPU, routed under MBT_NATIVE_ROUTE=0) beside
    the native one. Cast to float32 on `device` (its column table built
    there by K1, K2 and the decode) and solved by f32 bicgstab at
    UNIFORM_TOL, counted from the cast to the solve's end, under
    no_twin_on_card: converged within 2 iterations of `it_native`
    ([butterfly]'s), x held as [butterfly] holds it (held_to_csr),
    launches in check_butterfly_counts (one layout built). Then the whole
    f32 SpMV (K3 and the tail) on binp's x equal bit for bit to its twin
    on a CPU copy of the layout, the float64 SpMV within 1e-12 of torch's
    CSR product (as [butterfly]'s), and simulate_numpy of the layout
    (host copies of its tables, no column table) within 1e-12 of the CSR
    product's largest entry on a float64 x. Prints the route's host
    seconds, the tails, the whole f32 SpMV's ms and K3's alone beside the
    native layout's. Returns the counts."""
    import numpy as np
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.benchmarks.runner import time_call
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    from mpi_bicgstab_tpu_torch.ops.butterfly import (butterfly_with_values,
                                                      simulate_numpy)
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    csr = binp["b_csr"]
    native = binp["B32"]
    cfg = SolverConfig(tol=UNIFORM_TOL, dtype=torch.float32)
    b = torch.as_tensor(csr.matvec(np.ones(csr.nrows)), dtype=torch.float32,
                        device=device)
    with no_twin_on_card():
        reset_counts()
        B32 = butterfly_with_values(host, torch.float32, device)
        res = solve(B32, b, cfg=cfg)
        converged = bool(res.converged)
        counts = read_counts()
        y = spmv(B32, binp["bx32"])
        B64 = butterfly_with_values(host, torch.float64, device)
        y64 = spmv(B64, binp["bx64"])
    check_butterfly_counts("butterfly_numpy", "bicgstab", "float32",
                           res.n_iter, counts, cfg.restarts, device,
                           layouts=1)
    twin = spmv(butterfly_with_values(host, torch.float32, "cpu"),
                binp["bx32"].cpu())
    if not same_bits(y.cpu(), twin):
        raise SmokeFailure("butterfly_numpy: the f32 SpMV on the card "
                           "differs from its twin on the CPU")
    ref = torch_csr(csr, torch.float64, y64.device) @ binp["bx64"]
    rel = _err(y64, ref) / float(ref.abs().max())
    relres, err, bound, _ = held_to_csr(csr, res.x, csr.nrows)
    if not (converged and abs(res.n_iter - it_native) <= 2 and rel <= 1e-12
            and relres <= 10 * UNIFORM_TOL and err <= bound):
        raise SmokeFailure(f"butterfly_numpy: converged {converged}, "
                           f"n_iter {res.n_iter} ([butterfly] {it_native}), "
                           f"f64 SpMV {rel:.3e}, CSR relres {relres:.3e}, "
                           f"max|x-1| {err:.3e} (bound {bound:.3e})")
    del B64, y64, ref, twin
    graph = device == "cuda"
    k3 = cbf.butterfly_k3 if graph else bs.k3_plain
    ms = {(k, part): time_call(lambda A=A, f=f: f(A, binp["bx32"]),
                               graph=graph, device=device) * 1e3
          for k, A in (("numpy", B32), ("native", native))
          for part, f in (("spmv", spmv), ("k3", k3))}
    x = np.random.default_rng(3).standard_normal(csr.nrows)
    t0 = time.perf_counter()
    y_sim = simulate_numpy(host, x)
    sim_s = time.perf_counter() - t0
    want = csr.matvec(x)
    sim_rel = float(np.abs(y_sim - want).max() / np.abs(want).max())
    if not sim_rel <= 1e-12:
        raise SmokeFailure(f"butterfly_numpy: simulate_numpy is "
                           f"{sim_rel:.3e} from the CSR product")
    _say("butterfly_numpy", n=csr.nrows, route_numpy_host_s=round(route_s, 3),
         route_native_host_s=round(binp["b_build_s"], 3),
         tail_n=host.tail_n, native_tail_n=native.tail_n,
         tail_levels_x_cap="x".join(map(str, host.tail_rows.shape)),
         native_tail_levels_x_cap="x".join(map(str, native.tail_rows.shape)),
         P=host.P,
         rb=host.rb, W=host.width, n_iter=res.n_iter,
         native_n_iter=it_native, converged=converged,
         csr_f64_relres=f"{relres:.3e}", max_abs_x_minus_1=err,
         varah_bound=f"{bound:.3e}", f64_spmv_vs_torch_csr=f"{rel:.3e}",
         f32_spmv_bit_equal_cpu_twin=True,
         spmv_f32_ms=f"{ms['numpy', 'spmv']:.4f}",
         native_spmv_f32_ms=f"{ms['native', 'spmv']:.4f}",
         k3_f32_ms=f"{ms['numpy', 'k3']:.4f}",
         native_k3_f32_ms=f"{ms['native', 'k3']:.4f}",
         minus_one_slots=int((B32.k3_col < 0).sum()),
         native_minus_one_slots=int((native.k3_col < 0).sum()),
         spmv_ms_kind="graph replay" if graph else "host clock",
         simulate_numpy_n=csr.nrows, simulate_numpy_s=round(sim_s, 3),
         simulate_numpy_vs_csr=f"{sim_rel:.3e}", launches=_launches(counts))
    return counts


def tpu_record_iters(method: str) -> int:
    """The iterations of the JAX package's committed TPU curve of method
    (docs/data/r2_hard1601k_df32_<method>.csv, its last row)."""
    path = _here() / "docs" / "data" / f"r2_hard1601k_df32_{method}.csv"
    last = path.read_text().strip().splitlines()[-1]
    return int(float(last.split(",")[0]))


def run_curves(csr_h, device: str = "cuda", tol: float = CURVES_TOL,
               max_iter: int = CURVES_MAX_ITER, out_dir=None) -> dict:
    """`[curves]`: scripts/record_curves_torch.py's method loop on csr_h
    (transport_hard), df32, at tol with JAX's krr 400 / nrr 8, writing
    into out_dir (the work directory's curves/ by default); each method counted under no_twin_on_card
    (check_counts: the fused DF drivers), its JSON row printed, beside
    the TPU record's iteration count (tpu_record_iters). Gate: bicgstab,
    ca_bicgstab and pipe_bicgstab_rr converged with a true relres <=
    max(1e-12, 100 tol) (1e-12 at the default tol); pipe_bicgstab and the
    iteration counts are printed, not gated. Returns {method: counts}."""
    import importlib.util
    path = _here() / "scripts" / "record_curves_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    runs = {}

    def after(row):
        m = row["method"]
        runs[m] = read_counts()
        check_counts(m, "df32", row["iters"], runs[m], 2, device)
        _say("curves", method=m, iters=row["iters"],
             tpu_record_iters=tpu_record_iters(m),
             converged=row["converged"], true_relres=row["true_relres"],
             eager_ms_per_iter=row["eager_ms_per_iter"],
             launches=_launches(runs[m]))
        if m in CURVES_GATED and not (
                row["converged"] and row["true_relres"] <= max(1e-12,
                                                               100 * tol)):
            raise SmokeFailure(f"curves: {m}: {row}")
        reset_counts()

    reset_counts()
    with no_twin_on_card():
        rec.record_methods(csr_h, "df32", tol, max_iter, device,
                           str(out_dir or _workdir() / "curves"),
                           after=after)
    return runs


def run_entry(device: str = "cuda") -> dict:
    """`[entry]`: entry()'s step on `device` and on the CPU, each counted
    under no_twin_on_card: n_iter within 1, x_set within 1e-3 (the card
    tests' float32 bar for the switching solver); on the card only
    kernel 1 (float32) launches. Returns the device's counts."""
    from mpi_bicgstab_tpu_torch.entry import entry
    got = {}
    for dev in (device, "cpu"):
        reset_counts()
        with no_twin_on_card():
            fn, args = entry(device=dev)
            x_set, k, relres = fn(*args)
            got[dev] = (_f64(x_set).cpu(), k, float(relres), read_counts())
    (x, k, r, counts), (x_cpu, k_cpu, r_cpu, _) = got[device], got["cpu"]
    diff = float((x - x_cpu).abs().max())
    used = {c for c, v in counts.items() if v}
    if not (abs(k - k_cpu) <= 1 and diff <= 1e-3
            and used == ({"dia_spmv"} if device == "cuda" else set())):
        raise SmokeFailure(f"entry: n_iter {k} (cpu {k_cpu}), max|x - "
                           f"x_cpu| {diff:.3e}, launches {counts}")
    _say("entry", n_iter=k, cpu_n_iter=k_cpu, final_relres=f"{r:.3e}",
         cpu_final_relres=f"{r_cpu:.3e}", max_abs_x_minus_x_cpu=f"{diff:.3e}",
         launches=_launches(counts))
    return counts


def run_dryrun(device: str = "cuda") -> dict:
    """`[dryrun]`: dryrun_multichip(1) on the one-rank group of this
    process (init_world; it runs in place, every assert of the JAX dry
    run inside), counted under no_twin_on_card: on the card each kernel
    of DRYRUN_KERNELS launched. Returns the counts."""
    from mpi_bicgstab_tpu_torch.entry import dryrun_multichip
    init_world(device)
    reset_counts()
    t0 = time.perf_counter()
    with no_twin_on_card():
        out = dryrun_multichip(1, device=device)
    counts = read_counts()
    missing = [k for k in DRYRUN_KERNELS if not counts[k]]
    if device == "cuda" and missing:
        raise SmokeFailure(f"dryrun: {missing} never launched: {counts}")
    _say("dryrun", **{p: json.dumps(v).replace(" ", "")
                      for p, v in out.items()},
         seconds=round(time.perf_counter() - t0, 3),
         launches=_launches(counts))
    return counts


def run_quickstart(device: str = "cuda") -> None:
    """`[quickstart]`: `python examples/quickstart_torch.py` in its own
    process (one rank: the mesh section prints its hint): exit 0 and every
    section's line (QUICKSTART_LINES), each printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(_here() / "examples" / "quickstart_torch.py"),
         "--device", device, "--ranks", "1"], capture_output=True,
        text=True, timeout=600, cwd=_here())
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or len(lines) != len(QUICKSTART_LINES) or not all(
            ln.startswith(s) for ln, s in zip(lines, QUICKSTART_LINES)):
        raise SmokeFailure(f"quickstart: exit {proc.returncode}: "
                           f"{proc.stdout}{proc.stderr[-2000:]}")
    for ln in lines:
        print(f"[quickstart] {ln}", flush=True)
    _say("quickstart", seconds=round(time.perf_counter() - t0, 3))


def run_dist_phases(csr, csr_h, lo: float, hi: float, winp: dict,
                    binp: dict, device="cuda"):
    """Every distributed phase on a one-rank process group of this
    process (init_world), on the matrices and layouts the run has built:
    transport_like (csr), transport_hard (csr_h, Chebyshev bounds lo /
    hi), the window and butterfly inputs; last the dry run of the
    distributed surface (run_dryrun). Returns {phase: counts}."""
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    import torch
    init_world(device)
    runs = {}
    try:
        for phase in DIST_PATHS:
            runs[phase] = run_dist_path(phase, csr, device=device)["counts"]
        time_dist_iteration(csr, build_problem(csr, dtype=torch.float32,
                                               multiple=1, device=device))
        runs["dist_window"] = run_dist_layout(
            "dist_window", winp["w_csr"], device=device,
            layout=winp["W32"])["counts"]
        runs["dist_butterfly"] = run_dist_layout(
            "dist_butterfly", binp["b_csr"], device=device,
            layout=binp["B32"])["counts"]
        runs["dist_shifted"] = run_dist_shifted(csr, device=device)["counts"]
        runs["dist_batched"] = run_dist_batched(csr, device=device)["counts"]
        runs["dist_overlap"] = run_dist_overlap(csr, device=device)["counts"]
        runs["dist_checkpoint"] = run_dist_checkpoint(
            csr, device=device)["counts"]
        runs["dist_cheby"] = run_dist_cheby(csr_h, lo, hi,
                                            device=device)["counts"]
        run_dist_cli(N_MAIN, device=device)
        runs["dryrun"] = run_dryrun(device)
    finally:
        end_world()
    run_profile_path(N_MAIN, device=device)
    return runs


def io_times() -> int:
    """`chip_smoke.py --io-times`: the reader and the layout cache at the
    main path's width. The native parse against the NumPy parse of the
    .mtx of transport_like(N_MAIN) (both bit-equal to the generator's
    CSR), and the CLI's setup_s cold against warm (--layout-cache) for
    `solve --dtype float32 --tol 1e-6` on uniform:N_UNIFORM (butterfly)
    and clustered:N_WINDOW (window), whose two reports must be equal
    apart from their times. Prints no result line."""
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch import cli
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    print(probe())
    build()
    csr = transport_like(N_MAIN)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "transport_like.mtx"
        write_s = write_mtx(path, csr)
        size = path.stat().st_size
        native_s, csr_s = parse_mtx(path, csr)
        numpy_s, _ = parse_mtx(path, csr, use_native=False)
        _say("io_times", n=csr.nrows, nnz=csr.nnz, file_bytes=size,
             write_s=round(write_s, 3), parse_native_s=round(native_s, 3),
             parse_numpy_s=round(numpy_s, 3),
             native_speedup=round(numpy_s / native_s, 2),
             coo_to_csr_s=round(csr_s, 3))
        del csr
        timing = ("io_time_s", "setup_s", "total_time_s",
                  "avg_time_per_iter_s")
        for spec in (f"uniform:{N_UNIFORM}", f"clustered:{N_WINDOW}"):
            cache = Path(tmp) / "cache"
            args = cli.build_parser().parse_args(
                ["solve", "--matrix", spec, "--dtype", "float32", "--tol",
                 "1e-6", "--layout-cache", str(cache)])
            cold, _ = cli.run_solve(args)
            warm, _ = cli.run_solve(args)
            if {k: v for k, v in cold.items() if k not in timing} != \
                    {k: v for k, v in warm.items() if k not in timing}:
                raise SmokeFailure(f"io_times: {spec}: the warm report "
                                   f"differs: {cold} against {warm}")
            entries = list(cache.glob("*.npz"))
            _say("io_times", matrix=spec, layout=cold["layout"],
                 setup_cold_s=cold["setup_s"], setup_warm_s=warm["setup_s"],
                 setup_saved_s=round(cold["setup_s"] - warm["setup_s"], 3),
                 cache_entries=len(entries),
                 cache_mb=round(sum(e.stat().st_size for e in entries)
                                / 1e6, 1),
                 n_iter=warm["total_iter"], converged=warm["converged"])
            for e in entries:
                e.unlink()
    return 0


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
    say_chain_plan(inp)
    say_chain_info()
    calls = kernel_calls(inp)
    errs = check_kernels(calls, inp)
    check_frozen_lanes(calls, inp)
    check_nonfinite_frozen(nonfinite_frozen_inputs(inp))
    errs["shift_update_df"], su_row = check_shift_update(csr.nrows)
    check_halo_kernels(inp)
    gc.collect()
    torch.cuda.empty_cache()
    # windowed-ELL: the layout built once on the host, in three dtypes
    t0 = time.perf_counter()
    csr_w = clustered_random(N_WINDOW)
    winp = window_inputs(csr_w)
    W = winp["W32"]
    _say("check", matrix="clustered_random", n=csr_w.nrows, nnz=csr_w.nnz,
         W=W.width, tiles=W.n_tiles, tail_counts=list(W.tail_counts),
         slots=W.width * W.n_rows, compacted_slots=W.rc_col.numel(),
         held=int((W.rc_col >= 0).sum()), widest_slice=W.rc_width,
         compacted_mb_f32=round(W.rc_col.numel() * 8 / 1e6, 1),
         window_build_host_s=round(winp["w_build_s"], 3),
         host_setup_s=round(time.perf_counter() - t0, 3))
    wcalls = window_kernel_calls(winp)
    errs.update(check_kernels(wcalls, winp))
    check_window_padded(winp)
    check_window_nonfinite(winp)
    _say("check", window_spmv_f64_vs_torch_csr_rel_err=(
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
    # the NumPy router's layout of the same matrix, routed meanwhile
    route_path = _workdir() / "numpy_route.npz"
    route_proc = start_numpy_route(N_UNIFORM, route_path)
    bcalls = butterfly_kernel_calls(binp)
    errs.update(check_kernels(bcalls, binp))
    check_column_tables(binp)
    _say("check", butterfly_column_table="card equals CPU twins",
         slots=B.k3_col.numel(), minus_one=int((B.k3_col < 0).sum()))
    check_butterfly_staged(binp)
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
    # the reader: the main matrix through a .mtx file and the CLI
    runs["mtx"] = run_mtx_path(csr, iters["f32"], _workdir())

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
    time_classic_loops(inp["h_probdf"], prec)
    # the residual curves of the four classic methods (df32, tol 1e-14)
    runs.update({f"curves_{m}": c for m, c in run_curves(csr_h).items()})
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
    bfly = {}
    runs["butterfly"] = run_butterfly_cli(N_UNIFORM, bprobs["float32"][1],
                                          out=bfly)
    for phase in BUTTERFLY_PATHS:
        runs[phase] = run_butterfly_api(phase, bprobs)
    runs["butterfly_numpy"] = run_butterfly_numpy(
        binp, *finish_numpy_route(route_proc, route_path), bfly["n_iter"])
    # the layout cache: both unstructured layouts saved and loaded back
    run_layout_cache_path("uniform", binp["B32"], binp["b_csr"],
                          binp["b_build_s"], UNIFORM_TOL, _workdir())
    run_layout_cache_path("clustered", winp["W32"], winp["w_csr"],
                          winp["w_build_s"], WINDOW_TOL, _workdir())
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
    say_pass_kernels(calls)
    time_routing(csr)
    time_window(winp, wprobs)
    times.update(time_kernels(wcalls, winp, csr_w))
    time_butterfly(binp, bprobs)
    times.update(time_kernels({k: bcalls[k] for k in BUTTERFLY_TIMED},
                              binp, csr_u))
    gc.collect()
    torch.cuda.empty_cache()
    run_tools(inp)
    runs["entry"] = run_entry()
    gc.collect()
    torch.cuda.empty_cache()
    # the distributed layer on a one-rank NCCL group, and `profile`
    runs.update(run_dist_phases(csr, csr_h, inp["h_lo"], inp["h_hi"], winp,
                                binp))
    run_quickstart()
    _say("times", max_memory_allocated_gb_whole_run=round(
        torch.cuda.max_memory_allocated() / 1e9, 3))

    kernels = []
    for name, row in times.items():
        base = {"dia_spmv_f32": "dia_spmv", "dia_spmv_f64": "dia_spmv",
                "window_spmv_f32": "window_spmv",
                "window_spmv_f64": "window_spmv",
                "butterfly_k3_f32": "butterfly_k3",
                "butterfly_k3_f64": "butterfly_k3"}.get(name, name)
        phase, counter = LAUNCHES_FROM[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "launches": runs[phase][counter],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("slots_bound_ms", "padded_bound_ms",
                                   "design_floor_ms") if k in row}})
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
    modes = {"--chain-times": chain_times, "--batched-times": batched_times,
             "--route-times": route_times, "--io-times": io_times,
             "--band-times": band_times, "--classic-bodies": classic_bodies}
    args = sys.argv[1:]
    sys.exit(modes[args[0]]() if len(args) == 1 and args[0] in modes
             else main())
