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
             15 diagonals (tolerances in TOL below). The double-float (DF)
             kernels take the band as DF pairs split from float64 and
             random DF vectors from a seeded NumPy generator; their output
             vectors must equal the twin's bit for bit, each dot must lie
             within 1e-12 sum|u_i v_i| of the twin's, and the scalar each
             pass folds into its finishing stage must equal the twin's
             formula (ops/precision.py) applied to the kernel's own dots
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
  5. times   CUDA-event slopes: time per iteration of f32 classic, CA and
             pipelined BiCGStab and of df32 classic, CA and pipelined
             (tol=0 chains of 200 iterations) as the host issues it and as
             a replayed CUDA graph (the device's own time; their ratio is
             the device's busy share), beside their byte floors; each
             kernel against its bound, its plain version and, for the
             f32/f64 SpMV, torch's CSR product
  6. report  the kernels JSON line, the card's name and power limit,
             and the final {"ok": true, "device": ...} line
"""
from __future__ import annotations

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
                 "fused_phase_b_df": ("pipe_df32", "fused_phase_b_df")}


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
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
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
            "fused_phase_b_df": fpipedf.fused_phase_b_df}


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
    }


def df_kernel_calls(inp: dict) -> dict:
    """The DF kernels' entries of kernel_calls: each call returns a tuple
    of DF pairs, vectors first, then dots, then the folded scalar."""
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca_df as fcadf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe_df as fpipedf
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
    return {
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
    if name == "dia_spmv_df":
        return 1, [], []
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
        for i, (g, w) in enumerate(zip(got, want)):
            what = f"{name} output {i}"
            if dt == "float64":
                _close(what, g, w, TOL[dt]["rtol"],
                       TOL[dt]["atol_rel"] * float(w.abs().max()))
            elif g.dim() == 0:
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
    A = inp["A32"]
    n, W = A.n_rows, A.n_diags
    nz = _band_nnz(A)
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
    # DF: 8 bytes per element; the vectors and scalars as for float32;
    # operations: one df_fma per band entry and per update, and the dots
    fma, dot = DF_FMA_FLOPS, DF_DOT_FLOPS
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


def library_call(name: str, inp: dict, csr):
    """One PyTorch call computing the same function, or None: torch's CSR
    sparse product for the SpMV (a yardstick; the port never calls it)."""
    import torch
    if name not in ("dia_spmv_f32", "dia_spmv_f64"):
        return None     # no PyTorch call computes a fused pass or a DF SpMV
    dt = torch.float32 if name.endswith("f32") else torch.float64
    dev = inp["A32"].device
    A = torch.sparse_csr_tensor(
        torch.as_tensor(csr.ptr, device=dev),
        torch.as_tensor(csr.col, device=dev),
        torch.as_tensor(csr.val, dtype=dt, device=dev), size=csr.shape)
    x = inp["x"] if dt == torch.float32 else inp["x64"]
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
        _say("times", kernel=name, ms=f"{row['ms']:.4f}",
             bound_ms=f"{row['bound_ms']:.4f}",
             bound_share=f"{row['bound_ms'] / row['ms']:.3f}",
             eager_ms=f"{row['eager_ms']:.4f}",
             plain_ms=f"{row['plain_ms']:.4f}",
             library_ms=(f"{row['library_ms']:.4f}"
                         if row["library_ms"] is not None else None),
             bytes=nbytes)
    return out


def unfused_df_iters(probdf, phase: str) -> tuple[int, bool]:
    """(n_iter, converged) of the unfused DF solver of PATHS[phase]'s
    method over the DF SpMV kernel at the path's tol: the yardstick of
    that path's fused DF driver."""
    from mpi_bicgstab_tpu_torch.ops.cuda_spmv import dia_spmv_df
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    method, dtype, tol, _ = PATHS[phase]
    A = probdf.A
    res = CLASSIC_SOLVERS[method](
        lambda v: dia_spmv_df(A.vals, A.offsets, v), Comm(), probdf.b,
        probdf.x0, SolverConfig(tol=tol, dtype=dtype, krr=KRR, nrr=NRR))
    return res.n_iter, bool(res.converged)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from mpi_bicgstab_tpu_torch.benchmarks.runner import (bench_iteration,
                                                          bench_spmv)
    from mpi_bicgstab_tpu_torch.models.generators import transport_like
    from mpi_bicgstab_tpu_torch.models.problem import build_problem

    t_start = time.perf_counter()
    smi = probe()
    build()

    t0 = time.perf_counter()
    csr = transport_like(N_MAIN)
    inp = kernel_inputs(csr)
    _say("check", n=csr.nrows, nnz=csr.nnz, W=inp["A32"].n_diags,
         max_offset=max(abs(o) for o in inp["A32"].offsets),
         host_setup_s=round(time.perf_counter() - t0, 3))
    calls = kernel_calls(inp)
    errs = check_kernels(calls, inp)

    runs, iters = {}, {}
    for phase, (method, dtype, tol, extra) in PATHS.items():
        report, counts, err = run_main_path(N_MAIN, dtype, tol,
                                            method=method, extra=extra)
        runs[phase], iters[phase] = counts, report["total_iter"]
        _say(phase, method=method, dtype=dtype, tol=tol,
             converged=report["converged"], n_iter=report["total_iter"],
             final_relres=report["final_relres"],
             true_relres=report["true_relres"], max_abs_x_minus_1=err,
             solve_s=report["total_time_s"],
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

    prob32 = build_problem(csr, dtype=torch.float32, multiple=1)
    n = prob32.n
    floors = {   # bytes of one fused iteration; the pipelined one also
                 # forms z' and w' (3 vectors read, 1 written, each)
        "bicgstab": ("fused_k1", "fused_k2", "fused_k3"),
        "ca_bicgstab": ("fused_ca_k1", "fused_ca_k2"),
        "pipe_bicgstab": ("fused_phase_a", "fused_phase_b")}
    for method, kerns in floors.items():
        nbytes = sum(work(k, inp)[0] for k in kerns)
        if method == "pipe_bicgstab":
            nbytes += 2 * 4 * 4 * n
        eager = bench_iteration(prob32, method=method, iters=200)
        dev = bench_iteration(prob32, method=method, iters=200, graph=True)
        ms, dev_ms = (t["time_per_iter_s"] * 1e3 for t in (eager, dev))
        _say("times", method=method, f32_ms_per_iter=f"{ms:.4f}",
             device_ms_per_iter=f"{dev_ms:.4f}",
             device_busy_share=f"{dev_ms / ms:.3f}", chain="tol=0x200",
             bound_ms_per_iter=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
             bytes_per_iter=nbytes)
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
    sp = bench_spmv(prob32)
    _say("times", spmv_f32_nnz_per_s=f"{sp['spmv_nnz_per_s']:.4e}",
         spmv_layout=sp["spmv_layout"])
    times = time_kernels(calls, inp, csr)
    _say("times", max_memory_allocated_gb_whole_run=round(
        torch.cuda.max_memory_allocated() / 1e9, 3))

    kernels = []
    for name, row in times.items():
        base = "dia_spmv" if name in ("dia_spmv_f32", "dia_spmv_f64") \
            else name
        phase, counter = LAUNCHES_FROM[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "launches": runs[phase][counter],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    _say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
