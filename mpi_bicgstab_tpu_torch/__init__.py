"""mpi_bicgstab_tpu_torch — the PyTorch/CUDA port of mpi_bicgstab_tpu.

A second package beside the JAX one, for one NVIDIA Hopper card
(sm_90a). It keeps the JAX package's layout so that each counterpart is
easy to find (utils/, solvers/, ops/, models/, io/, parallel/, api.py,
cli.py) and imports neither JAX nor anything of mpi_bicgstab_tpu.

Plain tensor code is PyTorch. The kernels that the JAX package wrote in
Pallas for the TPU are CUDA C++ written by hand, under csrc/, built with
nvcc at first use (ops/_build.py) and bound with ctypes. Each kernel
sits beside a plain PyTorch version of the same function: a wrapper
runs the plain version for a tensor on the CPU, and for a CUDA tensor
launches the kernel or raises.

Entry points (models.problem.build_problem, api.solve, the CLI) run on
the card unless the caller asks for the CPU; without a card they raise.

Ported so far: the classic BiCGStab family on a single device —
bicgstab, ca_bicgstab, pipe_bicgstab, pipe_bicgstab_rr and BiCGStab(l).
float32 on a DIA matrix runs each classic-family method through its fused
kernels (ops/cuda_fused_classic.py, cuda_fused_ca.py, cuda_fused_pipe.py),
df32 through the fused DF kernels (ops/cuda_fused_*_df.py); float64,
other layouts and BiCGStab(l) run the unfused solvers over the DIA SpMV
kernel of ops/cuda_spmv.py. The shifted family (solvers/shifted.py,
switching.py, switching_blocked.py, refine.py; api.solve_shifted, CLI
solve-shifted) runs the df32 seed-switching shift update through the
fused kernel of ops/cuda_shift_update.py.
"""

__version__ = "0.1.0"

from mpi_bicgstab_tpu_torch.utils.config import SolverConfig  # noqa: F401
