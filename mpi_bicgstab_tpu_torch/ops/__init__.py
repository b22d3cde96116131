"""Sparse layouts, SpMV and the CUDA kernels (counterpart of
mpi_bicgstab_tpu/ops/)."""
from mpi_bicgstab_tpu_torch.ops.sparse import COOMatrix, CSRMatrix, coo_to_csr  # noqa: F401
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix, csr_to_ell  # noqa: F401
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv, ell_spmv_shifted  # noqa: F401
from mpi_bicgstab_tpu_torch.ops.blas import dot, dots, axpy  # noqa: F401
from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix, csr_to_dia, dia_spmv, analyze_diagonals  # noqa: F401,E402
from mpi_bicgstab_tpu_torch.ops.layout import HybridMatrix, build_operator, spmv  # noqa: F401,E402
