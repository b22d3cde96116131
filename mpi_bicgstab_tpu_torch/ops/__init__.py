"""Sparse layouts, SpMV and the CUDA kernels (counterpart of
mpi_bicgstab_tpu/ops/)."""
