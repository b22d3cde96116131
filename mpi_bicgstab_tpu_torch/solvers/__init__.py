"""Krylov solvers (counterpart of mpi_bicgstab_tpu/solvers/)."""
