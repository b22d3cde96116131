"""Timing on the card (counterpart of mpi_bicgstab_tpu/benchmarks/)."""
