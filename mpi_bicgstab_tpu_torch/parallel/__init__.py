"""Collectives (counterpart of mpi_bicgstab_tpu/parallel/); single device
until ROADMAP slice 8."""
