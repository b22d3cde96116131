"""Matrix generators and problem construction (counterpart of
mpi_bicgstab_tpu/models/)."""
