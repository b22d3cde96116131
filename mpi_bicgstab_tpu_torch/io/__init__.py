"""Matrix Market input and output (counterpart of mpi_bicgstab_tpu/io/)."""
