"""The row-partitioned distributed layer (counterpart of
mpi_bicgstab_tpu/parallel/): the process grid, the communicator, the
partition and its SpMVs, and the distributed solve drivers. Start the
ranks with parallel/launch.py."""
from mpi_bicgstab_tpu_torch.parallel.comm import Comm  # noqa: F401
from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh  # noqa: F401
from mpi_bicgstab_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedMatrix,
    partition_csr,
)
