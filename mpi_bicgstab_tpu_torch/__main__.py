import sys

from mpi_bicgstab_tpu_torch.cli import main

sys.exit(main())
