"""The benchmark of the PyTorch and CUDA port (mpi_bicgstab_tpu_torch).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix
or metric sits in a file of its own, found by its name:
configs/<config>.json, traffic/<traffic>.json, metrics/<metric>.py,
roofline/<kernel group>.py. reference/ is the plain float64 yardstick.
"""
