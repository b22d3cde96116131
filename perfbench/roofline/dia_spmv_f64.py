"""The float64 DIA SpMV (csrc/dia_spmv.cu, kernel table row 1, f64
form): the band and x in, y out; two operations per band entry."""
from perfbench.roofline import kernel


def spmv(s):
    n, W, nz = s["n"], s["n_diags"], s["band_entries"]
    return 8 * (W * n + 2 * n), 2 * nz, "f64"


KERNELS = [(kernel("dia_spmv_kernel") + r"<double", spmv)]
