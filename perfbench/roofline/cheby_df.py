"""The double-float Chebyshev chain p(A) v (csrc/cheby.cu, kernel table
row 30), one launch per application at degree d: the band, v in and x
out, each byte once (the band that each step reads again is not
counted); one df_fma per band entry and four per row at each step."""
from perfbench.roofline import DF_FMA_FLOPS as FMA
from perfbench.roofline import kernel


def chain(s):
    n, W, nz, d = s["n"], s["n_diags"], s["band_entries"], s["degree"]
    return 8 * (W * n + 2 * n), FMA * (nz * d + 4 * n * d), "f32"


KERNELS = [(kernel("cheby_df_kernel"), chain)]
