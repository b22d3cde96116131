"""Fused double-float classic BiCGStab: K1, K2, K3 (csrc/fused_classic_df.cu,
kernel table rows 9-11) and the DF DIA SpMV (csrc/dia_spmv.cu), which the
fused driver runs for the true residual at each exit. A DF value is 8
bytes (hi, lo); the band is n_diags planes of n DF values."""
from perfbench.roofline import DF_DOT_FLOPS as DOT
from perfbench.roofline import DF_FMA_FLOPS as FMA
from perfbench.roofline import kernel


def k1(s):   # r, p, s, r_hat in; p', s' out; the band; rTr in, alpha out
    n, W, nz = s["n"], s["n_diags"], s["band_entries"]
    return 8 * (W * n + 6 * n + 5), FMA * (nz + 2 * n) + DOT * n, "f32"


def k2(s):   # r, s' in; q, y out; the band; omega out
    n, W, nz = s["n"], s["n_diags"], s["band_entries"]
    return 8 * (W * n + 4 * n + 4), FMA * (nz + n) + 2 * DOT * n, "f32"


def k3(s):   # x, p', q, y, r_hat in; x', r' out; rTr in, beta out
    n = s["n"]
    return 8 * (7 * n + 6), 3 * FMA * n + 2 * DOT * n, "f32"


def spmv_df(s):   # the band, x in; y out
    n, W, nz = s["n"], s["n_diags"], s["band_entries"]
    return 8 * (W * n + 2 * n), FMA * nz, "f32"


KERNELS = [(kernel("k1_df_kernel"), k1), (kernel("k2_df_kernel"), k2),
           (kernel("k3_df_kernel"), k3),
           (kernel("dia_spmv_df_kernel"), spmv_df)]
