"""The double-float shift update of the seed-switching solver
(csrc/shift_update_df.cu, kernel table row 18): the four float planes of
the [S, n] x_set and p_set state read and written once, q, r_old and
r_new and the six DF [S] coefficients read once; three df_fma, three
df_mul and two df_add per (shift, row). Every shift row counts, frozen
ones too: the kernel passes them through, and which rows are frozen at a
launch is not in the trace."""
from perfbench.roofline import DF_ADD_FLOPS, DF_FMA_FLOPS, DF_MUL_FLOPS
from perfbench.roofline import kernel


def update(s):
    n, S = s["n"], s["n_shifts"]
    return (8 * (4 * S * n + 3 * n + 6 * S),
            S * n * (3 * DF_FMA_FLOPS + 3 * DF_MUL_FLOPS + 2 * DF_ADD_FLOPS),
            "f32")


KERNELS = [(kernel("shift_update_df_kernel"), update)]
