"""The roofline counts reproduce the "bound ms" column of PERF.md's kernel
table at its 1.6M-row shapes, and a share is least time over traced time."""
import pytest

from perfbench import peaks
from perfbench.roofline import load, share_pct

# transport-like:1602112 (rows 1, 9-11, 18 and the DF SpMV): 15 diagonals;
# transport-hard:1602112 (row 30): 117^3 rows, 13 diagonals
LIKE = {"n": 1_602_112, "n_diags": 15, "band_entries": 23_948_600,
        "n_shifts": 512}
HARD = {"n": 1_601_613, "n_diags": 13, "band_entries": 20_738_127,
        "degree": 8}


def _bound_ms(group, name, shapes):
    for rx, work in load(group).KERNELS:
        if rx == name or name in rx:
            return 1e3 * peaks.least_seconds(*work(shapes))
    raise KeyError(name)


@pytest.mark.parametrize("group,kernel,shapes,want", [
    ("classic_df", "k1_df_kernel", LIKE, 0.0803),
    ("classic_df", "k2_df_kernel", LIKE, 0.0727),
    ("classic_df", "k3_df_kernel", LIKE, 0.0268),
    ("classic_df", "dia_spmv_df_kernel", LIKE, 0.0650),
    ("shift_update_df", "shift_update_df_kernel", LIKE, 7.847),
    ("cheby_df", "cheby_df_kernel", HARD, 0.0583),
    ("dia_spmv_f64", "dia_spmv_kernel", LIKE, 0.0650),
])
def test_bound_ms_of_the_kernel_table(group, kernel, shapes, want):
    assert round(_bound_ms(group, kernel, shapes), 4 if want < 1 else 3) \
        == want


def test_cheby_chain_is_bound_by_operations_and_counts_the_band_once():
    nbytes, flops, kind = load("cheby_df").KERNELS[0][1](HARD)
    assert nbytes == 8 * 15 * HARD["n"]
    assert flops / peaks.FLOPS_PER_S[kind] > nbytes / peaks.HBM_BYTES_PER_S


def test_share_over_traced_launches_only_of_the_group():
    k1 = 1e-3 * _bound_ms("classic_df", "k1_df_kernel", LIKE)
    k3 = 1e-3 * _bound_ms("classic_df", "k3_df_kernel", LIKE)
    ev = [("void k1_df_kernel<false>(DiaOffsets, long long)", 0.0, 2e6 * k1),
          ("k3_df_kernel(long long)", 5.0, 1e6 * k3),
          ("void ca_k1_df_kernel<false>(DiaOffsets)", 9.0, 1e3),
          ("void at::native::add_kernel(int)", 7.0, 50.0)]
    assert share_pct("classic_df", LIKE, ev) == pytest.approx(
        100 * (k1 + k3) / (2 * k1 + k3))
    assert share_pct("shift_update_df", LIKE, ev) is None


def test_f64_group_takes_the_double_instance_only():
    ev = [("void dia_spmv_kernel<float>(DiaOffsets)", 0.0, 40.0),
          ("void dia_spmv_kernel<double>(DiaOffsets)", 50.0, 80.0)]
    got = share_pct("dia_spmv_f64", LIKE, ev)
    want = 100 * 1e-3 * _bound_ms("dia_spmv_f64", "dia_spmv_kernel", LIKE) \
        / 80e-6
    assert got == pytest.approx(want)
