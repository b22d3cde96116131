"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load: the run prints its power limit beside the
shares it reports."""

HBM_BYTES_PER_S = 3.35e12
# operations per second by the arithmetic a kernel runs on: float32
# outside the tensor cores (double-float pairs are float32 arithmetic),
# float64 outside the tensor cores
FLOPS_PER_S = {"f32": 67e12, "f64": 34e12}


def least_seconds(nbytes: float, flops: float, kind: str) -> float:
    """The least time the card could take: the larger of the bytes at
    the HBM rate and the operations at the peak rate of `kind`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[kind])
