"""Peak device memory of the window (torch.cuda.max_memory_allocated
after a reset at its start), in 10^9 bytes."""
UNIT = "GB"


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
