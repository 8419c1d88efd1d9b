"""Peak device memory allocated in the window, in GB (1e9 bytes):
torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's opening."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e9
