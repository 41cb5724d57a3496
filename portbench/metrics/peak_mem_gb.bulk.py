"""Peak device memory the program's allocator held in the window:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start, in GB (1e9 bytes)."""

LAYER = "device"
UNIT = "GB"
MOVES = "utt_per_s"
SOURCE = "program_counter"


def read(run):
    return run.peak_bytes / 1e9 if getattr(run, "peak_bytes", 0) else None
