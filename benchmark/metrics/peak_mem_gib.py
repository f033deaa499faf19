"""The device memory the window's program held at its peak:
``torch.cuda.max_memory_allocated()`` after a reset at the window's start,
read before the program is freed and the reference runs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
