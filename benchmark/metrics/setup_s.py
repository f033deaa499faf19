"""Set-up seconds: from the process's start (before torch is imported) to
the window's start: imports, the kernels' build where it is not cached,
the seeded weights and inputs, the compared first steps and the warm-up."""


def read(run):
    return run.setup_s
