"""Seconds from the process's start to the window's opening: imports,
CUDA, the kernels' library, data, model, pools and the set-up sweeps
that build every shape the window runs."""


def read(run):
    return run.setup_s
