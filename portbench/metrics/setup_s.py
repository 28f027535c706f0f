"""setup_s: from the harness's start to the window's open: the imports
and the CUDA context, the program's libraries (built on a checkout's
first run), the inputs and the warm-up (host clock)."""


def read(run):
    return run.setup_s
