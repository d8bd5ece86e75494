"""setup_s (s): from the process's start to the start of the window:
imports, the CUDA context, the clips made from the seed, the entry's
warm-up call (kernel builds on a checkout's first run, graph captures)."""


def read(r):
    return r.setup_s
