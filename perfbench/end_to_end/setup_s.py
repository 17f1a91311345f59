"""Seconds from the process's start to the window's start: imports, the CUDA
context, the data, the searcher's build, staging and the warm-up (and, in
a checkout's first run, the build of the port's kernel library)."""


def read(window):
    return window.setup_s
