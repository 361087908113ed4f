"""setup_s: host seconds from the process's start to the window's start:
imports, CUDA's start, loading (on a checkout's first run, building) the
program's kernels, making the inputs and one warm call of every batch."""


def read(ctx):
    return ctx.setup_s
