"""gcups: true DP cells (the sum of n * m over every pair of every call
completed in the window) over the window's host time, in Gcells/s."""


def read(ctx):
    cells = sum(ctx.cells[c.batch] for c in ctx.calls)
    return cells / (ctx.t1 - ctx.t0) / 1e9
