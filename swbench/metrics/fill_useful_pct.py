"""fill_useful_pct: the true cells of the traced window's calls (the
program's ``cells.true``, the sum of n * m of each flush) over the cells
its fill kernels' launches lay out (the program's ``cells.computed.<K>``:
rows rounded to a stripe or a band, each band K4 refills once more), in
%.  Nothing when the program logged no calls or counted no fill."""

from swbench import progtrace

PREFIX = "cells.computed."


def read(ctx):
    calls = progtrace.window_calls(ctx)
    if not calls:
        return None
    true = sum(c.counts.get("cells.true", 0) for c in calls)
    by = {}
    for c in calls:
        for k, n in c.counts.items():
            if k.startswith(PREFIX):
                by[k[len(PREFIX):]] = by.get(k[len(PREFIX):], 0) + n
    computed = sum(by.values())
    if computed <= 0:
        return None
    ctx.notes["fill_useful_pct"] = "cells a call: true " + ", ".join(
        [f"{true / len(calls):.6g}"] + [f"{k} {n / len(calls):.6g}"
                                        for k, n in sorted(by.items())])
    return 100.0 * true / computed
