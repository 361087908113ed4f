"""call_p95_ms: the 95th percentile of a call's host wall, from submit to
results on the host, over every call of the window (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(ctx):
    walls = [c.t1 - c.t0 for c in ctx.calls]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
