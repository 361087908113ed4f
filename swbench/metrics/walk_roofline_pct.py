"""walk_roofline_pct: the least time of walking the window's finished
alignments (roofline.py: their path steps, as the entry counts them from
each batch's first call, every call of a batch aligning the same pairs)
over the device time of every kernel of the ``walk`` stage in the traced
window, in %.  Nothing when the trace holds no walk kernel or the entry's
results hold no path."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    device_s = ctx.trace.stage_seconds("walk")
    if device_s <= 0:
        return None
    steps = sum(ctx.steps.get(c.batch, 0) for c in ctx.calls)
    if steps == 0:
        return None
    least, by = ctx.roofline.least(*ctx.roofline.walk_work(steps))
    ctx.notes["walk_roofline_pct"] = f"bound by {by}: {least} s"
    return 100.0 * least / device_s
