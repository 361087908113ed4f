"""fill_roofline_pct: the least time of the window's fills (roofline.py:
operations a true cell for the mode, pointer, code, end-state and table
bytes) over the device time of every kernel of the ``fill`` stage in the
traced window, in %.  Nothing when the trace holds no fill kernel."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.stage_seconds("fill")
    if device_s <= 0:
        return None
    lens = [(len(a), len(b)) for c in ctx.calls
            for a, b in ctx.batches[c.batch]]
    ops, nbytes = ctx.roofline.fill_work(ctx.config["mode"], lens,
                                         len(ctx.config["matrix"]["letters"]),
                                         len(ctx.calls))
    least, by = ctx.roofline.least(ops, nbytes)
    ctx.notes["fill_roofline_pct"] = f"bound by {by}: {least} s"
    return 100.0 * least / device_s
