"""rebuild_ms: the program's own host time of a call's string rebuild
(``BatchAligner.phase["reconstruct"]``), averaged over the window's
calls, in ms."""


def read(ctx):
    vals = [c.phase["reconstruct"] for c in ctx.calls
            if "reconstruct" in c.phase]
    return 1e3 * sum(vals) / len(vals) if vals else None
