"""copyback_ms: the program's own host time of a call's copies of its
flushes' results to the host (its ``copy`` spans, the wait for the
device's stream apart), averaged over the traced window's calls, in ms.
Nothing when the program logged no calls."""

from swbench import progtrace


def read(ctx):
    calls = progtrace.window_calls(ctx)
    if not calls:
        return None
    nbytes = sum(s.attrs.get("bytes", 0) for c in calls for s in c.spans
                 if s.name == "copy")
    wait = sum(progtrace.span_seconds(c, "wait") for c in calls)
    ctx.notes["copyback_ms"] = (f"{nbytes / len(calls):.0f} bytes a call; "
                                f"the wait before {1e3 * wait / len(calls):.3f}"
                                " ms a call")
    return 1e3 * sum(progtrace.span_seconds(c, "copy")
                     for c in calls) / len(calls)
