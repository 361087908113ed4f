"""host_stall_ms: the device's idle time inside the program's calls (the
trace's idle gaps that fall between a call's start and end on the
program's own clock), averaged over the traced window's calls, in ms.
The note splits it by the innermost program span open through it, and
gives the share no span below ``call`` covers.  Nothing when the program
logged no calls."""

from swbench import progtrace


def read(ctx):
    calls = progtrace.window_calls(ctx)
    if not calls:
        return None
    idle = progtrace.idle_by_span(calls, ctx.trace.gaps)
    total = sum(idle.values())
    bare = idle.get("call", 0.0)
    ctx.notes["host_stall_ms"] = "idle ms a call by span: " + ", ".join(
        f"{name} {1e3 * s / len(calls):.3f}"
        for name, s in sorted(idle.items(), key=lambda kv: -kv[1])) + (
        f"; under a span below call {100 * (1 - bare / total):.2f} %"
        if total > 0 else "")
    return 1e3 * total / len(calls)
