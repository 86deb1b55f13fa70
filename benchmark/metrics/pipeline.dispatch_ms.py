"""pipeline.dispatch_ms (ms): the host's time to enqueue one step, the
benchmark's own span around the call into the pipeline's step, the mean
over the traced window's blocks."""


def read(ctx):
    ts = ctx.get("dispatch_s") or []
    return 1e3 * sum(ts) / len(ts) if ts else None
