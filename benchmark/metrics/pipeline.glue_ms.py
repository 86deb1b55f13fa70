"""pipeline.glue_ms (ms): the step's device time outside its hand kernels,
a block: for each root span of the block (``pipeline.step``, and
``split2.step`` where the cell splits its sources), the least over the
requests of that name timed on the device of the root's device time less
that of the ``kernel.*`` spans inside it, summed over the two. Read from
the program's tracer (``radiocapture_tpu_torch.utils.trace``), which
records while the traced segment's profiler runs and times one request in
``DEVICE_EVERY`` on the device. A request's glue is the eager ops and the
timed request's own CUDA events between kernels, the same in every
request, plus whatever the device waited on the host inside the step,
which only adds: the least request is the one that waited least (the
waits are ``device.idle_share``'s). None off the card, with no step
timed, or where the program has no tracer."""

ROOTS = ("pipeline.step", "split2.step")


def read(ctx):
    try:
        from radiocapture_tpu_torch.utils import trace
    except ImportError:
        return None
    roots = trace.summary()["roots"]
    if not roots.get("pipeline.step"):
        return None
    glue = 0.0
    for root in ROOTS:
        if not roots.get(root):
            continue
        timed = trace.requests(root)
        if not timed:
            return None
        glue += min(req[root] - sum(v for name, v in req.items()
                                    if name.startswith("kernel."))
                    for req in timed)
    return 1e3 * glue
