"""pipeline.launches (launches): the hand-kernel launches a block, the
``kernel.*`` spans under each of the block's root spans (``pipeline.step``,
and ``split2.step`` where the cell splits its sources) over the requests of
that name, summed over the two. Read from the program's tracer
(``radiocapture_tpu_torch.utils.trace``), which records while the traced
segment's profiler runs; 0 on the CPU's plain path; None with no step
traced, or where the program has no tracer."""

ROOTS = ("pipeline.step", "split2.step")


def read(ctx):
    try:
        from radiocapture_tpu_torch.utils import trace
    except ImportError:
        return None
    roots = trace.summary()["roots"]
    if not roots.get("pipeline.step"):
        return None
    n = 0.0
    for root in ROOTS:
        if roots.get(root):
            n += sum(s["n"] for name, s in trace.summary(root)["spans"].items()
                     if name.startswith("kernel.")) / roots[root]
    return n
