"""device.idle_share (%): 1 - the union of the device's operation
intervals over the profiled segment of the traced run (torch.profiler)."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
