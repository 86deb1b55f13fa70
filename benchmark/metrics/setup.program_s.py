"""setup.program_s (s): the program's own set-up in the run, from its
counters (``radiocapture_tpu_torch.utils.trace``): the kernel library's
load (``setup.kernels_s``), filter design (``setup.design_s``) and the
first-seen constants and plans (``setup.plans_s``). The library's
``nvcc`` build, which only a checkout's first run pays, is left out. None
where the program counts none of them."""

KEYS = ("setup.kernels_s", "setup.design_s", "setup.plans_s")


def read(ctx):
    try:
        from radiocapture_tpu_torch.utils import trace
    except ImportError:
        return None
    counters = trace.summary()["counters"]
    if not any(k in counters for k in KEYS):
        return None
    return sum(counters.get(k, 0.0) for k in KEYS)
