"""demod.roofline (%): the demodulator's least time (bytes: the planes
in, the symbols, valid and dibits out, the lane state in and out) over
its mean device time, timed by CUDA events around the call into it."""

from benchmark.core.roofline import share


def read(ctx):
    return share(ctx, "demod")
