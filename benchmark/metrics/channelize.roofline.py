"""channelize.roofline (%): the channelizer's least time for the cell's
work (``work/`` of the path's channelize stage) over its mean device time,
timed by CUDA events around the pipeline's call into the channelizer."""

from benchmark.core.roofline import share


def read(ctx):
    return share(ctx, "channelize")
