"""The benchmark's own spans around the program's layers.

A path wraps the calls into a layer (the channelizer's and the
demodulator's entry points) with ``Probe.mark``. With tracing on, each
mark records a CUDA event on the current stream, so a stage's device
time is the time between its two marks on the device's clock, whatever
kernels implement it. With tracing off a mark does nothing. ``keep``
makes the wrapper hold the channel planes the channelizer returned for
the block being dispatched, for the correctness check after the window.
"""

from __future__ import annotations

import torch

class Probe:
    def __init__(self, trace: bool, dev: torch.device):
        self.trace = trace and dev.type == "cuda"
        self.active = False
        self.keep = False
        self.kept = None
        self.blocks: list[dict] = []
        self._cur: dict | None = None

    def begin_block(self) -> None:
        """Start the marks of the next block: recorded while ``active``
        (the traced window), dropped otherwise."""
        self._cur = None
        if self.trace and self.active:
            self._cur = {}
            self.blocks.append(self._cur)

    def mark(self, name: str) -> None:
        if self._cur is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._cur[name] = ev

    def planes(self, y_re: torch.Tensor, y_im: torch.Tensor) -> None:
        if self.keep:
            self.kept = (y_re, y_im)

    def stage_ms(self, stage: str) -> list[float]:
        """Device ms of ``stage`` in each traced block."""
        return [b[f"{stage}.start"].elapsed_time(b[f"{stage}.end"])
                for b in self.blocks
                if f"{stage}.start" in b and f"{stage}.end" in b]
