"""P25 LSM (CQPSK) control with ``receiver_split2``: ``SpectrumSplit2.step``
(the complex bank, ``xlat_complex``'s split2 path) → ``split2_sources`` →
``CqpskControlPipeline.step`` = the wire bank on the halves
(``bank_operands``, ``xlat_bank``), the AGC gain (``agc``) and the fused
CQPSK tracker (``cqpsk_track``). The channelizer's span runs from before
the split to the end of the wire bank; the demodulator's from there to
the end of the step."""

from __future__ import annotations

import torch

from benchmark.core import spec
from benchmark.core.traffic import block_len
from benchmark.reference.channelize import slot_offsets


class Path:
    reference = "split2"
    demod = "cqpsk"
    work = {"channelize": "split2_bank", "demod": "cqpsk_track"}

    def __init__(self, cfg: dict, traffic: dict, dev):
        from radiocapture_tpu_torch.frontend.pipeline import (
            CqpskControlPipeline, SpectrumSplit2, split2_sources)
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        rate = traffic["samp_rate"]
        self.split = SpectrumSplit2(rate)
        self.pipe = CqpskControlPipeline(
            cfg["slots"], rate / 2.0, cfg["channel_rate"], cfg["symbol_rate"],
            frontend=traffic["frontend"])
        self.sources_of = split2_sources
        self.block = block_len(traffic, 2 * self.pipe.block_multiple)
        self.sources = traffic["sources"]
        self.slots = cfg["slots"]
        self.lanes = 2 * self.sources * self.slots
        self.channel_fs = rate / 2.0 / self.pipe.decim
        self.samples_per_block = self.sources * self.block
        self.offs = torch.as_tensor(
            slot_offsets(cfg, rate / 2.0, 2 * self.sources), device=dev)
        chan = spec.chan_module(self.reference).Chan
        self.slot_hz = chan.slot_hz(cfg, rate)
        self.probe = None

    def attach(self, probe) -> None:
        bank = self.pipe.bank
        call_planes = bank.call_planes
        self.probe = probe

        def probed_call_planes(state, x, offs):
            out = call_planes(state, x, offs)
            probe.mark("channelize.end")
            probe.mark("demod.start")
            probe.planes(out[1], out[2])
            return out

        bank.call_planes = probed_call_planes

    def init(self):
        return (self.split.init(self.sources, self.dev),
                self.pipe.init(2 * self.sources, self.dev))

    def step(self, state, x):
        probe = self.probe
        if probe is not None:
            probe.mark("channelize.start")
        s2, halves = self.split.step(state[0], x)
        cs, out = self.pipe.step(state[1], self.sources_of(halves), self.offs)
        if probe is not None:
            probe.mark("demod.end")
        return (s2, cs), out

    def state_dict(self, state) -> dict:
        s2, cs = state
        n = self.lanes
        demod = {}
        for k in spec.demod_module(self.demod).STATE:
            t = getattr(cs.cqpsk, k).reshape(n, -1)
            demod[k] = (t if k.startswith("hist") else t[:, 0]).clone()
        return {"chan": {"split2.history": s2.history.clone(),
                         "split2.phase": s2.phase.clone(),
                         "bank.history": cs.bank.history.clone(),
                         "bank.phase": cs.bank.phase.clone()},
                "demod": demod}

    def lane_planes(self, kept) -> torch.Tensor:
        y_re, y_im = kept
        s, n, c = y_re.shape
        return torch.complex(y_re, y_im).permute(0, 2, 1).reshape(s * c, n)

    def lane_outputs(self, outs) -> tuple:
        syms, valid, dibits = outs
        n = self.lanes
        return (syms.reshape(n, -1), valid.reshape(n, -1).bool(),
                dibits.reshape(n, -1))
