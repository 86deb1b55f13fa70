"""Analog voice through the xlat frontend: ``AnalogVoicePipeline.step`` =
the wire bank (``XlatBank.call_planes``: ``bank_operands`` and
``xlat_bank``) then the fused voice tracker (``fm_voice``: discriminator,
75 µs de-emphasis, power). The channelizer's span is the call into the
bank; the demodulator's runs from there to the end of the step. Its
answers are audio and power, judged by ``core/voice.py``."""

from __future__ import annotations

import torch

from benchmark.core import spec, voice
from benchmark.core.traffic import block_len
from benchmark.reference.channelize import slot_offsets


class Path:
    frontend = "xlat"
    reference = "xlat"
    demod = "fm"
    work = {"channelize": "xlat_bank", "demod": "fm_voice"}
    Judge = voice.Judge

    def __init__(self, cfg: dict, traffic: dict, dev):
        from radiocapture_tpu_torch.frontend.pipeline import (
            AnalogVoicePipeline)
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        rate = traffic["samp_rate"]
        self.pipe = AnalogVoicePipeline(
            cfg["slots"], rate, cfg["channel_rate"], cfg["max_dev_hz"],
            frontend=self.frontend)
        self.block = block_len(traffic, self.pipe.block_multiple)
        self.sources = traffic["sources"]
        self.slots = cfg["slots"]
        self.lanes = self.sources * self.slots
        self.channel_fs = self.pipe.channel_fs
        self.samples_per_block = self.sources * self.block
        self.offs = torch.as_tensor(slot_offsets(cfg, rate, self.sources),
                                    device=dev)
        self.slot_hz = spec.chan_module(self.reference).Chan.slot_hz(cfg,
                                                                     rate)
        self.probe = None

    def attach(self, probe) -> None:
        bank = self.pipe.bank
        call_planes = bank.call_planes
        self.probe = probe

        def probed_call_planes(state, x, offs):
            probe.mark("channelize.start")
            out = call_planes(state, x, offs)
            probe.mark("channelize.end")
            probe.mark("demod.start")
            probe.planes(out[1], out[2])
            return out

        bank.call_planes = probed_call_planes

    def init(self):
        return self.pipe.init(self.sources, self.dev)

    def step(self, state, x):
        out = self.pipe.step(state, x, self.offs)
        if self.probe is not None:
            self.probe.mark("demod.end")
        return out

    def state_dict(self, state) -> dict:
        """Copies of the carried state, lane-major where it is a lane's."""
        n = self.lanes
        return {"chan": {"bank.history": state.bank.history.clone(),
                         "bank.phase": state.bank.phase.clone()},
                "demod": {"quad.prev": state.quad.prev.reshape(n).clone(),
                          "deemph.y_last":
                              state.deemph.y_last.reshape(n).clone(),
                          "deemph.x_last":
                              state.deemph.x_last.reshape(n).clone()}}

    def lane_planes(self, kept) -> torch.Tensor:
        y_re, y_im = kept
        s, n, c = y_re.shape
        return torch.complex(y_re, y_im).permute(0, 2, 1).reshape(s * c, n)

    def lane_outputs(self, outs) -> tuple:
        """(audio [L, N], power [L])."""
        audio, power = outs
        return audio.reshape(self.lanes, -1), power.reshape(self.lanes)
