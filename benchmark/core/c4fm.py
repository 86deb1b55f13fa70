"""Build and step the program's P25 C4FM control pipeline
(``ControlPipeline.p25_c4fm``-style, through the configuration's
constants) on one frontend, and read its state, outputs and channel
planes in the judge's lane-major layout. The pipeline's own entry,
``ControlPipeline.step``, is the timed call; the probe wraps the two
layers it calls into on the instance (``bank.call_planes``, ``_track``).
"""

from __future__ import annotations

import torch

from benchmark.core import spec
from benchmark.core.traffic import block_len
from benchmark.reference.channelize import slot_offsets


class C4fmPath:
    frontend = "xlat"
    reference = "xlat"
    demod = "fsk4"
    work = {"channelize": "xlat_bank", "demod": "fsk_track"}

    def __init__(self, cfg: dict, traffic: dict, dev):
        from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        rate = traffic["samp_rate"]
        self.pipe = ControlPipeline(
            cfg["slots"], rate, cfg["channel_rate"], cfg["symbol_rate"],
            tuple(cfg["levels"]), cfg["deviation_hz"],
            frontend=self.frontend)
        self.block = block_len(traffic, self.pipe.block_multiple)
        self.sources = traffic["sources"]
        self.slots = cfg["slots"]
        self.lanes = self.sources * self.slots
        self.channel_fs = rate / self.pipe.decim
        self.samples_per_block = self.sources * self.block
        self.offs = torch.as_tensor(slot_offsets(cfg, rate, self.sources),
                                    device=dev)
        chan = spec.chan_module(self.reference).Chan
        self.slot_hz = chan.slot_hz(cfg, rate)

    def attach(self, probe) -> None:
        bank, pipe = self.pipe.bank, self.pipe
        call_planes, track = bank.call_planes, pipe._track

        def probed_call_planes(state, x, offs):
            probe.mark("channelize.start")
            out = call_planes(state, x, offs)
            probe.mark("channelize.end")
            probe.planes(out[1], out[2])
            return out

        def probed_track(state, bs, y_re, y_im):
            probe.mark("demod.start")
            out = track(state, bs, y_re, y_im)
            probe.mark("demod.end")
            return out

        bank.call_planes = probed_call_planes
        pipe._track = probed_track

    def init(self):
        return self.pipe.init(self.sources, self.dev)

    def step(self, state, x):
        return self.pipe.step(state, x, self.offs)

    def chan_state(self, bs) -> dict:
        return {"bank.history": bs.history.clone(),
                "bank.phase": bs.phase.clone()}

    def state_dict(self, state) -> dict:
        """Copies of the carried state, lane-major where it is a lane's."""
        n = self.lanes
        f = state.fsk4
        return {"chan": self.chan_state(state.bank),
                "demod": {"quad.prev": state.quad.prev.reshape(n).clone(),
                          "sym_hist": state.sym_hist.reshape(n, -1).clone(),
                          "fsk4.clock": f.clock.reshape(n).clone(),
                          "fsk4.fine_freq": f.fine_freq.reshape(n).clone(),
                          "fsk4.hist": f.hist.reshape(n, -1).clone()}}

    def lane_planes(self, kept) -> torch.Tensor:
        y_re, y_im = kept
        s, n, c = y_re.shape
        return torch.complex(y_re, y_im).permute(0, 2, 1).reshape(s * c, n)

    def lane_outputs(self, outs) -> tuple:
        syms, valid, dibits = outs
        n = self.lanes
        return (syms.reshape(n, -1), valid.reshape(n, -1).bool(),
                dibits.reshape(n, -1))
