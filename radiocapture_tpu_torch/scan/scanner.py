"""Conventional ("scanner") capture: squelch-probe many channels at once,
open a recording on carrier detect (port of
``radiocapture_tpu.scan.scanner``).

Replaces the reference's ``scanning_receiver.py`` (alpha-quality
conventional capture, README.md:11): there, one ``gr.hier_block2`` per
channel runs ``simple_squelch_cc(threshold, 0.1)`` into a null sink, a
poll thread checks ``squelch.unmuted()`` every 10 ms and calls
``call_progress(freq)``, which either refreshes an active recorder
(``r.activity()``) or allocates a new ``logging_receiver`` with a
synthetic CDR (scanning_receiver.py:53-97, hang_time 0.5 s).

Here all monitored channels are slots of one batched
``AnalogVoicePipeline`` of one source (the bank and the voice kernels on
the card), whose step returns per-slot channel power; the squelch
decision and call bookkeeping are host logic, and the events follow the
call-manager contract (``new_call`` / ``timeout`` CDRs) the trunked
paths use.
"""

from __future__ import annotations

import time
import uuid as _uuid
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from radiocapture_tpu_torch.device import resolve, wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import AnalogVoicePipeline


@dataclass
class ScanChannel:
    frequency: float
    threshold: float = 1e-3      # linear power (simple_squelch_cc takes dB
                                 # in GR; configs store linear ‘threshold’)
    system_id: str = "scan"
    modulation: str = "analog"   # analog | p25 | provoice
    active_call: str | None = None
    last_activity: float = 0.0


class ScanningReceiver:
    """Squelch-scan a set of conventional channels from one wideband
    source on ``device`` (``None``: the card).

    on_new_call(cdr) / on_activity(call_uuid) / on_timeout(cdr) mirror
    the call-manager event contract; hang_time 0.5 s like the reference
    (scanning_receiver.py:28).
    """

    HANG_TIME = 0.5

    def __init__(self, channels: list[ScanChannel], samp_rate: float,
                 center_freq: float,
                 on_new_call: Callable[[dict], None] | None = None,
                 on_activity: Callable[[str], None] | None = None,
                 on_timeout: Callable[[dict], None] | None = None,
                 clock: Callable[[], float] = time.time,
                 device=None):
        self.channels = channels
        self.samp_rate = float(samp_rate)
        self.center_freq = float(center_freq)
        self.on_new_call = on_new_call or (lambda cdr: None)
        self.on_activity = on_activity or (lambda cu: None)
        self.on_timeout = on_timeout or (lambda cdr: None)
        self.clock = clock
        self.device = resolve(device)
        self.pipe = AnalogVoicePipeline(num_slots=max(1, len(channels)),
                                        samp_rate=samp_rate)
        self.state = self.pipe.init(1, self.device)
        # unused slots sit at offset 0 (the JAX scanner's padding)
        offs = np.asarray(
            [(c.frequency - center_freq) / samp_rate for c in channels]
            + [0.0] * (self.pipe.num_slots - len(channels)), np.float32)
        self._offs = torch.as_tensor(offs[None], device=self.device)
        self._cdrs: dict[str, dict] = {}

    @property
    def decim(self) -> int:
        return self.pipe.decim

    def feed(self, wideband_block: np.ndarray) -> list[dict]:
        """Process one wideband block ([T] complex or [T, 2] float32,
        T a multiple of ``decim``); returns the CDRs opened this block.

        The audio output is discarded here — once a call is open the
        recorder allocates its own slot, exactly like the reference
        allocating a fresh ``logging_receiver`` (scanning_receiver.py:75).
        """
        x = wideband_block
        if np.iscomplexobj(x):
            x = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        self.state, (_audio, power) = self.pipe.step(
            self.state, wire_from_numpy(x[None], self.device), self._offs)
        power = power[0].cpu().numpy()
        now = self.clock()
        opened = []
        for i, ch in enumerate(self.channels):
            if power[i] >= ch.threshold:
                if ch.active_call:
                    ch.last_activity = now
                    self.on_activity(ch.active_call)
                else:
                    cdr = self._open_call(ch, now)
                    opened.append(cdr)
            elif (ch.active_call
                  and now - ch.last_activity > self.HANG_TIME):
                self._close_call(ch)
        return opened

    def _open_call(self, ch: ScanChannel, now: float) -> dict:
        call_uuid = str(_uuid.uuid4())
        # The reference scanner's synthetic CDR uses the frequency as the
        # group id (scanning_receiver.py:87-94).
        cdr = {"call_uuid": call_uuid, "system_id": ch.system_id,
               "system_group_local": ch.frequency,
               "system_user_local": 0,
               "system_channel_local": ch.frequency,
               "frequency": ch.frequency, "type": "group",
               "modulation_type": ch.modulation,
               "hang_time": self.HANG_TIME}
        ch.active_call = call_uuid
        ch.last_activity = now
        self._cdrs[call_uuid] = cdr
        self.on_new_call(cdr)
        return cdr

    def _close_call(self, ch: ScanChannel) -> None:
        cdr = self._cdrs.pop(ch.active_call, None)
        ch.active_call = None
        if cdr:
            self.on_timeout(cdr)

    def close_all(self) -> None:
        for ch in self.channels:
            if ch.active_call:
                self._close_call(ch)
