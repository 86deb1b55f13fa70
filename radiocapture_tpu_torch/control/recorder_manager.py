"""Call recording orchestration: new_call → slot + recorder, timeout →
close.

Merges the reference's ``call_recorder`` (one object per demod instance
subscribing to its new_call/timeout topics, call_recorder.py:51-78) and
``call_recorder_manager`` (lifecycle tied to demod presence,
call_recorder_manager.py:30-49). Where the reference's logging_receiver
dials the frontend for a channel (logging_receiver.py:94-105), recorders
here claim a slot from the ``ChannelScheduler``; the overseer's capture
loop then routes that slot's pipeline outputs to ``feed_slot`` every
block.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from radiocapture_tpu_torch.audio.recorder import CallRecorder

log = logging.getLogger(__name__)

# CDR modulation_type -> the per-slot dibit stream class that can decode
# it (the runtime keys its batched pipelines by these names). The
# reference builds a dedicated flowgraph per modulation inside
# logging_receiver.configure_blocks (logging_receiver.py:131-352); here
# each class is one shared batched pipeline per source. TDMA voice runs
# 6000 Bd (logging_receiver.py:226-228, 285-287); ProVoice is 9600 Bd
# binary FSK on EDACS systems, same symbol chain as the EDACS control
# class (logging_receiver.py:334-351 uses DSD on the discriminator).
MOD_TO_STREAM = {
    "p25": "c4fm",
    "p25_tdma": "c4fm_tdma",
    "p25_cqpsk": "cqpsk",
    "p25_cqpsk_tdma": "cqpsk_tdma",
    "provoice": "edacs",
}


class RecorderManager:
    #: cap on retained open-latency samples (soak runs record many)
    MAX_LATENCY_SAMPLES = 20000

    def __init__(self, bus, scheduler, audio_dir: str = "audio",
                 channel_fs: float = 25000.0, keep_wav: bool = False,
                 require_stream=None, now_fn=None):
        """``require_stream(source_idx, stream_cls)``: callback asking the
        capture loop to provision the named dibit pipeline on a source
        before the next block (lazy — TDMA/CQPSK voice classes only
        compile when a system actually grants such a channel).

        ``now_fn``: the call managers' clock (SiteRuntime's stream or
        wall clock) — used to measure grant→first-voice-block latency
        on the same timeline the CDR ``time_open`` is stamped on."""
        import time as _time
        self.bus = bus
        self.scheduler = scheduler
        self.audio_dir = audio_dir
        self.channel_fs = channel_fs
        self.keep_wav = keep_wav
        self.require_stream = require_stream
        self.now = now_fn or _time.time
        self._lock = threading.RLock()
        # call_uuid -> (recorder, source_idx, slot_idx, block_id, kind)
        self.active: dict[str, tuple] = {}
        self._instances: set[str] = set()
        #: grant→first-voice-block latency samples: (seconds, warm) —
        #: the reference's idle-reuse economics deliver sub-second
        #: grant-to-recording (rc_frontend/receiver.py:51,307-341);
        #: this measures the slot-hysteresis equivalent end to end.
        self.open_latencies: list[tuple[float, bool]] = []
        self.grants_denied = 0

    # ---- demod presence lifecycle (call_recorder_manager.py:30-49) ----
    def notify_demod_new(self, dtype: str, instance_uuid: str,
                         record: dict | None = None) -> None:
        if instance_uuid in self._instances:
            return
        self._instances.add(instance_uuid)
        self.bus.subscribe(f"/topic/call_management/new_call/{instance_uuid}",
                           self.process_new_call)
        self.bus.subscribe(f"/topic/call_management/timeout/{instance_uuid}",
                           self.process_call_timeout)

    def notify_demod_expire(self, dtype: str, instance_uuid: str) -> None:
        if instance_uuid not in self._instances:
            return
        self._instances.discard(instance_uuid)
        self.bus.unsubscribe(
            f"/topic/call_management/new_call/{instance_uuid}")
        self.bus.unsubscribe(
            f"/topic/call_management/timeout/{instance_uuid}")
        with self._lock:
            for cu, (rec, *_rest) in list(self.active.items()):
                if rec.instance_uuid == instance_uuid:
                    self._close(cu)

    # ---- call lifecycle (call_recorder.py:57-78) ----
    def process_new_call(self, cdr: dict) -> None:
        call_uuid = cdr["call_uuid"]
        with self._lock:
            if call_uuid in self.active:
                return
            client = f"recorder-{cdr['instance_uuid'][:8]}"
            alloc = self.scheduler.create_channel_ex(
                client, cdr.get("channel_bandwidth", 12500.0) * 2,
                cdr["frequency"])
            if alloc is None:
                log.warning("no slot for call %s @ %s", call_uuid,
                            cdr["frequency"])
                self.grants_denied += 1
                return
            src, slot, block_id, warm = alloc
            rec = CallRecorder(cdr, self.bus, audio_dir=self.audio_dir,
                               channel_fs=self.channel_fs,
                               keep_wav=self.keep_wav).open()
            rec.alloc_warm = warm
            rec.first_fed = False
            kind = MOD_TO_STREAM.get(cdr.get("modulation_type"),
                                     "analog")
            if kind != "analog" and self.require_stream is not None:
                self.require_stream(src, kind)
            self.active[call_uuid] = (rec, src, slot, block_id, kind)

    def process_call_timeout(self, ev: dict) -> None:
        self._close(ev["call_uuid"])

    def _close(self, call_uuid: str, patches: dict | None = None) -> None:
        with self._lock:
            entry = self.active.pop(call_uuid, None)
        if entry is None:
            return
        rec, src, slot, block_id, kind = entry
        rec.close(patches)
        self.scheduler.release_channel(
            f"recorder-{rec.instance_uuid[:8]}", block_id)

    def close_all(self) -> None:
        with self._lock:
            for cu in list(self.active):
                self._close(cu)

    # ---- capture-loop feed ----
    def feed_source_block(self, source_idx: int, *, audio=None, power=None,
                          dibit_streams=None) -> None:
        """Route one block of per-slot pipeline outputs to the recorders
        holding slots on this source.

        audio/power from AnalogVoicePipeline ([slots, T'], [slots]);
        dibit_streams maps stream class (``MOD_TO_STREAM`` values) ->
        (dibits [slots, N], valid [slots, N]) from the matching digital
        pipeline — a CQPSK/TDMA call must never be fed another class's
        symbol decisions (an LSM channel through the FM-discriminator
        path yields garbage dibits that silently never sync)."""
        dibit_streams = dibit_streams or {}
        with self._lock:
            entries = [e for e in self.active.values()
                       if e[1] == source_idx and not e[0].closed]
        if not entries:
            return
        # Materialize each consumed stream ONCE per block — a per-slot
        # jax-array row fetch costs a full device sync, and N recorders
        # on one source would pay it N times (measured 68 fetches/step
        # at 32 open calls before hoisting).
        kinds = {e[4] for e in entries}
        if "analog" in kinds and audio is not None:
            audio = np.asarray(audio)
            power = np.asarray(power)
        streams = {k: (np.asarray(d), np.asarray(v))
                   for k, (d, v) in dibit_streams.items() if k in kinds}
        for rec, src, slot, _bid, kind in entries:
            fed = False
            if kind == "analog":
                if audio is not None:
                    rec.feed_audio(audio[slot], float(power[slot]))
                    fed = True
            elif kind in streams:
                dibits, valid = streams[kind]
                v = valid[slot].astype(bool)
                rec.feed_dibits(dibits[slot][v])
                fed = True
            if fed and not getattr(rec, "first_fed", True):
                rec.first_fed = True
                lat = self.now() - rec.cdr.get("time_open", self.now())
                if len(self.open_latencies) < self.MAX_LATENCY_SAMPLES:
                    self.open_latencies.append(
                        (float(lat), bool(getattr(rec, "alloc_warm",
                                                  False))))

    def active_streams(self) -> set:
        """{(source_idx, stream_kind)} for every open recorder — lets
        the capture loop prefetch exactly the group outputs somebody
        will consume this block."""
        with self._lock:
            return {(src, kind)
                    for _rec, src, _slot, _bid, kind
                    in self.active.values()}

    def heartbeat_clients(self) -> None:
        """Keep recorder slot claims alive (frontend_connector.py:197)."""
        with self._lock:
            clients = {f"recorder-{rec.instance_uuid[:8]}"
                       for rec, *_ in self.active.values()}
        for c in clients:
            self.scheduler.heartbeat(c)
