"""Site runtime (port of ``radiocapture_tpu.runtime``): the reference's
``overseer.py __main__`` as a library.

Wires a deployment config into the full capture stack (SURVEY.md
§3.2-3.4) — grouped batched pipelines, per-system control demod
instances with control-channel hunting, per-protocol call managers, the
recorder manager, presence publication, and the metadata agent — and
steps it block by block. The hot path is one pipeline step per (rate,
class) group per block on the runtime's device; the control plane is
ordinary objects on an in-proc (or Redis-backed) bus, the host modules
copied from the JAX package.

Usage::

    cfg = load_config("configs/config_example_file.py")
    rt = SiteRuntime(cfg, {0: FileSource(path)}, device=require_cuda())
    rt.run(n_blocks=100)     # or rt.step() in an external loop

CLI (file and live SDR sources, one CUDA device):
``python -m radiocapture_tpu_torch.runtime -c <config.py> --blocks N``
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as _uuid

import numpy as np
import torch

from radiocapture_tpu_torch.control.bus import InProcBus, make_bus
from radiocapture_tpu_torch.control.call_manager import (P25CallManager,
                                                   MotoCallManager,
                                                   EdacsCallManager)
from radiocapture_tpu_torch.control.metadata_agent import MetadataAgent
from radiocapture_tpu_torch.control.presence import PresenceStore
from radiocapture_tpu_torch.control.recorder_manager import RecorderManager
from radiocapture_tpu_torch.demod.engines import (P25ControlEngine,
                                            EdacsControlEngine,
                                            MotoControlEngine)
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline,
                                                      CqpskControlPipeline)
from radiocapture_tpu_torch.frontend.scheduler import ChannelScheduler
from radiocapture_tpu_torch.rxconfig import RcConfig

log = logging.getLogger(__name__)

# pipeline class key per (system type, modulation). Voice-only classes:
# TDMA channels run 6000 Bd (logging_receiver.py:226-228, 285-287).
_CLS_C4FM, _CLS_CQPSK, _CLS_EDACS, _CLS_MOTO, _CLS_ANALOG = (
    "c4fm", "cqpsk", "edacs", "moto", "analog")
_CLS_C4FM_TDMA, _CLS_CQPSK_TDMA = "c4fm_tdma", "cqpsk_tdma"
_DIGITAL_CLASSES = (_CLS_C4FM, _CLS_CQPSK, _CLS_EDACS, _CLS_MOTO,
                    _CLS_C4FM_TDMA, _CLS_CQPSK_TDMA)


def _pipeline_class_for(sys_cfg) -> str:
    if sys_cfg.type == "p25":
        return _CLS_CQPSK if sys_cfg.modulation.upper() == "CQPSK" \
            else _CLS_C4FM
    return {"edacs": _CLS_EDACS, "moto": _CLS_MOTO}[sys_cfg.type]


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped (nested)
    NamedTuple states."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(*(_tree_map(fn, *leaves)
                            for leaves in zip(*trees)))


class ControlInstance:
    """One trunked system's control-channel receiver: engine + slot +
    hunting (p25_control_demod.py:213-261 tune_next_control_channel)."""

    def __init__(self, sys_cfg, scheduler: ChannelScheduler, bus,
                 site_uuid: str):
        self.cfg = sys_cfg
        self.scheduler = scheduler
        self.bus = bus
        self.site_uuid = site_uuid
        self.instance_uuid = str(_uuid.uuid4())
        self.cls = _pipeline_class_for(sys_cfg)
        self.client = f"demod-{self.instance_uuid[:8]}"
        self._cc_index = -1
        self.source_idx: int | None = None
        self.slot: int | None = None
        self.block_id: int | None = None
        self.control_channel: float = 0.0
        kw = dict(on_event=self._emit, on_lost_lock=self.tune_next,
                  instance_uuid=self.instance_uuid,
                  system_id=str(sys_cfg.id))
        if sys_cfg.type == "p25":
            self.engine = P25ControlEngine(**kw)
        elif sys_cfg.type == "edacs":
            self.engine = EdacsControlEngine(channels=sys_cfg.channels,
                                             esk=sys_cfg.esk, **kw)
        else:
            self.engine = MotoControlEngine(
                channels=sys_cfg.channels, cmd_offset=sys_cfg.cmd_offset,
                force_p25=sys_cfg.force_p25, **kw)
        self.scheduler.connect(self.client)
        self.tune_next()

    def _emit(self, ev: dict) -> None:
        self.bus.send_event_lazy(
            f"/topic/raw_control/{self.instance_uuid}", ev)

    def tune_next(self) -> None:
        """Hunt to the next candidate control channel."""
        if self.block_id is not None:
            self.scheduler.release_channel(self.client, self.block_id)
            self.block_id = None
        ccs = self.cfg.control_channels or list(
            self.cfg.channels.values())
        if not ccs:
            return
        self._cc_index = (self._cc_index + 1) % len(ccs)
        freq = ccs[self._cc_index]
        alloc = self.scheduler.create_channel(
            self.client, 2 * self.cfg.bandwidth, freq)
        if alloc is None:
            log.error("%s: no slot for control channel %s",
                      self.cfg.id, freq)
            return
        self.source_idx, self.slot, self.block_id = alloc
        self.control_channel = freq
        log.info("%s: tuned control channel %s (src %s slot %s)",
                 self.cfg.id, freq, self.source_idx, self.slot)

    def feed(self, dibits: np.ndarray) -> None:
        if self.cfg.type == "p25":
            self.engine.feed_dibits(dibits)
        else:
            # binary pipelines emit dibit==bit in the low bit
            self.engine.feed_bits(np.asarray(dibits, np.uint8) & 1)

    def presence_record(self) -> dict:
        """redis_demod_publisher.py:42-81 record shape."""
        return {
            "instance_uuid": self.instance_uuid,
            "system_uuid": self.cfg.system_uuid,
            "system_id_local": self.cfg.id,
            "transmit_site_uuid": self.cfg.transmit_site_uuid,
            "site_uuid": self.site_uuid,
            "type": self.cfg.type,
            "system_modulation": self.cfg.modulation,
            "site_detail": getattr(self.engine, "site_detail", {}),
            "quality": list(self.engine.quality),
            "control_channel": self.control_channel,
            "is_locked": self.engine.is_locked,
            "time": time.time(),
        }


class SiteRuntime:
    # AFC cadence/dead-band: the reference's demod_watcher polls the
    # frequency probe every 0.5 s (p25_control_demod.py:564-581) and the
    # frontend ignores corrections under 5 Hz (receiver.py:460).
    AFC_INTERVAL_S = 1.0
    AFC_DEADBAND_HZ = 5.0

    def __init__(self, cfg: RcConfig, iq_providers: dict, device,
                 bus=None, store=None, keep_wav: bool = False,
                 now_fn=None):
        """iq_providers: {source_idx: callable(n) -> complex64[n] or
        float32[n, 2]} — file readers, synthetic generators, or SDR
        ingest shims.

        device: where the pipelines run (``device.require_cuda()`` on the
        card; ``"cpu"`` runs the kernels' plain versions).

        now_fn: clock for call hang-time/timeout state machines. Default
        wall clock (live capture); offline/file decode should pass
        :meth:`stream_clock` so call lifecycle follows *stream* time and
        results are machine-load independent (the reference is always
        wall-clock because it is always real-time)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.now = now_fn or time.time
        self._deterministic = False
        self.bus = bus or (
            make_bus(cfg.redis_servers, getattr(cfg, "activemq", None))
            if (cfg.redis_servers or getattr(cfg, "activemq", None))
            else InProcBus())
        self.store = store or PresenceStore()
        self.providers = iq_providers
        if cfg.receiver_split2:
            self._apply_split2()
        self.scheduler = ChannelScheduler(
            {i: (s.center_freq, s.samp_rate)
             for i, s in cfg.sources.items()},
            num_slots=cfg.num_slots_per_source,
            now_fn=lambda: self.now())
        # Pipelines are GROUPED: all sources sharing a sample rate that
        # need the same symbol class step through ONE pipeline call with
        # a leading source axis, so each tracker kernel launch covers
        # every source's lanes. Groups: {gkey: {"pipe", "srcs", "cls",
        # "rate"}}; gkey = (rate, cls) for the eager classes, (rate,
        # cls, src) for lazily provisioned singletons (a TDMA voice
        # class runs only on the source whose call needs it).
        self.groups: dict[tuple, dict] = {}
        self.pipe_state: dict[tuple, object] = {}
        self._gmap: dict[tuple, tuple] = {}    # (src, cls) -> (gkey, row)
        self._by_src: dict[int, list] = {}     # src -> [(cls, gkey, row)]
        self.instances: list[ControlInstance] = []
        for sys_cfg in cfg.systems.values():
            inst = ControlInstance(sys_cfg, self.scheduler, self.bus,
                                   cfg.site_uuid)
            self.instances.append(inst)
        needed = {(_i.source_idx, _i.cls) for _i in self.instances
                  if _i.source_idx is not None}
        # Voice channels can land on any source; provision the classes
        # the configured systems imply up front (the rest — TDMA 6000 Bd
        # variants, provoice — are provisioned lazily by the recorder
        # manager's require_stream callback on the first such grant).
        has_cqpsk = any(s.type == "p25" and s.modulation.upper() == "CQPSK"
                        for s in cfg.systems.values())
        for src_idx in cfg.sources:
            needed.add((src_idx, _CLS_ANALOG))   # voice
            needed.add((src_idx, _CLS_C4FM))     # digital voice dibits
            if has_cqpsk:
                needed.add((src_idx, _CLS_CQPSK))
        if getattr(cfg, "group_sources", True):
            by_cls: dict[tuple, list] = {}
            for src_idx, cls in sorted(needed, key=str):
                rate = int(cfg.sources[src_idx].samp_rate)
                by_cls.setdefault((rate, cls), []).append(src_idx)
            for (rate, cls), srcs in sorted(by_cls.items(), key=str):
                self._make_group((rate, cls), cls, sorted(set(srcs)))
        else:
            # per-source singleton groups: the pre-grouping cost model,
            # for CPU-only multi-source offline decode (rxconfig knob)
            for src_idx, cls in sorted(needed, key=str):
                rate = int(cfg.sources[src_idx].samp_rate)
                self._make_group((rate, cls, src_idx), cls, [src_idx])
        self._stage: dict[tuple, np.ndarray] = {}   # _stack's buffers
        self._pending_pipelines: set[tuple] = set()
        self._pipe_lock = threading.Lock()

        # The reference always voice-decodes P25 recordings to PCM
        # (logging_receiver.py:253 repeater.vocoder); install the in-repo
        # native IMBE vocoder once, best-effort (no g++ → .imbe sidecars,
        # the recorder's documented fallback).
        from radiocapture_tpu_torch.audio.recorder import get_default_vocoder
        if get_default_vocoder() is None:
            try:
                from radiocapture_tpu_torch.audio import imbe as _imbe
                _imbe.install_default()
            except Exception as e:      # pragma: no cover - toolchain
                log.warning("native IMBE vocoder unavailable (%s); "
                            "voice saved as .imbe sidecars", e)
        self.recorders = RecorderManager(self.bus, self.scheduler,
                                         audio_dir=cfg.audio_dir,
                                         keep_wav=keep_wav,
                                         require_stream=self._require_stream,
                                         now_fn=lambda: self.now())
        self.metadata = MetadataAgent(self.bus, self.get_instance)
        # Talkgroup filters: reference-style cfg.blacklists (keyed by
        # system id) merged with per-system blacklist/whitelist fields.
        blacklists = {k: set(v) for k, v in (cfg.blacklists or {}).items()}
        whitelists = {}
        for s in cfg.systems.values():
            if s.blacklist:
                blacklists.setdefault(s.system_uuid, set()).update(
                    s.blacklist)
            if s.id in blacklists:
                blacklists.setdefault(s.system_uuid, set()).update(
                    blacklists[s.id])
            if s.whitelist is not None:
                whitelists[s.system_uuid] = set(s.whitelist)
        self.call_managers = {}
        types = {s.type for s in cfg.systems.values()}
        for t, klass in (("p25", P25CallManager), ("moto", MotoCallManager),
                         ("edacs", EdacsCallManager)):
            if t in types:
                self.call_managers[t] = klass(self.bus, self.get_instance,
                                              now_fn=lambda: self.now(),
                                              blacklists=blacklists,
                                              whitelists=whitelists)
        for inst in self.instances:
            t = inst.cfg.type
            if t in self.call_managers:
                self.call_managers[t].notify_demod_new(t,
                                                       inst.instance_uuid)
            self.recorders.notify_demod_new(t, inst.instance_uuid)
            self.metadata.notify_demod_new(t, inst.instance_uuid)
        self.blocks = 0
        self._last_quality = time.time()
        self._last_afc = self.now()

    def _apply_split2(self) -> None:
        """``receiver_split2``: rewrite every physical source into two
        half-rate logical sources at center ∓ fs/4, fed through one
        :class:`SpectrumSplit2` step per physical source on the runtime's
        device (reference rc_frontend/receiver.py:205-237)."""
        from dataclasses import replace as _replace
        from radiocapture_tpu_torch.frontend.pipeline import SpectrumSplit2
        new_sources, new_providers = {}, {}
        for phys_idx, src in sorted(self.cfg.sources.items(), key=str):
            splitter = _Split2Provider(self.providers[phys_idx],
                                       SpectrumSplit2(src.samp_rate),
                                       self.device)
            for half in (0, 1):
                idx = len(new_sources)
                new_sources[idx] = _replace(
                    src,
                    center_freq=splitter.split.half_center(
                        src.center_freq, half),
                    samp_rate=src.samp_rate / 2.0,
                    frequency=None)
                new_providers[idx] = splitter.half(half)
        self.cfg.sources = new_sources
        self.providers = new_providers

    def use_stream_clock(self) -> None:
        """Switch call-lifecycle time to a block-count-driven clock for
        offline decode: time advances ``block_seconds`` per processed
        block, so hang-time/call-timeout behavior is identical however
        fast (or slow) the host chews the file. Live capture keeps the
        wall clock (the reference is always real-time)."""
        t0 = time.time()
        self.now = lambda: t0 + self.blocks * self.cfg.block_seconds
        self._deterministic = True

    # ---- presence-backed instance lookup (redis_demod_manager role) ----
    def get_instance(self, instance_uuid: str) -> dict | None:
        for inst in self.instances:
            if inst.instance_uuid == instance_uuid:
                return inst.presence_record()
        return None

    def _build_pipeline(self, samp_rate: float, cls: str):
        n = self.cfg.num_slots_per_source
        fe = self.cfg.frontend_mode
        if cls == _CLS_C4FM:
            return ControlPipeline.p25_c4fm(n, samp_rate, frontend=fe)
        if cls == _CLS_C4FM_TDMA:
            # Phase 2 H-CPM voice on a C4FM system: same discriminator
            # chain at 6000 Bd (logging_receiver.py:226-228).
            return ControlPipeline(n, samp_rate, 12500.0, 6000.0,
                                   (-3.0, -1.0, 1.0, 3.0), 600.0,
                                   frontend=fe)
        if cls == _CLS_EDACS:
            return ControlPipeline.edacs(n, samp_rate, frontend=fe)
        if cls == _CLS_MOTO:
            return ControlPipeline.moto(n, samp_rate, frontend=fe)
        if cls == _CLS_CQPSK:
            return CqpskControlPipeline.p25_cqpsk(n, samp_rate,
                                                  frontend=fe)
        if cls == _CLS_CQPSK_TDMA:
            return CqpskControlPipeline.p25_cqpsk(n, samp_rate,
                                                  tdma=True, frontend=fe)
        return AnalogVoicePipeline(n, samp_rate, frontend=fe)

    def _make_group(self, gkey: tuple, cls: str, srcs: list) -> None:
        pipe = self._build_pipeline(float(gkey[0]), cls)
        self.groups[gkey] = {"pipe": pipe, "srcs": list(srcs),
                             "cls": cls, "rate": gkey[0]}
        self.pipe_state[gkey] = pipe.init(len(srcs), self.device)
        for row, s in enumerate(srcs):
            self._gmap[(s, cls)] = (gkey, row)
            self._by_src.setdefault(s, []).append((cls, gkey, row))

    def _group_step(self, gkey: tuple, x: torch.Tensor,
                    offs: torch.Tensor, present: np.ndarray):
        """One pipeline step of a group. Sources with no data this block
        keep their previous state rows exactly. On CUDA the trackers
        write lane state in place, so those rows are copied out BEFORE
        the step and written back after it; a block where every source
        delivered copies nothing."""
        state = self.pipe_state[gkey]
        absent = np.flatnonzero(~present)
        if len(absent):
            idx = torch.as_tensor(absent, device=self.device)
            kept = _tree_map(lambda t: t.index_select(0, idx), state)
        state, out = self.groups[gkey]["pipe"].step(state, x, offs)
        if len(absent):
            state = _tree_map(lambda t, k: t.index_copy(0, idx, k),
                              state, kept)
        self.pipe_state[gkey] = state
        return out

    def _require_stream(self, src_idx: int, cls: str) -> None:
        """RecorderManager callback (possibly from a bus worker thread):
        provision a voice dibit pipeline before the next step."""
        if (src_idx, cls) in self._gmap:
            return
        with self._pipe_lock:
            self._pending_pipelines.add((src_idx, cls))

    def _provision_pending(self) -> None:
        with self._pipe_lock:
            pending, self._pending_pipelines = self._pending_pipelines, set()
        for src_idx, cls in sorted(pending, key=str):
            if (src_idx, cls) not in self._gmap:
                log.info("provisioning %s pipeline on source %s", cls,
                         src_idx)
                rate = int(self.cfg.sources[src_idx].samp_rate)
                # lazy classes run as singletons: only the source whose
                # call needs the class pays for it
                self._make_group((rate, cls, src_idx), cls, [src_idx])

    def has_pipeline(self, src_idx: int, cls: str) -> bool:
        return (src_idx, cls) in self._gmap

    def _stack(self, key: tuple, xs: list) -> np.ndarray:
        """The blocks ``xs`` stacked in ``key``'s dtype into a host buffer
        kept from block to block: a fresh 100 MB-scale array per block
        would pay its page faults every time. The upload copies it before
        the next block refills it. A uint16 group (bf16 bit patterns from
        the ingest ring) stays uint16; in a float32 group such a block
        is converted exactly (:func:`_as_dtype`)."""
        shape = (len(xs),) + xs[0].shape
        buf = self._stage.get(key)
        if buf is None or buf.shape != shape:
            buf = self._stage[key] = np.empty(shape, key[1])
        return np.stack([_as_dtype(a, key[1]) for a in xs], out=buf)

    @staticmethod
    def _fetch(cls: str, out: tuple) -> tuple:
        """A group's outputs on the host, in one device→host copy: (None,
        valid, dibits) of a digital class, as uint8 (values 0..3, a
        quarter of the int32 bytes), or (audio, power) of the analog
        class."""
        if cls in _DIGITAL_CLASSES:
            vd = torch.stack((out[1], out[2])).to(torch.uint8).cpu().numpy()
            return None, vd[0], vd[1]
        ap = torch.cat((out[0], out[1][..., None]), -1).cpu().numpy()
        return ap[..., :-1], ap[..., -1]

    def _offsets(self, gkey: tuple) -> torch.Tensor:
        """The group's [S, C] slot offsets on the device, copied there
        only when the scheduler changed them (a host → device copy
        synchronizes the stream)."""
        g = self.groups[gkey]
        offs = np.stack([self.scheduler.offsets_norm(s) for s in g["srcs"]])
        if "offs" not in g or not np.array_equal(offs, g["offs"][0]):
            g["offs"] = (offs, torch.as_tensor(offs, device=self.device))
        return g["offs"][1]

    def block_len(self, src_idx: int) -> int:
        src = self.cfg.sources[src_idx]
        m = max(getattr(g["pipe"], "block_multiple", g["pipe"].decim)
                for _cls, gk, _row in self._by_src.get(src_idx, [])
                for g in (self.groups[gk],))
        n = int(src.samp_rate * self.cfg.block_seconds)
        return max(m, (n // m) * m)

    # ---- main loop ----
    def step(self) -> None:
        """Process one block from every source: one pipeline step per
        group (all same-rate sources batched), then per-source
        consumption."""
        self._provision_pending()
        blocks: dict[int, np.ndarray | None] = {}
        for src_idx in self.cfg.sources:
            x = self.providers[src_idx](self.block_len(src_idx))
            if x is not None and np.iscomplexobj(x):
                x = np.stack([x.real, x.imag], -1).astype(np.float32)
            blocks[src_idx] = x
        group_out: dict[tuple, tuple] = {}
        # groups over the same sources (each source's c4fm and analog
        # group) share one stacked upload per block
        uploads: dict[tuple, torch.Tensor] = {}
        for gkey, g in self.groups.items():
            srcs = g["srcs"]
            present = np.array([blocks[s] is not None for s in srcs])
            if not present.any():
                continue
            xs = [blocks[s] for s in srcs]
            zero = np.zeros_like(np.asarray(xs[int(np.argmax(present))]))
            xs = [np.asarray(x) if x is not None else zero for x in xs]
            # Lock the group's input dtype at first use (mixed wire dtypes
            # stack as float32): a dtype that varied with which sources
            # delivered (e.g. the lone f32 source underruns in an
            # otherwise-bf16 group) would change the group's input type
            # mid-capture.
            dtypes = {a.dtype for a in xs}
            want = g.setdefault("in_dtype", dtypes.pop() if len(dtypes) == 1
                                else np.dtype(np.float32))
            key = (tuple(srcs), want)
            if key not in uploads:
                uploads[key] = wire_from_numpy(self._stack(key, xs),
                                               self.device)
            group_out[gkey] = self._group_step(gkey, uploads[key],
                                               self._offsets(gkey), present)
        # One device→host copy per CONSUMED group output (each per-row
        # or per-slot read would pay its own device sync): digital
        # groups with a control instance or digital recorder fetch
        # (valid, dibits) whole; analog groups fetch (audio, power) only
        # while an analog recorder is open. syms is never fetched.
        inst_groups = set()
        for i in self.instances:
            if i.source_idx is not None and i.slot is not None:
                ent = self._gmap.get((i.source_idx, i.cls))
                if ent is not None:
                    inst_groups.add(ent[0])
        rec_streams = self.recorders.active_streams()
        fetched: dict[tuple, tuple] = {}
        for gkey, out in group_out.items():
            g = self.groups[gkey]
            cls, srcs = g["cls"], g["srcs"]
            if cls in _DIGITAL_CLASSES:
                if gkey in inst_groups or any(
                        (s, cls) in rec_streams for s in srcs):
                    fetched[gkey] = self._fetch(cls, out)
            else:
                if any((s, "analog") in rec_streams for s in srcs):
                    fetched[gkey] = self._fetch(cls, out)
        for src_idx in self.cfg.sources:
            if blocks[src_idx] is None:
                continue
            # only fetched (consumed) groups fan out per source: row-
            # slicing an unfetched device tensor would launch a device op
            # per source per output for data nobody reads
            outputs: dict[str, tuple] = {}
            for cls, gkey, row in self._by_src.get(src_idx, []):
                out = fetched.get(gkey)
                if out is not None:
                    outputs[cls] = tuple(
                        o[row] if o is not None else None for o in out)
            # control instances: each consumed stream is on the host
            # already (fetched once per group above)
            cc_insts = [i for i in self.instances
                        if i.source_idx == src_idx and i.slot is not None
                        and i.cls in outputs]
            cc_np = {cls: (np.asarray(outputs[cls][1]),
                           np.asarray(outputs[cls][2]))
                     for cls in {i.cls for i in cc_insts}}
            for inst in cc_insts:
                valid, dibits = cc_np[inst.cls]
                v = valid[inst.slot].astype(bool)
                inst.feed(dibits[inst.slot][v])
            if self._deterministic and hasattr(self.bus, "flush"):
                # Offline decode: drain grant -> call manager -> new_call
                # -> recorder-open before this block's voice feed, so
                # recordings don't depend on worker-thread scheduling.
                self.bus.flush()
            # voice recorders: every digital class feeds its own dibit
            # stream (a CQPSK/TDMA call must not see C4FM decisions —
            # MOD_TO_STREAM in control/recorder_manager.py).
            audio, power = outputs.get(_CLS_ANALOG, (None, None))
            streams = {cls: (out[2], out[1])
                       for cls, out in outputs.items()
                       if cls in _DIGITAL_CLASSES}
            self.recorders.feed_source_block(
                src_idx, audio=audio, power=power, dibit_streams=streams)
        self.recorders.heartbeat_clients()
        for inst in self.instances:
            self.scheduler.heartbeat(inst.client)
        for cm in self.call_managers.values():
            cm.sweep()
        self.scheduler.reap()
        if self._deterministic and hasattr(self.bus, "flush"):
            self.bus.flush()
        self.blocks += 1
        if self.now() - self._last_afc >= self.AFC_INTERVAL_S:
            self._afc_sweep()
            self._last_afc = self.now()
        now = time.time()
        if now - self._last_quality >= 10.0:     # quality window
            dt = now - self._last_quality
            for inst in self.instances:
                sd = getattr(inst.engine, "site_detail", {}) or {}
                sid = (f"{sd.get('System ID')}-{sd.get('WACN ID')} "
                       f"{sd.get('RF Sub-system ID')}-{sd.get('Site ID')}")
                inst.engine.record_quality(
                    dt, inst.engine.DESIRED_RATE,
                    control_channel=inst.control_channel, site_id=sid)
            self._last_quality = now
        self.publish_presence()

    def _afc_sweep(self) -> None:
        """Close the reference's AFC loop: demod_watcher probe →
        connector.report_offset → receiver.source_offset
        (p25_control_demod.py:564-581, rc_frontend/receiver.py:436-475).

        Each locked P25 C4FM control instance's fsk4 ``fine_freq`` carry
        *is* the measured residual DC; convert to Hz, dead-band ±5 Hz,
        and fold the negated measurement into the source's AFC offset
        (the scheduler applies the reference's sanity clamp). The next
        block's ``offsets_norm`` then mixes the whole source by the
        correction, so every fsk4 carry on that source is compensated by
        the applied delta to avoid a transient double-correction. One
        correction per source per sweep — co-sited instances measure
        the same LO error, exactly as the reference's multiple demods
        all report into one frontend accumulator."""
        done_sources: set[int] = set()
        for inst in self.instances:
            if (inst.cls != _CLS_C4FM or inst.source_idx is None
                    or inst.slot is None or not inst.engine.is_locked
                    or inst.source_idx in done_sources):
                continue
            ent = self._gmap.get((inst.source_idx, _CLS_C4FM))
            if ent is None:
                continue
            gkey, row = ent
            pipe = self.groups[gkey]["pipe"]
            measured = float(pipe.fine_freq_hz(
                self.pipe_state[gkey])[row, inst.slot])
            if abs(measured) < self.AFC_DEADBAND_HZ:
                continue
            done_sources.add(inst.source_idx)
            pool = self.scheduler.sources[inst.source_idx]
            before = pool.afc_offset
            after = self.scheduler.report_offset(inst.source_idx,
                                                 -measured)
            delta = after - before
            if delta == 0.0:
                continue
            log.info("AFC: source %s measured %+.1f Hz -> afc %+.1f Hz",
                     inst.source_idx, measured, after)
            for cls, gk, r in self._by_src.get(inst.source_idx, []):
                p = self.groups[gk]["pipe"]
                if hasattr(p, "apply_freq_shift"):
                    # per-source delta on the stacked state: only this
                    # source's row shifts
                    dv = np.zeros((len(self.groups[gk]["srcs"]), 1),
                                  np.float32)
                    dv[r, 0] = delta
                    self.pipe_state[gk] = p.apply_freq_shift(
                        self.pipe_state[gk], dv)

    def publish_presence(self) -> None:
        for inst in self.instances:
            self.store.publish(f"demod:{inst.cfg.type}",
                               inst.instance_uuid, inst.presence_record())

    def run(self, n_blocks: int | None = None,
            duration_s: float | None = None) -> None:
        t0 = time.time()
        while True:
            if n_blocks is not None and self.blocks >= n_blocks:
                return
            if duration_s is not None and time.time() - t0 > duration_s:
                return
            self.step()

    def close(self) -> None:
        self.recorders.close_all()
        if isinstance(self.bus, InProcBus):
            # give worker threads a beat to flush call_complete events
            time.sleep(0.1)
        self.bus.close()


class _Split2Provider:
    """Adapts one physical block provider into two logical half-rate
    providers sharing a streaming :class:`SpectrumSplit2` state on
    ``device``. Each physical block is split once; halves come back to
    the host and queue until their logical source pulls them."""

    def __init__(self, provider, splitter, device):
        self.provider = provider
        self.split = splitter
        self.device = device
        self.state = splitter.init(1, device)
        self._queues: tuple[list, list] = ([], [])

    def _pump(self, n: int) -> bool:
        x = self.provider(2 * n)
        if x is None:
            return False
        if np.iscomplexobj(x):
            x = np.stack([x.real, x.imag], -1).astype(np.float32)
        self.state, halves = self.split.step(
            self.state, wire_from_numpy(x[None], self.device))
        halves = halves[0].cpu().numpy()             # [2, n, 2] f32
        self._queues[0].append(halves[0])
        self._queues[1].append(halves[1])
        return True

    def half(self, idx: int):
        def pull(n: int):
            if not self._queues[idx] and not self._pump(n):
                return None
            return self._queues[idx].pop(0)
        return pull


class FileSource:
    """Block provider over a complex64 capture file (loops when
    exhausted unless ``loop=False``)."""

    def __init__(self, path_or_array, loop: bool = True):
        self.data = (np.fromfile(path_or_array, np.complex64)
                     if isinstance(path_or_array, str) else
                     np.asarray(path_or_array, np.complex64))
        self.pos = 0
        self.loop = loop

    def __call__(self, n: int):
        if self.pos + n > len(self.data):
            if not self.loop:
                return None
            self.pos = 0
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out if len(out) == n else None


class PacedProvider:
    """A live source's block provider, paced to the stream: each call
    waits until the source's ingest ring holds the block, then pops it.

    A step on the card takes a few ms against a block of 50-100 ms, so an
    unpaced loop would find the ring short on most calls and the
    non-strict provider would zero-fill them, splicing zero blocks between
    real ones (ROADMAP C.4; the JAX runtime keeps that behaviour).

    A block is due one block's duration (``n / source.samp_rate``) after
    the previous one was in the ring, and the wait ends half a block past
    that. A loop faster than the stream waits about a block for every
    block, so a bound of one block from the call would leave no room for
    the sender's jitter; half a block of grace leaves room, and a
    dropout's last zero-filled block still comes before the stream's next
    real one. A block still short then is a true dropout, and the
    provider zero-fills it as before; each further missing block is
    zero-filled one block after the one before, so the site keeps the
    stream's cadence. A real block counts as in the ring when the wrapper
    saw it there: at the end of its wait, or at the call if it was there
    already. That is never before it came, so neither a sender slower
    than its nominal rate nor one that sends in bursts gets a block
    zero-filled while it is coming; a zero-filled block stands for the
    block due then. A loop slower than the stream finds its blocks
    waiting and never waits.

    Counters, read by the live benchmarks: ``blocks`` pulled,
    ``zero_filled`` of them, ``wait_s`` and ``pop_s`` in all (the wait and
    the provider's own call), and ``last_wait_s``."""

    POLL_S = 0.0005

    def __init__(self, source, provider):
        self.source = source
        self.provider = provider
        self.blocks = 0
        self.zero_filled = 0
        self.wait_s = 0.0
        self.pop_s = 0.0
        self.last_wait_s = 0.0
        self._due: float | None = None

    def __call__(self, n: int):
        ring = self.source.ring
        block = n / self.source.samp_rate
        t0 = time.perf_counter()
        due = t0 + block if self._due is None else self._due
        while ring.available < n:
            left = due + 0.5 * block - time.perf_counter()
            if left <= 0.0:
                break
            time.sleep(min(self.POLL_S, left))
        t1 = time.perf_counter()
        short = ring.available < n
        x = self.provider(n)
        self.pop_s += time.perf_counter() - t1
        self._due = (due if short else t1) + block
        self.last_wait_s = t1 - t0
        self.wait_s += self.last_wait_s
        self.blocks += 1
        self.zero_filled += short
        return x


def providers_from_config(cfg: RcConfig) -> tuple[dict, list]:
    """Block providers for every configured source.

    ``file`` sources replay captures; ``rtlsdr`` sources stream live
    dongles over the rtl_tcp wire protocol into the native ingest ring
    (frontend/rtl_tcp.py — the reference's osmosdr ``rtl=N`` path,
    rc_frontend/receiver.py:170-204); ``usrp``, ``usrp2x`` and ``bladerf``
    sources stream cs16/cf32 from a driver host over rciq
    (frontend/rciq.py). Each live provider is non-strict (it zero-fills
    a dropout) and paced to its stream (:class:`PacedProvider`). Returns
    (providers, live sources); callers own stopping the live sources."""
    providers: dict = {}
    live: list = []
    for idx, src in cfg.sources.items():
        if src.type == "file":
            providers[idx] = FileSource(src.args)
            continue
        if src.type == "rtlsdr":
            from radiocapture_tpu_torch.frontend.rtl_tcp import \
                source_for_config
        elif src.type in ("usrp", "usrp2x", "bladerf"):
            # ≥12-bit radios live on a driver host running UHD/SoapySDR
            # (tools/driver_host_sender.py) and stream over rciq; a 2-ch
            # usrp2x is two SourceConfigs on two sender ports.
            from radiocapture_tpu_torch.frontend.rciq import \
                source_for_config
        else:
            raise ValueError(
                f"source {idx}: no ingest path for type {src.type!r} "
                "(file, rtlsdr, usrp, usrp2x, bladerf are wired; other "
                "hardware needs a driver host feeding UdpFeed or "
                "IngestRing directly)")
        s = source_for_config(src, idx)
        live.append(s)
        # "auto" gates the bf16 wire on the ring's sample format, so the
        # half-bandwidth pop applies only where it is lossless (rtl_tcp's
        # cu8; the >=12-bit rciq formats stay float32 on the same knob)
        providers[idx] = PacedProvider(s, s.provider(
            bf16="auto" if cfg.ingest_bf16 else False))
    return providers, live


def _as_dtype(a: np.ndarray, dtype) -> np.ndarray:
    """``a`` in ``dtype``; uint16 bf16 bit patterns go to float32 exactly
    (a bf16 is the high half of its float32), never as integers."""
    if a.dtype == np.uint16 and dtype != np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(dtype, copy=False)


def main(argv=None):
    import argparse
    from radiocapture_tpu_torch.device import require_cuda
    from radiocapture_tpu_torch.rxconfig import load_config
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--log-dir", default=None,
                    help="rotating overseer/protocol logs (logconfig); "
                         "default: console basicConfig")
    args = ap.parse_args(argv)
    device = require_cuda()
    if args.log_dir:
        from radiocapture_tpu_torch.utils.logconfig import setup_logging
        setup_logging(args.log_dir)
    else:
        logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config)
    providers, live = providers_from_config(cfg)
    rt = SiteRuntime(cfg, providers, device)
    if not live:
        rt.use_stream_clock()   # offline decode: load-independent timing
    try:
        rt.run(n_blocks=args.blocks, duration_s=args.duration)
    finally:
        rt.close()
        for s in live:
            s.stop()


if __name__ == "__main__":
    main()
