"""Control-plane soak: hundreds of concurrent call lifecycles.

BASELINE.md's north-star scale targets (≥256 simultaneous voice
channels across ≥2 hosts) exercise the part of the system the
throughput bench and the multichip dryrun both skip: the *control
plane* under concurrency — grant fan-out, call-manager state machines,
slot allocation/reuse, recorder lifecycle, hang-time sweeps, and
post-processing, the roles the reference spreads across overseer
children and per-instance recorder processes (overseer.py:76-110,
call_recorder_manager.py:30-49).

The soak builds N full :class:`SiteRuntime` instances (default 2) on
one shared mini-Redis broker — the production multi-host topology —
each with its own sources, slot pools, pipelines, call managers, and
recorder manager, stepping in its own thread on the stream clock (so
results are machine-speed independent). Synthetic P25 systems fan
grants through the real bus topics the demod engines publish on
(`/topic/raw_control/<instance>`), ramping until the concurrency
target is reached, holding with continuation refreshes, going silent
so hang-time closes everything, then re-opening a second wave into the
still-idle slots to exercise the warm-reuse path
(rc_frontend/receiver.py:51,307-341 idle-channel economics).

Measured per run: peak concurrent open calls, grant→first-voice-block
latency (p50/p95, split warm vs cold alloc), call-manager sweep
latency over the full table, calls opened/closed per stream second,
denied grants, and the drain invariants (no leaked slots, no stuck
calls, recorder backlog empty).

CLI: ``python -m radiocapture_tpu_torch.tools.soak [--target 256]`` prints a
JSON artifact (see tests/test_soak.py for the scaled-down assertions).
The runtimes run on ``device``: the first CUDA device by default (the CLI);
``device="cpu"`` runs the kernels' plain versions (what the tests pass).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

CHANNEL_HZ = 12500.0


class _SoakSite:
    """One SiteRuntime + its synthetic grant traffic."""

    def __init__(self, rt_idx: int, n_sources: int, samp_rate: float,
                 num_slots: int, n_systems: int, servers: list,
                 audio_dir: str, block_seconds: float = 0.1, device=None):
        from radiocapture_tpu_torch.control.bus import RedisBus
        from radiocapture_tpu_torch.device import resolve as resolve_device
        from radiocapture_tpu_torch.runtime import SiteRuntime
        from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                               SystemConfig)
        self.idx = rt_idx
        self.base_hz = 860.0e6 + rt_idx * 100.0e6
        self.n_channels = int(n_sources * samp_rate / CHANNEL_HZ)
        cfg = RcConfig()
        cfg.audio_dir = audio_dir
        cfg.num_slots_per_source = num_slots
        cfg.block_seconds = block_seconds
        for s in range(n_sources):
            cfg.sources[s] = SourceConfig(
                type="file",
                center_freq=self.base_hz + (s + 0.5) * samp_rate,
                samp_rate=samp_rate)
        # control channels live at the top of the band, voice below
        self.n_voice_channels = self.n_channels - 2 * n_systems
        for k in range(n_systems):
            cc = self.channel_freq(self.n_voice_channels + 2 * k)
            cfg.systems[k] = SystemConfig(
                type="p25", id=f"Soak{rt_idx}.{k}",
                control_channels=[cc])
        def provider(n: int):
            return np.zeros((n, 2), np.float32)

        self.bus = RedisBus(servers)
        self.rt = SiteRuntime(cfg, {s: provider
                                    for s in range(n_sources)},
                              resolve_device(device), bus=self.bus)
        self.rt.use_stream_clock()
        self.n_systems = n_systems

    def channel_freq(self, n: int) -> float:
        return self.base_hz + (n + 0.5) * CHANNEL_HZ

    def publish_iden(self) -> None:
        """Seed each instance's channel-identifier table the way the
        engine would (IDEN_UP event, scaled units — engines.py:162)."""
        for inst in self.rt.instances:
            self.bus.send_event_lazy(
                f"/topic/raw_control/{inst.instance_uuid}",
                {"name": "IDEN_UP", "crc": 0, "Identifier": 1,
                 "BW": 12.5,
                 "Base Frequency": (self.base_hz + 0.5 * CHANNEL_HZ)
                 / 1e6,
                 "Channel Spacing": CHANNEL_HZ / 1e3,
                 "Transmit Offset": 0})

    def grant(self, sys_idx: int, chan: int, group: int) -> None:
        inst = self.rt.instances[sys_idx]
        self.bus.send_event_lazy(
            f"/topic/raw_control/{inst.instance_uuid}",
            {"name": "GRP_V_CH_GRANT", "crc": 0,
             "Channel": 0x1000 | chan, "Group Address": group,
             "Source Address": 50000 + group})

    def open_calls(self) -> int:
        return len(self.rt.recorders.active)

    def close(self) -> None:
        self.rt.close()


def voice_capacity(n_sources: int, samp_rate: float,
                   n_systems: int) -> int:
    """Voice channels one runtime can carry (total channels minus the
    control channels) — the single sizing rule shared by the harness
    and the CLI auto-sizer."""
    return int(n_sources * samp_rate / CHANNEL_HZ) - 2 * n_systems


def run_soak(target_concurrency: int = 256, n_runtimes: int = 2,
             n_sources: int | None = None, samp_rate: float = 1.0e6,
             n_systems: int = 2, audio_dir: str = "soak_audio",
             hold_blocks: int = 20, verbose: bool = False, device=None) -> dict:
    """Run the soak; returns the metrics/invariants dict.
    ``n_sources=None`` auto-sizes per-runtime sources to the target."""
    from radiocapture_tpu_torch.control.resp import MiniRedisServer
    from radiocapture_tpu_torch.device import resolve as resolve_device
    device = resolve_device(device)   # no CUDA device: fail before a server

    per_rt_target = -(-target_concurrency // n_runtimes)  # ceil
    if n_sources is None:
        n_sources = 1
        while voice_capacity(n_sources, samp_rate,
                             n_systems) < per_rt_target:
            n_sources += 1

    srv = MiniRedisServer()
    servers = [{"host": srv.host, "port": srv.port}]
    block_s = 0.1
    num_slots = max(8, -(-int(samp_rate / CHANNEL_HZ) // 1))
    sites = [
        _SoakSite(r, n_sources, samp_rate, num_slots, n_systems,
                  servers, f"{audio_dir}/rt{r}", block_s, device)
        for r in range(n_runtimes)]
    for site in sites:
        if site.n_voice_channels < per_rt_target:
            raise ValueError(
                f"capacity {site.n_voice_channels} < target "
                f"{per_rt_target}")

    hang_blocks = int(5.0 / block_s) + 12   # P25 hang time + margin
    ramp_rate = max(1, per_rt_target // (n_systems * 12))
    phases = [("ramp", 14 + per_rt_target // (n_systems * ramp_rate)),
              ("hold", hold_blocks),
              ("silence", hang_blocks),
              ("wave2", 14 + per_rt_target // (2 * n_systems * ramp_rate)),
              ("hold2", 8),
              ("drain", hang_blocks)]

    opened = [0] * len(sites)
    sweep_ms: list[float] = []
    concurrency: list[int] = []
    peak_during_wave2 = [0] * len(sites)
    lock = threading.Lock()
    barrier = threading.Barrier(len(sites) + 1)
    stop = threading.Event()

    def site_loop(site: _SoakSite) -> None:
        try:
            _site_loop(site)
        except BaseException:
            barrier.abort()     # unblock the sampler, fail the soak
            raise

    def _site_loop(site: _SoakSite) -> None:
        desired: dict[tuple, int] = {}   # (sys, chan) -> group
        chan_cursor = 0
        site.publish_iden()
        for phase, n_blocks in phases:
            for b in range(n_blocks):
                if stop.is_set():
                    return
                if phase in ("ramp", "wave2"):
                    want = per_rt_target if phase == "ramp" \
                        else per_rt_target // 2
                    for k in range(site.n_systems):
                        for _ in range(ramp_rate):
                            if len(desired) >= want:
                                break
                            chan = chan_cursor % site.n_voice_channels
                            chan_cursor += 1
                            key = (k, chan)
                            if key in desired:
                                continue
                            desired[key] = 1000 * (k + 1) + chan
                            site.grant(k, chan, desired[key])
                if phase in ("ramp", "hold", "wave2", "hold2"):
                    # continuation refresh well inside the 5 s hang time
                    if b % 15 == 14:
                        for (k, chan), g in desired.items():
                            site.grant(k, chan, g)
                else:
                    desired.clear()
                site.rt.step()
                if phase in ("wave2", "hold2"):
                    peak_during_wave2[site.idx] = max(
                        peak_during_wave2[site.idx], site.open_calls())
                t0 = time.perf_counter()
                for cm in site.rt.call_managers.values():
                    cm.sweep()
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    sweep_ms.append(dt)
                barrier.wait()

    threads = [threading.Thread(target=site_loop, args=(s,),
                                name=f"soak-rt{s.idx}", daemon=True)
               for s in sites]
    t_wall0 = time.time()
    for t in threads:
        t.start()
    total_blocks = sum(n for _, n in phases)
    peak = 0
    try:
        for blk in range(total_blocks):
            barrier.wait()        # all sites finished block blk
            c = sum(s.open_calls() for s in sites)
            concurrency.append(c)
            peak = max(peak, c)
            if verbose and blk % 10 == 0:
                print(f"  block {blk}: {c} open calls", flush=True)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    wall_s = time.time() - t_wall0

    # ---- gather
    lat_all, lat_warm, lat_cold = [], [], []
    denied = 0
    stuck_calls = leaked = backlog = 0
    for s in sites:
        for lat, warm in s.rt.recorders.open_latencies:
            lat_all.append(lat)
            (lat_warm if warm else lat_cold).append(lat)
        opened[s.idx] = len(s.rt.recorders.open_latencies)
        denied += s.rt.recorders.grants_denied
        backlog += len(s.rt.recorders.active)
        for cm in s.rt.call_managers.values():
            for im in cm.instance_metadata.values():
                stuck_calls += len(im["call_table"])
        st = s.rt.scheduler.stats()
        # only the control instances may still hold ACTIVE slots
        leaked += st["active"] - len(s.rt.instances)
    stream_s = total_blocks * block_s

    def pct(v, q):
        if not v:
            return None
        vs = sorted(v)
        return round(vs[min(len(vs) - 1, int(len(vs) * q))], 4)

    result = {
        "target_concurrency": target_concurrency,
        "peak_concurrency": peak,
        "runtimes": n_runtimes,
        "calls_opened": int(sum(opened)),
        "calls_per_stream_s": round(sum(opened) / stream_s, 1),
        "stream_seconds": stream_s,
        "wall_seconds": round(wall_s, 1),
        "open_latency_p50_s": pct(lat_all, 0.5),
        "open_latency_p95_s": pct(lat_all, 0.95),
        "warm_opens": len(lat_warm),
        "cold_opens": len(lat_cold),
        "warm_latency_p95_s": pct(lat_warm, 0.95),
        "cold_latency_p95_s": pct(lat_cold, 0.95),
        "wave2_peak": int(sum(peak_during_wave2)),
        "sweep_ms_p50": pct(sweep_ms, 0.5),
        "sweep_ms_p95": pct(sweep_ms, 0.95),
        "grants_denied": denied,
        "stuck_calls_after_drain": stuck_calls,
        "leaked_slots_after_drain": leaked,
        "recorder_backlog_after_drain": backlog,
    }
    for s in sites:
        s.close()
    srv.close()
    return result


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--target", type=int, default=256)
    ap.add_argument("--runtimes", type=int, default=2)
    ap.add_argument("--audio-dir", default="/tmp/rc_soak_audio")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    res = run_soak(target_concurrency=args.target,
                   n_runtimes=args.runtimes,
                   audio_dir=args.audio_dir, verbose=args.verbose)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
