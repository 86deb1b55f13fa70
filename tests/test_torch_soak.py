"""Port parity, the control-plane soak: the port's copies of the
scheduler's warm/cold allocation, its injected clock and the recorder
manager's grant → voice-open latency, checked as ``tests/test_soak.py``
checks the JAX package's; then the port's ``run_soak`` on the CPU beside
the JAX one at the same scaled-down parameters, on the stream clock: the
same calls opened and closed, the same concurrency and latencies, every
drain invariant at zero. (The full-size run, two runtimes at 256
concurrent calls, is ``python -m radiocapture_tpu_torch.tools.soak`` on
the card.)"""

import numpy as np
import pytest
import torch

from radiocapture_tpu.tools import soak as JS
from radiocapture_tpu_torch.control.bus import InProcBus
from radiocapture_tpu_torch.control.recorder_manager import RecorderManager
from radiocapture_tpu_torch.frontend.scheduler import ChannelScheduler
from radiocapture_tpu_torch.tools import soak as TS

torch.set_num_threads(1)   # six test workers share the machine


@pytest.fixture(autouse=True)
def _isolate_port_vocoder(monkeypatch):
    """A port ``SiteRuntime`` installs the port recorder's process-global
    default vocoder, which carries decoder state: put back whatever was
    there after each test, as ``tests/conftest.py`` does for the JAX
    package's."""
    from radiocapture_tpu_torch.audio import recorder
    monkeypatch.setattr(recorder, "_default_vocoder",
                        recorder.get_default_vocoder())


# One runtime of one 100 kS/s source (8 channels: two control, four
# voice), ramping to 4 concurrent calls. The plain fsk tracker is a
# per-sample loop on the CPU, so every block costs ~0.3 s here however
# narrow the source; the soak's fixed phases (hang time, drain) take ~160
# blocks.
SOAK = dict(target_concurrency=4, n_runtimes=1, n_sources=1,
            samp_rate=100e3, n_systems=2, hold_blocks=2)
# keys measured on the host's clock, not the stream's
WALL_KEYS = ("wall_seconds", "sweep_ms_p50", "sweep_ms_p95")
DRAIN_KEYS = ("grants_denied", "stuck_calls_after_drain",
              "leaked_slots_after_drain", "recorder_backlog_after_drain")


@pytest.fixture
def fenced_jax_soak(monkeypatch):
    """Give the JAX soak the port's grant fence (``GrantFence``) before it
    publishes the channel identifiers and before each block's step, as
    the port's soak has it: JAX's ``_SoakSite`` takes its grants on the
    bus's listener thread too, so a loaded host lands one a block late
    there as well, or drops the identifiers before the subscriptions
    are live. The test patches the site; the JAX package is unchanged."""
    init = JS._SoakSite.__init__

    def fenced_init(site, *args, **kwargs):
        init(site, *args, **kwargs)
        fence = TS.GrantFence(site.bus, site.rt)
        publish_iden, step = site.publish_iden, site.rt.step

        def publish_iden_after_fence():
            fence.wait()
            publish_iden()

        def step_after_fence():
            fence.wait()
            step()

        site.publish_iden = publish_iden_after_fence
        site.rt.step = step_after_fence

    monkeypatch.setattr(JS._SoakSite, "__init__", fenced_init)


def test_create_channel_ex_reports_warm_reuse():
    sched = ChannelScheduler({0: (857e6, 2.4e6)}, num_slots=4)
    a = sched.create_channel_ex("c1", 25e3, 856.9e6)
    assert a is not None and a[3] is False        # cold: FREE slot
    src, slot, bid, _ = a
    sched.release_channel("c1", bid)
    b = sched.create_channel_ex("c2", 25e3, 857.1e6)
    assert b[3] is True and b[1] == slot          # warm: IDLE retune
    sched.reap(now=sched.now() + ChannelScheduler.IDLE_REUSE_S + 1)
    c = sched.create_channel_ex("c3", 25e3, 857.2e6)
    assert c[3] is False


def test_scheduler_follows_injected_clock():
    t = [1000.0]
    sched = ChannelScheduler({0: (857e6, 2.4e6)}, num_slots=2,
                             now_fn=lambda: t[0])
    _, _, bid, _ = sched.create_channel_ex("c1", 25e3, 857e6)
    sched.release_channel("c1", bid)
    t[0] += ChannelScheduler.IDLE_REUSE_S - 1
    sched.reap()
    assert sched.create_channel_ex("c2", 25e3, 857e6)[3] is True
    sched.connect("c9")
    t[0] += ChannelScheduler.CLIENT_TTL_S + 1
    sched.reap()
    assert not sched.heartbeat("c9")


def test_recorder_manager_measures_open_latency(tmp_path):
    t = [100.0]
    bus = InProcBus(num_workers=1)
    sched = ChannelScheduler({0: (857e6, 2.4e6)}, num_slots=4,
                             now_fn=lambda: t[0])
    rm = RecorderManager(bus, sched, audio_dir=str(tmp_path),
                         now_fn=lambda: t[0])
    cdr = {"call_uuid": "u1", "instance_uuid": "inst00001",
           "system_group_local": 7, "system_user_local": 1,
           "system_channel_local": 3, "type": "group",
           "frequency": 857.05e6, "channel_bandwidth": 12500.0,
           "modulation_type": "analog", "slot": 0, "hang_time": 5.0,
           "time_open": 100.0, "time_activity": 100.0,
           "system_id": "sys"}
    try:
        rm.process_new_call(cdr)
        assert len(rm.active) == 1
        t[0] += 0.3                   # three blocks later voice arrives
        audio = np.zeros((4, 2500), np.float32)
        power = np.full(4, 1.0, np.float32)
        rm.feed_source_block(0, audio=audio, power=power)
        assert rm.open_latencies[0][0] == pytest.approx(0.3)
        assert rm.open_latencies[0][1] is False       # cold alloc
        rm.feed_source_block(0, audio=audio, power=power)
        assert len(rm.open_latencies) == 1
    finally:
        rm.close_all()
        bus.close()


def test_run_soak_as_jax(tmp_path, fenced_jax_soak):
    """The port's soak on the CPU and the JAX soak at the same parameters
    open and close the same calls (every call opened is closed after the
    drain), reach the same peak and second-wave concurrency with the same
    stream-clock latencies, and end with every drain invariant at zero.
    Both fence each block's grants before its step (``GrantFence``)."""
    got = TS.run_soak(audio_dir=str(tmp_path / "torch"), device="cpu",
                      **SOAK)
    want = JS.run_soak(audio_dir=str(tmp_path / "jax"), **SOAK)
    assert got["peak_concurrency"] >= SOAK["target_concurrency"]
    assert got["calls_opened"] >= 1.5 * SOAK["target_concurrency"]
    assert all(got[k] == 0 for k in DRAIN_KEYS), got
    assert {k: v for k, v in got.items() if k not in WALL_KEYS} == \
        {k: v for k, v in want.items() if k not in WALL_KEYS}


def test_run_soak_needs_a_card_by_default(monkeypatch, tmp_path):
    """``device=None`` is the first CUDA device: without one the soak
    refuses to start rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.run_soak(audio_dir=str(tmp_path), **SOAK)
