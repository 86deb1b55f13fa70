"""Port parity, the site runtime: the port's ``SiteRuntime`` on the CPU
against the JAX ``SiteRuntime`` on the same config and capture (stream
clock), field by field — grant → recorded call for P25 C4FM, an EDACS
analog call (the path through the voice tracker and the resampler), CQPSK
voice routing — and, on the port alone, the mask-revert of absent
sources, the AFC loop and ``receiver_split2`` routing. The captures are
built with the JAX package's modulators, as ``tests/test_runtime.py``
builds them."""

import glob
import os
import threading

import numpy as np
import pytest
import torch

from radiocapture_tpu import rxconfig as JRX
from radiocapture_tpu import runtime as JRT
from radiocapture_tpu.audio import imbe as I
from radiocapture_tpu.audio.wav import read_wav
from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.protocol import edacs as E
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.testing import modulators as M
from radiocapture_tpu_torch import rxconfig as TRX
from radiocapture_tpu_torch import runtime as TRT
from test_runtime import CC, CENTER, SAMP, VC, _wideband_capture

torch.set_num_threads(1)   # six test workers share the machine

ECC, EVC = 857.8e6, 856.6e6     # EDACS control and voice channels
TONE_HZ = 1000.0
# The EDACS fixture's voice carrier keys up this long after the control
# channel starts granting it. The recorder's slot starts from whatever the
# slot carried before the grant: a free slot sits at the scheduler's
# initial 0 Hz, ~357 cycles/sample off centre, where float32 sin/cos of
# the ~3e6 rad tap angles differ between XLA and PyTorch (ROADMAP.md
# queue C). Squelched blocks before key-up let that state decay, so the
# WAVs compare sample for sample.
KEYUP_S = 0.2
PCM_LSB, PCM_SHARE = 2, 0.999
# A ceiling on the wait for the call_complete event, which returns as soon
# as it is delivered; only a lost event waits this long.
COMPLETE_TIMEOUT_S = 120.0
RUNTIMES = {"jax": (JRT, JRX), "torch": (TRT, TRX)}


def _config(rx, audio_dir, slots=16):
    cfg = rx.RcConfig()
    cfg.audio_dir = str(audio_dir)
    cfg.num_slots_per_source = slots
    cfg.block_seconds = 0.05
    cfg.sources[0] = rx.SourceConfig(type="file", center_freq=CENTER,
                                     samp_rate=SAMP)
    return cfg


def _runtime(which, cfg, providers, **kw):
    rt_mod = RUNTIMES[which][0]
    if which == "torch":
        kw["device"] = "cpu"
    rt = rt_mod.SiteRuntime(cfg, providers, **kw)
    rt.use_stream_clock()
    return rt


def _record(which, tmp_path, capture, add_system, n_blocks, slots=16):
    """Run one runtime over ``capture`` (file source, no looping) for up
    to ``n_blocks``; returns (runtime, [open recorder entries] before the
    close, [call_complete events], [wav paths])."""
    rx = RUNTIMES[which][1]
    cfg = _config(rx, tmp_path / which / "audio", slots)
    add_system(cfg, rx)
    rt = _runtime(which, cfg, {0: RUNTIMES[which][0].FileSource(
        capture, loop=False)}, keep_wav=True)
    completed = []
    delivered = threading.Event()

    def on_complete(event):
        completed.append(event)
        delivered.set()
    rt.bus.subscribe("/queue/call_management/call_complete", on_complete)
    try:
        rt.run(n_blocks=min(n_blocks, int(len(capture) // rt.block_len(0))))
        active = list(rt.recorders.active.values())
        # Close the calls while the bus still runs and wait for the event
        # itself: ``close`` stops the bus a beat after closing the calls,
        # and on a loaded machine its threads may not have delivered by
        # then.
        rt.recorders.close_all()
        delivered.wait(COMPLETE_TIMEOUT_S)
    finally:
        rt.close()
    wavs = glob.glob(os.path.join(cfg.audio_dir, "**", "*.wav"),
                     recursive=True)
    return rt, active, completed, wavs


def _p25(modulation):
    def add(cfg, rx):
        cfg.systems[0] = rx.SystemConfig(type="p25", id="TestSys",
                                         modulation=modulation,
                                         control_channels=[CC])
    return add


def _both(tmp_path, capture, add_system, n_blocks, slots=16):
    return {w: _record(w, tmp_path, capture, add_system, n_blocks, slots)
            for w in RUNTIMES}


def test_p25_grant_recording_matches_jax(tmp_path):
    """P25 C4FM grant → recording (the ``tests/test_runtime.py``
    capture): the instance locks, one ``c4fm`` recorder opens, the CDR
    carries group 500 / user 42, and the recorder captured the same IMBE
    codewords as the JAX runtime's."""
    runs = _both(tmp_path, _wideband_capture(), _p25("C4FM"), 40)
    frames = {}
    for which, (rt, active, completed, wavs) in runs.items():
        assert rt.instances[0].engine.is_locked, which
        (rec, _src, _slot, _bid, kind), = active
        assert kind == "c4fm"
        cdr = completed[0]["cdr"]
        assert (cdr["system_group_local"], cdr["system_user_local"]) == \
            (500, 42)
        assert wavs
        frames[which] = np.array(rec._imbe_frames)
    assert len(frames["torch"]) >= 9
    np.testing.assert_array_equal(frames["torch"], frames["jax"])


def _edacs_capture(n_frames=60):
    """A 9600 Bd EDACS control channel repeating an analog call
    assignment (LCN 3, group 321), and the granted channel carrying a
    1 kHz FM tone from KEYUP_S on."""
    msgs = [E.build_frame(*E.make_call_assignment(lcn=3, group=321,
                                                  logical_id=4567))
            for _ in range(n_frames)]
    bits = np.concatenate([np.tile(np.array([0, 1], np.uint8), 40)] + msgs)
    cc = M.upsample_to(M.fsk2_modulate(bits, 25000.0, baud=9600.0,
                                       dev_hz=3000.0), 25000.0, SAMP)
    t = np.arange(len(cc) // 96 + 1) / 25000.0
    audio = np.where(t >= KEYUP_S, 0.8 * np.sin(2 * np.pi * TONE_HZ * t),
                     0.0).astype(np.float32)
    vc = M.upsample_to(M.fm_modulate(audio, 25000.0, 2500.0)
                       * (t >= KEYUP_S), 25000.0, SAMP)
    return M.multi_channel(SAMP, [(ECC - CENTER, cc), (EVC - CENTER, vc)],
                           len(cc), noise_floor_db=-60.0)


def _edacs(cfg, rx):
    cfg.systems[0] = rx.SystemConfig(type="edacs", id="E",
                                     channels={1: ECC, 3: EVC},
                                     control_channels=[ECC])


def _peak_hz(pcm, rate):
    seg = pcm[len(pcm) // 4:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return np.argmax(spec) * rate / len(seg)


def test_edacs_analog_call_matches_jax(tmp_path):
    """An EDACS analog call, the only runtime path through the voice
    tracker and the resampler: both runtimes emit ``call_complete`` with
    ``analog_edacs`` and write 8 kHz WAVs of the same length whose int16
    PCM agrees within PCM_LSB on PCM_SHARE of the samples; the spectral
    peak is at 1 kHz ± 20 Hz."""
    runs = _both(tmp_path, _edacs_capture(), _edacs, 40, slots=8)
    pcm = {}
    for which, (rt, active, completed, wavs) in runs.items():
        (rec, _src, _slot, _bid, kind), = active
        assert kind == "analog"
        assert completed[0]["cdr"]["modulation_type"] == "analog_edacs"
        assert completed[0]["cdr"]["system_group_local"] == 321
        (path,) = wavs
        audio, rate = read_wav(path)
        assert rate == 8000 and len(audio) > 8000
        assert abs(_peak_hz(audio, rate) - TONE_HZ) <= 20.0
        pcm[which] = np.round(audio * 32767.0).astype(np.int32)
    assert len(pcm["torch"]) == len(pcm["jax"])
    agree = np.mean(np.abs(pcm["torch"] - pcm["jax"]) <= PCM_LSB)
    assert agree >= PCM_SHARE, agree


def _cqpsk_capture():
    """``tests/test_runtime.py::test_runtime_cqpsk_voice_routing``'s
    capture: a CQPSK control channel granting channel 0x1000 (group 600,
    user 43) and that channel's CQPSK LDU1 voice stream."""
    I.install_default()
    iden = P.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100,
        "Base Frequency": int(VC / 5), "Channel Spacing": 50,
        "Transmit Offset": 0x1B4})
    grant = P.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1000, "Group Address": 600, "Source Address": 43})
    frames = [P.build_tsdu_frame(0x293, [iden]),
              P.build_tsdu_frame(0x293, [grant])] * 8
    cc_up = M.upsample_to(M.cqpsk_modulate(
        B.bits_to_dibits(np.concatenate(frames)), fs=25000.0), 25000.0, SAMP)
    vc_cw = I.ImbeEncoder().encode_params(b0=90, voicing=0xFFF, gain=42,
                                          amps=[3] * 56)
    lc = P.make_link_control(0x0, tgid=600, source_id=43)
    ldus = [P.build_ldu1_frame(0x293, lc, np.stack([vc_cw] * 9))
            for _ in range(12)]
    vc_iq = M.upsample_to(M.cqpsk_modulate(
        B.bits_to_dibits(np.concatenate(ldus)), fs=25000.0), 25000.0, SAMP)
    return M.multi_channel(SAMP, [(CC - CENTER, cc_up), (VC - CENTER, vc_iq)],
                           len(cc_up), noise_floor_db=-60.0)


def test_cqpsk_voice_routing_matches_jax(tmp_path):
    """A CQPSK system routes voice through the CQPSK pipeline: one
    ``cqpsk`` recorder with ``p25_cqpsk``, and the same IMBE codewords as
    the JAX runtime's."""
    runs = _both(tmp_path, _cqpsk_capture(), _p25("CQPSK"), 40)
    frames = {}
    for which, (rt, active, completed, _wavs) in runs.items():
        assert rt.has_pipeline(0, "cqpsk")
        assert rt.instances[0].engine.is_locked
        (rec, _src, _slot, _bid, kind), = active
        assert kind == "cqpsk"
        assert rec.cdr["modulation_type"] == "p25_cqpsk"
        assert completed[0]["cdr"]["system_group_local"] == 600
        frames[which] = np.array(rec._imbe_frames)
    assert len(frames["torch"]) >= 9
    np.testing.assert_array_equal(frames["torch"], frames["jax"])


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state.clone()]
    return [leaf for part in state for leaf in _leaves(part)]


def test_grouped_step_freezes_state_of_absent_sources(tmp_path):
    """``tests/test_runtime.py``'s mask-revert test on the port: two
    same-rate sources share each group; a block where source 1 delivers
    nothing leaves its state rows of every group exactly as they were
    while source 0's advance, and source 1 resumes after."""
    cfg = _config(TRX, tmp_path / "audio", slots=8)
    cfg.sources[1] = TRX.SourceConfig(type="file", center_freq=CENTER + SAMP,
                                      samp_rate=SAMP)
    cfg.systems[0] = TRX.SystemConfig(type="p25", id="G",
                                      control_channels=[CC])
    rng = np.random.default_rng(3)
    starve = {"on": False}

    def p0(n):
        return rng.standard_normal(n).astype(np.float32).view() \
            .astype(np.complex64)

    def p1(n):
        return None if starve["on"] else p0(n)

    rt = _runtime("torch", cfg, {0: p0, 1: p1})
    try:
        assert {k[1] for k in rt.groups} == {"c4fm", "analog"}
        rows = {}
        for gkey in rt.groups:
            g0, r0 = rt._gmap[(0, gkey[1])]
            g1, r1 = rt._gmap[(1, gkey[1])]
            assert g0 == g1 == gkey and {r0, r1} == {0, 1}
            rows[gkey] = (r0, r1)
        rt.step()
        rt.step()
        before = {g: _leaves(st) for g, st in rt.pipe_state.items()}
        starve["on"] = True
        rt.step()
        after = {g: _leaves(st) for g, st in rt.pipe_state.items()}
        for gkey, (r0, r1) in rows.items():
            pairs = list(zip(before[gkey], after[gkey]))
            assert all(torch.equal(a[r1], b[r1]) for a, b in pairs), gkey
            assert not all(torch.equal(a[r0], b[r0]) for a, b in pairs)
        starve["on"] = False
        rt.step()
        for gkey, (r0, r1) in rows.items():
            assert not all(torch.equal(a[r1], b[r1]) for a, b in zip(
                after[gkey], _leaves(rt.pipe_state[gkey])))
    finally:
        rt.close()


def test_afc_converges(tmp_path):
    """``tests/test_runtime.py``'s AFC test on the port: a 400 Hz LO
    error; the locked C4FM instance's fine-frequency carry drives the
    source's AFC offset to within 60 Hz of it, and the residual carry
    back under 60 Hz."""
    lo_err = 400.0
    iden = P.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100,
        "Base Frequency": int(VC / 5), "Channel Spacing": 50,
        "Transmit Offset": 0x1B4})
    cc_up = M.upsample_to(M.c4fm_modulate(B.bits_to_dibits(np.concatenate(
        [P.build_tsdu_frame(0x293, [iden])] * 24)), fs=25000.0), 25000.0,
        SAMP)
    capture = M.multi_channel(SAMP, [(CC - CENTER - lo_err, cc_up)],
                              len(cc_up), noise_floor_db=-60.0)
    cfg = _config(TRX, tmp_path / "audio")
    _p25("C4FM")(cfg, TRX)
    rt = _runtime("torch", cfg, {0: TRT.FileSource(capture)})
    rt.AFC_INTERVAL_S = 0.25
    try:
        rt.run(n_blocks=40)
        inst = rt.instances[0]
        assert inst.engine.is_locked
        afc = rt.scheduler.sources[0].afc_offset
        assert abs(afc - lo_err) < 60.0, afc
        gkey, row = rt._gmap[(0, "c4fm")]
        resid = rt.groups[gkey]["pipe"].fine_freq_hz(rt.pipe_state[gkey])
        assert abs(float(resid[row, inst.slot])) < 60.0
    finally:
        rt.close()


def test_split2_routes_halves_as_jax(tmp_path):
    """``receiver_split2``: the port rewrites the physical source into
    the same two half-rate logical sources as the JAX runtime, and each
    logical provider yields the same half, block after block (the split2
    bank's f32 tolerance, 2e-3); the port's runtime then steps them."""
    rng = np.random.default_rng(8)
    capture = (rng.standard_normal(4 * 120000)
               + 1j * rng.standard_normal(4 * 120000)).astype(np.complex64)
    rts = {}
    for which, (rt_mod, rx) in RUNTIMES.items():
        cfg = _config(rx, tmp_path / which / "audio", slots=4)
        cfg.receiver_split2 = True
        _p25("C4FM")(cfg, rx)
        rts[which] = _runtime(which, cfg, {0: rt_mod.FileSource(capture)})
    try:
        got, want = rts["torch"], rts["jax"]
        assert [(s.center_freq, s.samp_rate)
                for s in got.cfg.sources.values()] == \
            [(s.center_freq, s.samp_rate) for s in want.cfg.sources.values()]
        n = got.block_len(0)
        assert n == want.block_len(0)
        for _ in range(2):
            for idx in (0, 1):
                np.testing.assert_allclose(got.providers[idx](n),
                                           want.providers[idx](n), atol=2e-3)
        got.run(n_blocks=2)
        assert got.blocks == 2
    finally:
        for rt in rts.values():
            rt.close()


def test_entry_points_refuse_what_is_not_ported(tmp_path, monkeypatch):
    """Live SDR sources raise ``NotImplementedError`` naming the ROADMAP
    item; ``main`` needs a CUDA device and fails without one."""
    cfg = _config(TRX, tmp_path / "audio")
    for kind in ("rtlsdr", "usrp", "usrp2x", "bladerf"):
        cfg.sources[0].type = kind
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TRT.providers_from_config(cfg)
    cfg.sources[0].type = "file"
    cfg.sources[0].args = str(tmp_path / "capture.dat")
    np.zeros(4, np.complex64).tofile(cfg.sources[0].args)
    providers, live = TRT.providers_from_config(cfg)
    assert isinstance(providers[0], TRT.FileSource) and live == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRT.main(["-c", "configs/config_example_file.py", "--blocks", "1"])
