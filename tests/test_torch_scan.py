"""Port parity, the scan slice: the streaming ``fir_filter``,
``design_channel_taps``, ``nbfm_demod``, ``SpectrumScanner`` with
``find_channels``, the batched P25 trial lock, the conventional scanner's
events and the scan CLI's fft mode, each run on the same seeded numpy
inputs through the JAX package (on the CPU) and the port
(``device="cpu"``); plus ``convert`` round trips of the scan and NBFM
states, and the entry points' refusal to run without a card when no
device is given. The fixtures are ``tests/test_scan.py``'s."""

import os
import subprocess
import sys
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops import fir as JF
from radiocapture_tpu.ops import fm as JFM
from radiocapture_tpu.ops import taps as JT
from radiocapture_tpu.scan import (ScanChannel as JScanChannel,
                                   ScanningReceiver as JScanningReceiver,
                                   SpectrumScanner as JSpectrumScanner)
from radiocapture_tpu.scan import band_scan_candidates as j_candidates
from radiocapture_tpu.scan import find_channels as j_find_channels
from radiocapture_tpu.scan import trial_p25_lock as j_trial
from radiocapture_tpu.scan.__main__ import main as j_scan_main
from radiocapture_tpu.testing import modulators as M
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.ops import fir as TF
from radiocapture_tpu_torch.ops import fm as TFM
from radiocapture_tpu_torch.scan import (ScanChannel, ScanningReceiver,
                                         SpectrumScanner,
                                         band_scan_candidates,
                                         find_channels, trial_p25_lock)
from radiocapture_tpu_torch.scan.__main__ import main as t_scan_main
from radiocapture_tpu_torch.testing import streams
from test_scan import CENTER, SAMP_RATE, _p25_cc_iq

torch.set_num_threads(1)   # six test workers share the machine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fir_filter and nbfm_demod: float32 sums in another order (conv1d
# against XLA's convolution), × max|y|.
FIR_REL = 1e-5
# The de-emphasis IIR in another association order (test_torch_voice.py).
NBFM_REL = 1e-5


def assert_spectrum_close(got, want):
    """Per bin within ``streams.spectrum_tolerance`` (SPEC_ATOL plus
    SPEC_ULPS float32 ulps of the peak's amplitude at the bin's depth)."""
    err = np.abs(got - want)
    tol = streams.spectrum_tolerance(want)
    assert np.all(err <= tol), (float(err.max()),
                                float(tol[np.argmax(err - tol)]))


def _stream(fn, state, blocks):
    outs = []
    for b in blocks:
        state, y = fn(state, b)
        outs.append(np.asarray(y))
    return state, np.concatenate(outs)


@pytest.mark.parametrize("kind", ["real", "complex-real", "complex"])
def test_fir_filter_matches_jax(kind):
    """A stream in four blocks through JAX's ``fir_filter`` and the
    port's, decimating by 2: within FIR_REL·max|y|; the port streamed
    equals the port in one block (block-split equivalence) within the
    same tolerance, and its carried history equals JAX's exactly."""
    rng = np.random.default_rng(3)
    taps = JT.low_pass(1.0, 48000.0, 4000.0, 1000.0)
    x = rng.standard_normal(4000).astype(np.float32)
    if kind != "real":
        x = (x + 1j * rng.standard_normal(4000)).astype(np.complex64)
    if kind == "complex":
        taps = (taps * np.exp(0.3j * np.arange(len(taps)))).astype(
            np.complex64)
    dtype = torch.float32 if kind == "real" else torch.complex64
    blocks = np.split(x, 4)
    js, want = _stream(
        lambda s, b: JF.fir_filter(s, jnp.asarray(b), jnp.asarray(taps), 2),
        JF.fir_init(taps, jnp.float32 if kind == "real" else jnp.complex64),
        blocks)
    ts, got = _stream(
        lambda s, b: TF.fir_filter(s, torch.from_numpy(b), taps, 2),
        TF.fir_init(taps, dtype, "cpu"), blocks)
    tol = FIR_REL * np.abs(want).max()
    assert got.shape == want.shape == (2000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
    _, whole = TF.fir_filter(TF.fir_init(taps, dtype, "cpu"),
                             torch.from_numpy(x), taps, 2)
    np.testing.assert_allclose(got, whole.numpy(), rtol=0, atol=tol)


def test_design_channel_taps_identical():
    for args in [(2.4e6, 12500.0), (2.4e6, 25000.0, 0.25), (48e3, 8e3)]:
        np.testing.assert_array_equal(TF.design_channel_taps(*args),
                                      JF.design_channel_taps(*args))


def test_nbfm_demod_matches_jax():
    """An FM tone at 48 kS/s in three blocks through ``nbfm_demod`` (audio
    taps decimating by 2): audio within NBFM_REL·max|audio|, every state
    leaf within NBFM_REL."""
    fs = 48000.0
    audio_in = 0.6 * np.sin(2 * np.pi * 700.0 * np.arange(6000) / fs)
    x = M.awgn(M.fm_modulate(audio_in, fs, 5000.0), 25.0,
               np.random.default_rng(4)).astype(np.complex64)
    taps = JT.low_pass(1.0, fs, 3500.0, 1000.0)
    blocks = np.split(x, 3)
    js, want = _stream(
        lambda s, b: JFM.nbfm_demod(s, jnp.asarray(b), fs, 5000.0,
                                    jnp.asarray(taps), 2),
        JFM.nbfm_init(taps), blocks)
    ts, got = _stream(
        lambda s, b: TFM.nbfm_demod(s, torch.from_numpy(b), fs, 5000.0,
                                    taps, 2),
        TFM.nbfm_init(taps, "cpu"), blocks)
    assert got.shape == want.shape == (3000,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=NBFM_REL * np.abs(want).max())
    for a, w in zip(convert.native_state_to_jax(ts.deemph), js.deemph):
        np.testing.assert_allclose(a, np.asarray(w), rtol=NBFM_REL,
                                   atol=NBFM_REL)
    np.testing.assert_allclose(ts.audio_fir.history.numpy(),
                               np.asarray(js.audio_fir.history),
                               rtol=NBFM_REL, atol=NBFM_REL)


def _two_carriers():
    """``test_scan.py::test_spectrum_peaks``'s capture: FSK carriers at
    −400 kHz and +250 kHz in a 2.4 MS/s block of 16 frames."""
    return streams.two_carriers(SAMP_RATE)


def test_fixtures_are_the_jax_tests():
    """The port's JAX-free scan fixtures (used on the card) are
    ``test_scan.py``'s captures, sample for sample."""
    rng = np.random.default_rng(7)
    tone_a = M.fsk2_modulate(rng.integers(0, 2, 4000), SAMP_RATE,
                             9600.0, 4000.0)
    tone_b = M.fsk2_modulate(rng.integers(0, 2, 4000), SAMP_RATE,
                             3600.0, 4000.0)
    want = M.multi_channel(SAMP_RATE, [(-400e3, tone_a), (250e3, tone_b)],
                           16384 * 16, noise_floor_db=-55.0, rng=rng)
    np.testing.assert_array_equal(_two_carriers(), want)
    cc = 857.5e6
    iq = _p25_cc_iq(cc_freq=cc)
    np.testing.assert_array_equal(
        streams.site_capture(cc, CENTER),
        M.multi_channel(SAMP_RATE, [(cc - CENTER, iq)], len(iq),
                        noise_floor_db=-55.0))


def test_spectrum_and_peaks_match_jax():
    """The two-carrier capture in two steps of 8 frames: ``spectrum_db``
    within ``assert_spectrum_close`` of JAX's, and ``find_channels`` gives the same peaks
    (frequency, bin, width, prominence, power) on both spectra."""
    wide = _two_carriers()
    halves = np.split(np.stack([wide.real, wide.imag], -1), 2)
    jsc, tsc = JSpectrumScanner(16384), SpectrumScanner(16384)
    np.testing.assert_array_equal(tsc.window, jsc.window)
    jst, tst = jsc.init(), tsc.init("cpu")
    for h in halves:
        jst, tst = jsc.step(jst, h), tsc.step(tst, h)
    want, got = jsc.spectrum_db(jst), tsc.spectrum_db(tst)
    assert got.shape == (16384,) and float(tst.count) == 16.0
    assert_spectrum_close(got, want)
    jpk = j_find_channels(want, SAMP_RATE, CENTER)
    tpk = find_channels(got, SAMP_RATE, CENTER)
    assert [p.frequency for p in jpk] == [p.frequency for p in tpk]
    assert [p.bin for p in jpk] == [p.bin for p in tpk]
    assert any(abs(p.frequency - (CENTER - 400e3)) < 6e3 for p in tpk)
    assert any(abs(p.frequency - (CENTER + 250e3)) < 6e3 for p in tpk)
    for a, b in zip(tpk, jpk):
        np.testing.assert_allclose(
            [a.width_hz, a.prominence, a.power_db],
            [b.width_hz, b.prominence, b.power_db], rtol=1e-3)
    # the same spectrum → exactly the JAX package's peaks
    assert [astuple(p) for p in find_channels(want, SAMP_RATE, CENTER)] \
        == [astuple(p) for p in jpk]


def test_spectrum_state_round_trip():
    """A scan started in JAX and finished in the port gives the JAX
    spectrum; the port's state goes back to JAX's NamedTuple."""
    wide = _two_carriers()
    halves = np.split(np.stack([wide.real, wide.imag], -1), 2)
    jsc, tsc = JSpectrumScanner(16384), SpectrumScanner(16384)
    jst = jsc.step(jsc.init(), halves[0])
    half = jax_np(jst)          # the JAX step donates its state
    mid = convert.spectrum_state_from_jax(tsc, half, "cpu")
    got = tsc.spectrum_db(tsc.step(mid, halves[1]))
    want = jsc.spectrum_db(jsc.step(jst, halves[1]))
    assert_spectrum_close(got, want)
    back = type(jst)(*convert.native_state_to_jax(mid))
    np.testing.assert_array_equal(back.acc, half.acc)
    assert back.count == 8.0 and back.count.dtype == np.float32
    with pytest.raises(ValueError, match="does not match"):
        convert.spectrum_state_from_jax(SpectrumScanner(4096), half, "cpu")


def jax_np(state):
    """A JAX NamedTuple state with numpy leaves."""
    if hasattr(state, "_fields"):
        return type(state)(*(jax_np(leaf) for leaf in state))
    return np.asarray(state)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_fir_and_nbfm_state_round_trips(kind):
    """``FirState`` and ``NbfmState`` from JAX (numpy) to the port and
    back leave every leaf and dtype as it was; a stream continued in the
    port from JAX's state matches JAX's."""
    rng = np.random.default_rng(9)
    taps = JT.low_pass(1.0, 48000.0, 4000.0, 1000.0)
    dt = np.float32 if kind == "real" else np.complex64
    x = rng.standard_normal(2000).astype(np.float32)
    if kind == "complex":
        x = (x + 1j * rng.standard_normal(2000)).astype(dt)
    js, _ = JF.fir_filter(JF.fir_init(taps, jnp.dtype(dt)),
                          jnp.asarray(x[:1000]), jnp.asarray(taps))
    ts = convert.fir_state_from_jax(taps, jax_np(js), "cpu")
    assert ts.history.dtype == (torch.float32 if kind == "real"
                                else torch.complex64)
    back = type(js)(*convert.native_state_to_jax(ts))
    np.testing.assert_array_equal(back.history, np.asarray(js.history))
    assert back.history.dtype == dt
    _, want = JF.fir_filter(js, jnp.asarray(x[1000:]), jnp.asarray(taps))
    _, got = TF.fir_filter(ts, torch.from_numpy(x[1000:]), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FIR_REL * np.abs(want).max())
    if kind == "real":
        return
    fs = 48000.0
    jn, _ = JFM.nbfm_demod(JFM.nbfm_init(taps), jnp.asarray(x[:1000]), fs,
                           5000.0, jnp.asarray(taps))
    tn = convert.nbfm_state_from_jax(taps, jax_np(jn), "cpu")
    back = convert.native_state_to_jax(tn)
    for a, w in zip(jax_np(back), jax_np(jn)):
        for la, lw in zip(a, w):
            np.testing.assert_array_equal(la, lw)
            assert la.dtype == lw.dtype
    _, want = JFM.nbfm_demod(jn, jnp.asarray(x[1000:]), fs, 5000.0,
                             jnp.asarray(taps))
    _, got = TFM.nbfm_demod(tn, torch.from_numpy(x[1000:]), fs, 5000.0,
                            taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NBFM_REL * np.abs(want).max())


def _result_fields(r):
    return (r.frequency, r.locked, r.site_detail, r.offset_hz, r.quality,
            r.bad_messages, r.total_messages)


def test_trial_p25_lock_matches_jax():
    """``test_scan.py``'s discovery fixture (the control channel 200 Hz
    off the true one, two empty candidates): the port's trial bank at
    C = 3 gives the same results as JAX's, field for field — the same
    locked set, site detail, offsets and message counts."""
    cc = 857.5e6
    iq = _p25_cc_iq(cc_freq=cc)
    wide = M.multi_channel(SAMP_RATE, [(cc - CENTER, iq)], len(iq),
                           noise_floor_db=-55.0)
    cands = [cc + 200.0, CENTER - 300e3, CENTER + 600e3]
    want = j_trial(wide, SAMP_RATE, CENTER, cands)
    got = trial_p25_lock(wide, SAMP_RATE, CENTER, cands, device="cpu")
    assert [_result_fields(r) for r in got] == \
        [_result_fields(r) for r in want]
    hit = got[0]
    assert hit.locked and hit.site_detail["Site ID"] == 7
    assert hit.site_detail["Control Channel"] == int(cc)
    assert abs(hit.offset_hz - 200.0) < 1.0
    assert not got[1].locked and not got[2].locked
    assert [r.summary_line(i) for i, r in enumerate(got)] == \
        [r.summary_line(i) for i, r in enumerate(want)]


def test_band_scan_candidates_identical():
    for args in [([(851.0e6, 851.1e6)], 25e3, (0.0, 2500.0)),
                 ([(856e6, 858e6), (850e6, 850.05e6)], 12.5e3, (0.0,))]:
        assert band_scan_candidates(*args) == j_candidates(*args)


def test_scanning_receiver_events_match_jax():
    """Two channels (a carrier and an empty one) through the squelch
    cycle: the port's scanner emits the same new_call / activity /
    timeout events, in the same order, with the same CDRs."""
    freqs = [CENTER + 100e3, CENTER - 500e3]
    want, _ = streams.squelch_cycle(JScanningReceiver, JScanChannel, freqs,
                                    CENTER)
    got, opened = streams.squelch_cycle(ScanningReceiver, ScanChannel,
                                        freqs, CENTER, device="cpu")
    assert got == want
    kinds = [k for k, _ in got]
    assert kinds[0] == "new" and kinds[-1] == "to" and "act" in kinds
    assert opened[0]["system_group_local"] == CENTER + 100e3


def test_scan_cli_fft_mode_matches_jax(tmp_path):
    """``python -m ...scan fft`` on ``test_scan.py``'s capture: the port's
    output file is line for line the JAX package's, with the true control
    channel locked."""
    fs, center, cc = 2.4e6, 857.0e6, 857.4e6
    ch = _p25_cc_iq(n_frames=30, cc_freq=cc)
    n = (len(ch) // 16384) * 16384
    iq = M.multi_channel(fs, [(cc - center, ch)], n, noise_floor_db=-55.0,
                         rng=np.random.default_rng(3))
    path = tmp_path / "cap.dat"
    iq.astype(np.complex64).tofile(path)
    outs = {}
    for which, run in (("jax", j_scan_main),
                       ("torch", lambda a: t_scan_main(a, device="cpu"))):
        outs[which] = tmp_path / f"{which}.scan.output"
        run(["fft", str(path), "-r", str(fs), "-f", str(center),
             "-o", str(outs[which])])
    got = outs["torch"].read_text().splitlines()
    assert got == outs["jax"].read_text().splitlines()
    locked = [ln for ln in got
              if not ln.startswith("#") and "None None" not in ln]
    assert any(str(int(cc)) in ln for ln in locked), got


def test_entry_points_need_a_card_without_a_device(tmp_path, monkeypatch):
    """With no device given, every entry point of the slice runs on the
    card: without one each raises, and none falls back to the CPU."""
    from radiocapture_tpu_torch.tools import diag_scope, file_to_wav
    path = tmp_path / "cap.dat"
    np.zeros(16384 * 8, np.complex64).tofile(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: SpectrumScanner(1024).init(),
        lambda: trial_p25_lock(np.zeros(4, np.complex64), SAMP_RATE,
                               CENTER, [CENTER]),
        lambda: ScanningReceiver([ScanChannel(CENTER)], SAMP_RATE, CENTER),
        lambda: TF.fir_init(np.ones(5)),
        lambda: TFM.nbfm_init(np.ones(5)),
        lambda: t_scan_main(["fft", str(path), "-r", "2.4e6", "-f", "0"]),
        lambda: t_scan_main(["band", str(path), "-r", "2.4e6", "-f", "0"]),
        lambda: file_to_wav.main([str(path), str(tmp_path / "o.wav"),
                                  "--samp-rate", "2.4e6"]),
        lambda: diag_scope.main([str(path), "--samp-rate", "2.4e6"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_scan_slice_never_imports_jax():
    """A fresh interpreter imports the scan package and the tools and
    runs a CPU spectrum step without loading jax or the JAX package."""
    code = ("import sys, numpy as np\n"
            "from radiocapture_tpu_torch.scan import SpectrumScanner\n"
            "import radiocapture_tpu_torch.scan.__main__\n"
            "from radiocapture_tpu_torch.tools import (audio_gc, "
            "diag_scope, file_to_wav, measure_drift, uploader)\n"
            "sc = SpectrumScanner(256)\n"
            "st = sc.step(sc.init('cpu'), np.ones(512, np.complex64))\n"
            "assert sc.spectrum_db(st).shape == (256,)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'radiocapture_tpu' or "
            "m.startswith('radiocapture_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
