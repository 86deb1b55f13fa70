"""Port parity, the offline tools: ``file_to_wav`` (the analog chain to
an 8 kHz WAV and the P25 chain to frame stats and vocoder PCM, through
the functions and the CLI) and ``diag_scope``, each run on the same
seeded numpy inputs through the JAX package (on the CPU) and the port
(``device="cpu"``). The fixtures are ``tests/test_file_to_wav.py``'s and
``tests/test_tools.py``'s. The stdlib/numpy tools (``uploader``,
``audio_gc``, ``measure_drift``) are copies, held by
``tests/test_torch_host.py``."""

import ast

import numpy as np
import pytest
import torch

from radiocapture_tpu.audio.wav import read_wav
from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.testing import modulators as M
from radiocapture_tpu.tools import diag_scope as JDS
from radiocapture_tpu.tools import file_to_wav as JFW
from radiocapture_tpu_torch.testing import streams
from radiocapture_tpu_torch.tools import diag_scope as TDS
from radiocapture_tpu_torch.tools import file_to_wav as TFW

torch.set_num_threads(1)   # six test workers share the machine


@pytest.fixture(autouse=True)
def _isolate_port_vocoder(monkeypatch):
    """Each test starts with no default vocoder in the port's recorder, as
    the JAX package's has none (``tests/conftest.py`` restores it): a port
    ``SiteRuntime`` of an earlier test in this process installs one, and
    its decoder state would change this test's PCM."""
    from radiocapture_tpu_torch.audio import recorder
    monkeypatch.setattr(recorder, "_default_vocoder", None)


SAMP_RATE = 2.4e6
# The analog chain's 8 kHz float audio: the bank's float32 sums and the
# de-emphasis IIR in another order, carried through scipy's resampler
# and the band-pass (float64, the same code on both sides); held to this
# share of max|audio| (test_torch_voice.py's IIR_TOL).
AUDIO_REL = 1e-5
# The WAV's 16-bit PCM of that audio: within one LSB (a rounding that
# lands on the other side of a half step).
PCM_LSB = 1


def _analog_capture():
    """``test_file_to_wav.py``'s capture: 1 s of a 700 Hz FM tone at
    −300 kHz in 2.4 MS/s."""
    fs_ch = 25000.0
    t = np.arange(int(1.0 * fs_ch)) / fs_ch
    nb = M.fm_modulate(0.7 * np.sin(2 * np.pi * 700.0 * t), fs_ch, 4000.0)
    return M.freq_shift(M.upsample_to(nb, fs_ch, SAMP_RATE), SAMP_RATE,
                        -300e3).astype(np.complex64)


def _ldu_capture():
    """``test_file_to_wav.py``'s P25 capture: four LDU1 frames at
    +100 kHz."""
    lc = P.make_link_control(0x0, tgid=123, source_id=456)
    vcs = (np.arange(9 * 144).reshape(9, 144) % 2).astype(np.uint8)
    frames = [P.build_ldu1_frame(0x293, lc, vcs) for _ in range(4)]
    dibits = B.bits_to_dibits(np.concatenate(frames))
    iq = M.c4fm_modulate(dibits, fs=25000.0)
    return M.freq_shift(M.upsample_to(iq, 25000.0, SAMP_RATE),
                        SAMP_RATE, 100e3)


def test_fixtures_are_the_jax_tests():
    """The port's JAX-free fixtures (used on the card) are the JAX tests'
    captures, sample for sample."""
    np.testing.assert_array_equal(streams.ldu_capture(100e3),
                                  _ldu_capture())
    np.testing.assert_array_equal(streams.tone_capture(-300e3),
                                  _analog_capture())


def test_decode_analog_matches_jax():
    """``decode_analog`` on the 1 s tone: the port's 8 kHz audio has
    JAX's length and is within AUDIO_REL·max|audio| of it."""
    iq = _analog_capture()
    want = JFW.decode_analog(iq, SAMP_RATE, offset_hz=-300e3)
    got = TFW.decode_analog(iq, SAMP_RATE, offset_hz=-300e3, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert len(got) > 7000
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=AUDIO_REL * np.abs(want).max())


def test_file_to_wav_analog_matches_jax(tmp_path):
    """The analog CLI path (``file_to_wav``) writes a WAV at 8 kHz whose
    PCM is JAX's within PCM_LSB, with the tone's pitch."""
    inp = tmp_path / "cap.dat"
    _analog_capture().tofile(inp)
    out = {w: tmp_path / f"{w}.wav" for w in ("jax", "torch")}
    want_stats = JFW.file_to_wav(str(inp), str(out["jax"]), SAMP_RATE,
                                 offset_hz=-300e3, modulation="analog")
    stats = TFW.file_to_wav(str(inp), str(out["torch"]), SAMP_RATE,
                            offset_hz=-300e3, modulation="analog",
                            device="cpu")
    assert stats == want_stats
    got, rate = read_wav(str(out["torch"]))
    want, _ = read_wav(str(out["jax"]))
    assert rate == 8000 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= PCM_LSB
    peak_hz = streams.tone_peak_hz(got)
    assert abs(peak_hz - 700.0) < 15.0, peak_hz


def test_decode_p25_matches_jax():
    """``decode_p25`` on the LDU1 capture: the same frame stats as JAX's
    and the same vocoder PCM, sample for sample; with the vocoder opted
    out, the same stats and no audio."""
    wide = _ldu_capture()
    want_audio, want = JFW.decode_p25(wide, SAMP_RATE, offset_hz=100e3)
    audio, stats = TFW.decode_p25(wide, SAMP_RATE, offset_hz=100e3,
                                  device="cpu")
    assert stats == want
    assert stats["ldu"] >= 2 and stats["imbe"] == stats["ldu"] * 9
    np.testing.assert_array_equal(audio, want_audio)
    assert len(audio) == stats["imbe"] * 160

    class _NoVoc:
        available = False
    audio2, stats2 = TFW.decode_p25(wide, SAMP_RATE, offset_hz=100e3,
                                    vocoder=_NoVoc(), device="cpu")
    assert stats2 == want and len(audio2) == 0


@pytest.mark.parametrize("modulation", ["p25", "c4fm"])
def test_file_to_wav_cli_p25_matches_jax(tmp_path, capsys, modulation):
    """``python -m ...tools.file_to_wav --modulation p25|c4fm``: the port's
    CLI prints JAX's stats and writes the same WAV."""
    inp = tmp_path / "cap.dat"
    _ldu_capture().astype(np.complex64).tofile(inp)
    printed = {}
    for which, run in (("jax", JFW.main),
                       ("torch", lambda a: TFW.main(a, device="cpu"))):
        run([str(inp), str(tmp_path / f"{which}.wav"), "--samp-rate",
             str(SAMP_RATE), "--offset", "100e3", "--modulation",
             modulation])
        printed[which] = ast.literal_eval(capsys.readouterr().out.strip())
    assert printed["torch"] == printed["jax"]
    assert printed["torch"]["imbe"] > 0
    got, _ = read_wav(str(tmp_path / "torch.wav"))
    want, _ = read_wav(str(tmp_path / "jax.wav"))
    np.testing.assert_array_equal(got, want)


def test_file_to_wav_refuses_other_modulations(tmp_path):
    inp = tmp_path / "cap.dat"
    np.zeros(16, np.complex64).tofile(inp)
    with pytest.raises(ValueError, match="analog|p25"):
        TFW.file_to_wav(str(inp), str(tmp_path / "o.wav"), SAMP_RATE,
                        modulation="provoice", device="cpu")


def test_diag_scope_matches_jax():
    """``test_tools.py``'s carrier at +50 kHz of 400 kHz: the port's
    scope prints JAX's line and axis, character for character."""
    fs = 400e3
    iq = M.awgn(M.tone(fs, 50e3, 4096 * 8, amp=1.0), 30)
    want = JDS.scope(iq, fs, center_freq=857e6, fft_len=4096, frames=8,
                     width=80)
    got = TDS.scope(iq, fs, center_freq=857e6, fft_len=4096, frames=8,
                    width=80, device="cpu")
    assert got == want
    line = got.split("\n")[0]
    peak_col = max(range(80), key=lambda i: TDS.BARS.index(line[i]))
    assert 46 <= peak_col <= 54


def test_render_spectrum_identical():
    rng = np.random.default_rng(0)
    for spec in (rng.normal(-80, 0.1, 4096), rng.normal(-60, 8.0, 2048)):
        for width in (50, 100):
            assert TDS.render_spectrum(spec, width) == \
                JDS.render_spectrum(spec, width)


def test_diag_scope_cli(tmp_path, capsys):
    """``python -m ...tools.diag_scope`` prints the scope of a capture
    file, as JAX's CLI does."""
    fs = 400e3
    inp = tmp_path / "cap.dat"
    M.awgn(M.tone(fs, -120e3, 4096 * 40, amp=1.0), 30).astype(
        np.complex64).tofile(inp)
    args = [str(inp), "--samp-rate", str(fs), "--center-freq", "857e6",
            "--width", "60"]
    JDS.main(args)
    want = capsys.readouterr().out
    TDS.main(args, device="cpu")
    assert capsys.readouterr().out == want
