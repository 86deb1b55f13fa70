"""Fixture streams with known content, and the decode that checks them:
P25 TSDU dibit streams carrying numbered grants, a P25 site's control
channel broadcasting its identity (the scan fixture), an LDU1 voice
stream (the ``file_to_wav`` fixture), the impaired CQPSK
modulations of the JAX package's ``tests/test_cqpsk_chain.py``, a Phase 2
TDMA superframe, and the channel-rate IQ of two granted calls for the
site runtime (P25 C4FM voice, EDACS analog). Numpy only, built from the
port's copies of the protocol modules, so ``chip_smoke.py`` and the card
tests run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

from radiocapture_tpu_torch.demod import tdma
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.fec import bits
from radiocapture_tpu_torch.protocol import edacs, p25
from radiocapture_tpu_torch.testing import modulators as M

#: (NAC, system ID, WACN) of the TDMA fixture: the scrambler's seed
TDMA_KEY = (0x293, 0x2C1, 0xBEE00)
CQPSK_FIXTURES = ("clean", "offset_noise", "clock_drift")


def p25_control_stream(n_frames: int, nac: int = 0x293,
                       channel: int = 0x2000, group: int = 200,
                       source: int = 777000):
    """TSDU frames, each a GRP_V_CH_GRANT numbered from (channel, group,
    source) and an RFSS_STS_BCST. Returns (dibits, expected grants)."""
    frames, expected = [], []
    for i in range(n_frames):
        t1 = p25.pack_tsbk("GRP_V_CH_GRANT", mfid=0, **{
            "Service Options": 0, "Channel": channel + i,
            "Group Address": group + i, "Source Address": source + i})
        t2 = p25.pack_tsbk("RFSS_STS_BCST", mfid=0, **{
            "LRA": 1, "System ID": 0x2C1, "RF Sub-system ID": 3,
            "Site ID": 12, "Channel": 0x2100, "System Service Class": 0x70})
        frames.append(p25.build_tsdu_frame(nac, [t1, t2]))
        expected.append((channel + i, group + i, source + i))
    return bits.bits_to_dibits(np.concatenate(frames)), expected


def p25_site_control(n_frames: int, cc_freq: float, nac: int = 0x293
                     ) -> np.ndarray:
    """The scan fixture of the JAX package's ``tests/test_scan.py``:
    TSDU frames of RFSS_STS_BCST (System ID 0x2C1, RF Sub-system 1, Site
    7), NET_STS_BCST (WACN 0xBEE00) and IDEN_UP, whose channel resolves to
    ``cc_freq`` (on the 6.25 kHz raster above 851.00625 MHz). Returns the
    dibits."""
    cc_chan = 0x1000 + int(round((cc_freq - 851.00625e6) / 6.25e3))
    frames = []
    for _ in range(n_frames):
        rfss = p25.pack_tsbk("RFSS_STS_BCST", **{
            "LRA": 0, "System ID": 0x2C1, "RF Sub-system ID": 1,
            "Site ID": 7, "Channel": cc_chan, "System Service Class": 0x70})
        net = p25.pack_tsbk("NET_STS_BCST", **{
            "LRA": 0, "WACN ID": 0xBEE00, "System ID": 0x2C1,
            "Channel": cc_chan, "System Service Class": 0x70})
        iden = p25.pack_tsbk("IDEN_UP", last_block=True, **{
            "Identifier": 1, "BW": 100,
            "Base Frequency": int(851.00625e6 / 5),
            "Channel Spacing": 50, "Transmit Offset": 0x1B4})
        frames.append(p25.build_tsdu_frame(nac, [rfss, net, iden]))
    return bits.bits_to_dibits(np.concatenate(frames))


def p25_ldu_voice(n_frames: int, nac: int = 0x293) -> np.ndarray:
    """The ``file_to_wav`` fixture of the JAX package's
    ``tests/test_file_to_wav.py``: ``n_frames`` LDU1 frames (group 123,
    source 456), each carrying the same nine 0/1-pattern codewords.
    Returns the dibits."""
    lc = p25.make_link_control(0x0, tgid=123, source_id=456)
    vcs = (np.arange(9 * 144).reshape(9, 144) % 2).astype(np.uint8)
    frames = [p25.build_ldu1_frame(nac, lc, vcs) for _ in range(n_frames)]
    return bits.bits_to_dibits(np.concatenate(frames))


def grants(dibits: np.ndarray, nac: int | None = None) -> list:
    """(channel, group, source) of every CRC-clean GRP_V_CH_GRANT in a
    dibit stream (of frames with ``nac``, if given)."""
    out = []
    for fb in Framer().feed(np.asarray(dibits, np.uint8)):
        fr = p25.parse_frame(fb)
        if nac is not None and fr.nac != nac:
            continue
        out.extend((t["Channel"], t["Group Address"], t["Source Address"])
                   for t in fr.tsbks
                   if t.get("crc") == 0 and t["name"] == "GRP_V_CH_GRANT")
    return out


def cqpsk_fixture(kind: str, fs: float = 25000.0):
    """The CQPSK control-channel fixtures of test_cqpsk_chain.py at
    ``fs``: "clean" (6 frames), "offset_noise" (8 frames, +400 Hz, 15 dB
    SNR), "clock_drift" (8 frames, 0.05% symbol-clock error). Returns
    (iq complex64, expected grants)."""
    if kind == "clean":
        dib, expected = p25_control_stream(6)
        return M.cqpsk_modulate(dib, fs=fs), expected
    dib, expected = p25_control_stream(8)
    if kind == "offset_noise":
        return M.awgn(M.freq_shift(M.cqpsk_modulate(dib, fs=fs), fs, 400.0),
                      15.0), expected
    if kind == "clock_drift":
        return M.cqpsk_modulate(dib, fs=fs * 1.0005), expected
    raise ValueError(f"unknown CQPSK fixture {kind!r}")


def tdma_superframe(seed: int = 5):
    """One scrambled Phase 2 superframe (with lead-in) carrying 18 random
    voice codewords per TDMA channel. Returns (dibits, voice)."""
    rng = np.random.default_rng(seed)
    voice = {c: [rng.integers(0, 2, 72).astype(np.uint8) for _ in range(18)]
             for c in (0, 1)}
    return tdma.build_tdma_stream(*TDMA_KEY, voice), voice


def tdma_bursts(dibits: np.ndarray, framer=None) -> list:
    """(seq, kind, slot, voice codewords) of every burst a TdmaFramer
    (the port's copy unless ``framer`` is given) frames from ``dibits``."""
    framer = framer or tdma.TdmaFramer(*TDMA_KEY)
    return [(b.seq, b.kind, b.slot, [v.tolist() for v in b.voice])
            for b in framer.feed(np.asarray(dibits, np.uint8))]


def tdma_voice_ok(bursts: list, voice: dict) -> bool:
    """All 12 bursts of the superframe, each channel's voice codewords
    as sent."""
    rx = {0: [], 1: []}
    for _, _, slot, vcs in bursts:
        rx[slot].extend(vcs)
    return len(bursts) == 12 and all(
        rx[c] == [v.tolist() for v in voice[c]] for c in (0, 1))


def p25_voice_call(vc_freq: float, seconds: float, group: int = 500,
                   source: int = 42, nac: int = 0x293, seed: int = 7):
    """A P25 C4FM call at 25 kS/s: a control channel repeating IDEN_UP
    (channel 0x1000 ↦ ``vc_freq``, a multiple of 5 Hz) and a
    GRP_V_CH_GRANT of channel 0x1000 for (``group``, ``source``), and the
    voice channel's LDU1 stream carrying random IMBE codewords, both
    ``seconds`` long. Returns (control IQ, voice IQ, codewords sent
    [n, 144] uint8 in order)."""
    iden = p25.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100, "Base Frequency": int(vc_freq / 5),
        "Channel Spacing": 50, "Transmit Offset": 0x1B4})
    grant = p25.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1000, "Group Address": group,
        "Source Address": source})
    pair = [p25.build_tsdu_frame(nac, [iden]),
            p25.build_tsdu_frame(nac, [grant])]
    n = int(seconds * 25000.0)
    cc = M.c4fm_modulate(bits.bits_to_dibits(np.concatenate(
        pair * (n // (len(np.concatenate(pair)) * 5 // 2) + 1))),
        fs=25000.0)[:n]
    rng = np.random.default_rng(seed)
    lc = p25.make_link_control(0x0, tgid=group, source_id=source)
    sent, ldus = [], []
    while sum(map(len, ldus)) * 5 // 2 < n:         # 5 samples per bit
        vcs = rng.integers(0, 2, (9, 144)).astype(np.uint8)
        sent.append(vcs)
        ldus.append(p25.build_ldu1_frame(nac, lc, vcs))
    vc = M.c4fm_modulate(bits.bits_to_dibits(np.concatenate(ldus)),
                         fs=25000.0)[:n]
    return cc, vc, np.concatenate(sent)


def live_control(modulation: str = "C4FM", group: int = 900,
                 source: int = 45, center: float = 857.0e6,
                 cc_freq: float = 857.5e6) -> np.ndarray:
    """The live-SDR fixture of the JAX package's ``tests/test_rtl_tcp.py``
    and ``tests/test_rciq.py``: ten pairs of TSDU frames, an IDEN_UP and
    a GRP_V_CH_GRANT of channel 0x1000 for (``group``, ``source``),
    modulated as C4FM or CQPSK (LSM) at 25 kS/s, at ``cc_freq`` in a
    2.4 MS/s wideband capture at ``center`` over a −60 dB floor, scaled to
    1/1.2 of full scale (the rtl_tcp and rciq wire formats are integers).
    Returns complex64."""
    iden = p25.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100, "Base Frequency": int(856.2e6 / 5),
        "Channel Spacing": 50, "Transmit Offset": 0x1B4})
    grant = p25.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1000, "Group Address": group,
        "Source Address": source})
    frames = [p25.build_tsdu_frame(0x293, [iden]),
              p25.build_tsdu_frame(0x293, [grant])] * 10
    dib = bits.bits_to_dibits(np.concatenate(frames))
    mod = {"C4FM": M.c4fm_modulate,
           "CQPSK": M.cqpsk_modulate}[modulation.upper()]
    cc = M.upsample_to(mod(dib, fs=25000.0), 25000.0, 2.4e6)
    wide = M.multi_channel(2.4e6, [(cc_freq - center, cc)], len(cc),
                           noise_floor_db=-60.0)
    return (wide / (np.max(np.abs(wide)) * 1.2)).astype(np.complex64)


def codewords_ok(got: list, sent: np.ndarray, least: int) -> bool:
    """``got`` holds at least ``least`` codewords and is a contiguous run
    of ``sent``."""
    if len(got) < least:
        return False
    got = np.asarray(got, np.uint8)
    starts = [i for i in range(len(sent) - len(got) + 1)
              if np.array_equal(sent[i], got[0])]
    return any(np.array_equal(sent[i:i + len(got)], got) for i in starts)


def edacs_analog_call(seconds: float, keyup_s: float, tone_hz: float,
                      lcn: int = 3, group: int = 321,
                      logical_id: int = 4567):
    """An EDACS analog call at 25 kS/s: a 9600 Bd control channel
    repeating the call assignment (``lcn``, ``group``, ``logical_id``),
    and the granted channel carrying an FM tone (0.8 of a 2.5 kHz
    deviation) from ``keyup_s`` on, both ``seconds`` long. Returns
    (control IQ, voice IQ)."""
    n = int(seconds * 25000.0)
    frame = edacs.build_frame(*edacs.make_call_assignment(
        lcn=lcn, group=group, logical_id=logical_id))
    n_frames = int(seconds * 9600.0) // len(frame) + 1
    cc_bits = np.concatenate([np.tile(np.array([0, 1], np.uint8), 40)]
                             + [frame] * n_frames)
    cc = M.fsk2_modulate(cc_bits, 25000.0, baud=9600.0, dev_hz=3000.0)[:n]
    t = np.arange(n) / 25000.0
    on = t >= keyup_s
    audio = np.where(on, 0.8 * np.sin(2 * np.pi * tone_hz * t), 0.0)
    vc = M.fm_modulate(audio.astype(np.float32), 25000.0, 2500.0) * on
    return cc, vc.astype(np.complex64)


def two_carriers(samp_rate: float = 2.4e6, frames: int = 16,
                 fft_len: int = 16384) -> np.ndarray:
    """The spectrum fixture of the JAX package's ``tests/test_scan.py``:
    9600 Bd and 3600 Bd FSK carriers at −400 kHz and +250 kHz over a
    −55 dB floor, ``frames`` FFT frames of ``fft_len``."""
    rng = np.random.default_rng(7)
    tone_a = M.fsk2_modulate(rng.integers(0, 2, 4000), samp_rate,
                             9600.0, 4000.0)
    tone_b = M.fsk2_modulate(rng.integers(0, 2, 4000), samp_rate,
                             3600.0, 4000.0)
    return M.multi_channel(samp_rate, [(-400e3, tone_a), (250e3, tone_b)],
                           fft_len * frames, noise_floor_db=-55.0, rng=rng)


def site_capture(cc_freq: float, center: float, n_frames: int = 10,
                 samp_rate: float = 2.4e6, n: int | None = None,
                 rng=None) -> np.ndarray:
    """The ``p25_site_control`` channel at ``cc_freq`` in a wideband
    capture at ``center`` over a −55 dB floor (``tests/test_scan.py``'s
    discovery capture with the defaults); ``n`` samples, default the
    channel's length."""
    ch = M.upsample_to(M.c4fm_modulate(p25_site_control(n_frames, cc_freq),
                                       fs=25000.0), 25000.0, samp_rate)
    return M.multi_channel(samp_rate, [(cc_freq - center, ch)],
                           len(ch) if n is None else n,
                           noise_floor_db=-55.0, rng=rng)


def fm_tone(seconds: float, tone_hz: float = 700.0, amp: float = 0.7,
            fs: float = 25000.0, max_dev: float = 4000.0) -> np.ndarray:
    """An FM-modulated tone at the channel rate (``tests/
    test_file_to_wav.py``'s analog signal with the defaults)."""
    t = np.arange(int(seconds * fs)) / fs
    return M.fm_modulate(amp * np.sin(2 * np.pi * tone_hz * t), fs, max_dev)


def tone_capture(offset_hz: float, seconds: float = 1.0,
                 samp_rate: float = 2.4e6) -> np.ndarray:
    """``fm_tone`` at ``offset_hz`` in a wideband capture, complex64
    (``tests/test_file_to_wav.py``'s analog capture with the defaults and
    −300 kHz)."""
    return M.freq_shift(M.upsample_to(fm_tone(seconds), 25000.0, samp_rate),
                        samp_rate, offset_hz).astype(np.complex64)


def ldu_capture(offset_hz: float, n_frames: int = 4,
                samp_rate: float = 2.4e6) -> np.ndarray:
    """``p25_ldu_voice`` at ``offset_hz`` in a wideband capture
    (``tests/test_file_to_wav.py``'s P25 capture with the defaults and
    +100 kHz)."""
    iq = M.c4fm_modulate(p25_ldu_voice(n_frames), fs=25000.0)
    return M.freq_shift(M.upsample_to(iq, 25000.0, samp_rate), samp_rate,
                        offset_hz)


def tone_peak_hz(pcm: np.ndarray, rate: float = 8000.0,
                 lo: int = 2000, hi: int = 6000) -> float:
    """The strongest frequency of ``pcm[lo:hi]`` (Hann window, DC bins
    skipped), the pitch check of ``tests/test_file_to_wav.py``."""
    seg = np.asarray(pcm[lo:hi], np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float((np.argmax(spec[10:]) + 10) * rate / len(seg))


def squelch_cycle(receiver_cls, channel_cls, freqs: list, center: float,
                  samp_rate: float = 2.4e6, **kw):
    """``tests/test_scan.py``'s squelch cycle through a scanning receiver
    of ``receiver_cls`` watching ``freqs`` (threshold 1e-4): an 800 Hz FM
    carrier at ``freqs[0]`` for two blocks of decim·256 samples, 0.1 s
    apart, then silence 0.2 s and 0.8 s after, with a fake clock.
    Returns (the events in order as (kind, CDR or call uuid), the call
    uuids numbered by first appearance; the CDRs ``feed`` returned)."""
    fake_now = [0.0]
    seq = []
    sr = receiver_cls([channel_cls(frequency=f, threshold=1e-4)
                       for f in freqs], samp_rate, center,
                      on_new_call=lambda cdr: seq.append(("new", cdr)),
                      on_activity=lambda cu: seq.append(("act", cu)),
                      on_timeout=lambda cdr: seq.append(("to", cdr)),
                      clock=lambda: fake_now[0], **kw)
    blk = sr.decim * 256
    audio = np.sin(2 * np.pi * 800.0 * np.arange(int(0.2 * 25000)) / 25000)
    nb = M.fm_modulate(audio * 0.8, 25000.0, 4000.0)
    on_air = M.freq_shift(M.upsample_to(nb, 25000.0, samp_rate), samp_rate,
                          freqs[0] - center)
    silence = (1e-5 * np.random.default_rng(5).standard_normal(3 * blk)
               ).astype(np.complex64)
    opened = []
    for dt, x in [(0.0, on_air[:blk]), (0.1, on_air[blk:2 * blk]),
                  (0.2, silence[:blk]), (0.6, silence[blk:2 * blk])]:
        fake_now[0] += dt
        opened.extend(sr.feed(x))
    names: dict = {}

    def norm(v):
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, str) and len(v) == 36:      # a call uuid
            return names.setdefault(v, f"call{len(names)}")
        return v
    return [(kind, norm(v)) for kind, v in seq], opened


def same_trials(got: list, want: list, offset_tol_hz: float = 1.0) -> bool:
    """Two ``trial_p25_lock`` result lists decide alike: the same
    candidates, locked set and site detail, offsets within
    ``offset_tol_hz``."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if (g.frequency, g.locked, g.site_detail) != \
                (w.frequency, w.locked, w.site_detail):
            return False
        if (g.offset_hz is None) != (w.offset_hz is None):
            return False
        if g.offset_hz is not None and \
                abs(g.offset_hz - w.offset_hz) > offset_tol_hz:
            return False
    return True


#: spectrum_db agreement between two float32 FFTs (cuFFT, pocketfft,
#: XLA's): SPEC_ATOL in log10 units plus SPEC_ULPS float32 ulps of the
#: peak bin's amplitude, which a bin d decades below the peak sees as
#: 10^(d/2) times more in relative amplitude, 2/ln 10 of that in log10
#: power. On ``two_carriers`` (floor 9 decades down) cuFFT on an H100
#: and the CPU's pocketfft differ by ~6e-6 within 6 decades of the peak
#: and ~3e-3 at the floor (``chip_smoke.py``'s ``decode scan:`` line).
SPEC_ATOL = 1e-4
SPEC_ULPS = 8


def spectrum_tolerance(want: np.ndarray) -> np.ndarray:
    """Per-bin tolerance for a spectrum against ``want`` (see SPEC_ULPS)."""
    depth = want.max() - want
    return SPEC_ATOL + (2.0 / np.log(10.0)) * SPEC_ULPS * float(
        np.finfo(np.float32).eps) * 10.0 ** (depth / 2.0)
