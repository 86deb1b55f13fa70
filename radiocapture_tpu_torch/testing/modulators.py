"""Numpy modulators that synthesize on-air IQ for fixture generation.

A jax-free copy of the fixture half of ``radiocapture_tpu.testing.
modulators`` (whose ``ops.taps`` import pulls in jax): the GPU machine
runs ``chip_smoke.py`` without JAX. ``tests/test_torch_ops.py`` asserts
every function here gives arrays identical to the JAX package's copy.
These run on the host; each decode test is closed-loop: known bits →
modulate → channel impairments → demod → compare.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as _sig

from radiocapture_tpu_torch.ops import taps as _taps

# P25 C4FM dibit → symbol level (TIA-102.BAAA dibit/deviation mapping:
# 01→+1800 Hz, 00→+600, 10→-600, 11→-1800; levels in units of 600 Hz).
C4FM_LEVELS = np.array([+1.0, +3.0, -1.0, -3.0], np.float32)
C4FM_DEV_HZ = 600.0


def tone(fs: float, freq: float, n: int, amp: float = 1.0,
         phase0: float = 0.0) -> np.ndarray:
    t = np.arange(n) / fs
    return (amp * np.exp(1j * (2 * np.pi * freq * t + phase0))
            ).astype(np.complex64)


def freq_shift(x: np.ndarray, fs: float, freq: float) -> np.ndarray:
    n = np.arange(len(x))
    return (x * np.exp(2j * np.pi * freq * n / fs)).astype(np.complex64)


def awgn(x: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    p_sig = np.mean(np.abs(x) ** 2)
    p_noise = p_sig / (10 ** (snr_db / 10))
    noise = (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    noise *= np.sqrt(p_noise / 2)
    return (x + noise).astype(np.complex64)


def c4fm_modulate(dibits: np.ndarray, fs: float = 25000.0,
                  symbol_rate: float = 4800.0, amp: float = 1.0
                  ) -> np.ndarray:
    """P25 C4FM: dibits → 4-level deviation impulse train → RC+sinc-comp
    shaping → FM modulate. Generated at an integer samples-per-symbol
    rate then polyphase-resampled to ``fs``."""
    sps_gen = 10
    fs_gen = symbol_rate * sps_gen
    levels = C4FM_LEVELS[np.asarray(dibits, np.int64)]
    train = np.zeros(len(levels) * sps_gen, np.float32)
    train[::sps_gen] = levels
    shaping = _taps.c4fm_shaping(fs_gen, symbol_rate)
    dev = np.convolve(train, shaping, mode="full")[: len(train)]
    freq_hz = dev * C4FM_DEV_HZ
    up, down = _ratio(fs, fs_gen)
    freq_rs = _sig.resample_poly(freq_hz, up, down)
    phase = 2 * np.pi * np.cumsum(freq_rs) / fs
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def fsk2_modulate(bits: np.ndarray, fs: float, baud: float, dev_hz: float,
                  amp: float = 1.0, invert: bool = False,
                  bt: float = 0.5) -> np.ndarray:
    """Binary FSK: bit 1 → +dev, bit 0 → -dev (or inverted), with a
    Gaussian-ish low-pass on the frequency trajectory (EDACS 9600 Bd and
    Motorola Type II 3600 Bd control-channel fixtures)."""
    sps_gen = 8
    fs_gen = baud * sps_gen
    sig = np.asarray(bits, np.float32) * 2.0 - 1.0
    if invert:
        sig = -sig
    train = np.repeat(sig, sps_gen)
    cutoff = bt * baud
    lp = _sig.firwin(int(4 * sps_gen) | 1, cutoff, fs=fs_gen)
    dev = np.convolve(train, lp, mode="same")
    up, down = _ratio(fs, fs_gen)
    freq_rs = _sig.resample_poly(dev * dev_hz, up, down)
    phase = 2 * np.pi * np.cumsum(freq_rs) / fs
    return (amp * np.exp(1j * phase)).astype(np.complex64)


# CQPSK dibit → differential phase step, in quarter-pi units (P25 LSM:
# the same dibit alphabet as C4FM maps to +/-45 and +/-135 degree phase
# advances; slicing arg/(pi/4) recovers the identical dibit).
CQPSK_LEVELS = np.array([+1.0, +3.0, -1.0, -3.0], np.float32)


def cqpsk_modulate(dibits: np.ndarray, fs: float = 25000.0,
                   symbol_rate: float = 4800.0, amp: float = 1.0,
                   beta: float = 0.2) -> np.ndarray:
    """P25 CQPSK/LSM: dibits → differential pi/4 phase steps →
    raised-cosine-shaped PSK at an arbitrary (non-integer sps) rate.

    Full RC shaping (not root-RC) because the receive chain applies no
    matched filter — the reference's ``symbol_filter_c`` is a pass-through
    ``multiply_const_cc(1.0)`` (p25_control_demod.py:150) — so the TX
    pulse alone must put the ISI nulls at the symbol instants. The pulse
    is evaluated at exact fractional symbol offsets, so no resample step
    disturbs symbol timing.
    """
    dphi = CQPSK_LEVELS[np.asarray(dibits, np.int64)] * (np.pi / 4)
    phases = np.cumsum(dphi)
    syms = np.exp(1j * phases)
    sps = fs / symbol_rate
    span = 12
    n = int(np.ceil((len(syms) + span) * sps))
    t_sym = np.arange(n) / sps          # sample times in symbol units
    out = np.zeros(n, np.complex128)

    def rc(x):
        x = np.asarray(x, np.float64)
        den = 1.0 - (2 * beta * x) ** 2
        sing = np.abs(den) < 1e-8
        y = np.where(sing, np.pi / 4 * np.sinc(1.0 / (2 * beta)),
                     np.sinc(x) * np.cos(np.pi * beta * x)
                     / np.where(sing, 1.0, den))
        return y

    half = span // 2
    base = np.floor(t_sym).astype(np.int64)
    for off in range(-half, half + 1):
        k = base + off
        valid = (k >= 0) & (k < len(syms))
        kk = np.clip(k, 0, len(syms) - 1)
        out += np.where(valid, syms[kk] * rc(t_sym - k), 0.0)
    peak = np.max(np.abs(out))
    return (amp * out / max(peak, 1e-9)).astype(np.complex64)


def _ratio(out_rate: float, in_rate: float) -> tuple[int, int]:
    a, b = int(round(out_rate)), int(round(in_rate))
    g = math.gcd(a, b)
    return a // g, b // g


def multi_channel(fs: float, channels: list[tuple[float, np.ndarray]],
                  n: int, noise_floor_db: float = -60.0, rng=None
                  ) -> np.ndarray:
    """Compose a wideband capture from (offset_hz, narrowband_iq) pairs,
    each already at rate ``fs`` (zero-padded/truncated to ``n``)."""
    rng = rng or np.random.default_rng(1)
    out = (10 ** (noise_floor_db / 20.0) / np.sqrt(2)) * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for off, sig in channels:
        s = np.zeros(n, np.complex64)
        m = min(n, len(sig))
        s[:m] = sig[:m]
        out += freq_shift(s, fs, off)
    return out.astype(np.complex64)


def upsample_to(x: np.ndarray, from_rate: float, to_rate: float
                ) -> np.ndarray:
    up, down = _ratio(to_rate, from_rate)
    return _sig.resample_poly(x, up, down).astype(np.complex64)
