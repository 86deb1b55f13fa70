"""Numpy modulators for the benchmark's traffic, frozen.

A copy of the fixture modulators of the measured package (P25 C4FM and
CQPSK, the polyphase resampler), taken so that later edits of the
package's testing helpers cannot move the yardstick. They run on the
host once per run, for one baseband control channel that the traffic
generator places on the device.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as _sig

from benchmark.reference import taps as _taps

C4FM_LEVELS = np.array([+1.0, +3.0, -1.0, -3.0], np.float32)
C4FM_DEV_HZ = 600.0
CQPSK_LEVELS = np.array([+1.0, +3.0, -1.0, -3.0], np.float32)


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


def upsample_to(x: np.ndarray, from_rate: float, to_rate: float
                ) -> np.ndarray:
    up, down = _ratio(to_rate, from_rate)
    return _sig.resample_poly(x, up, down).astype(np.complex64)
