"""The traffic's fm modulator, found by the configuration's
``modulation``: seeded integers → narrowband FM voice → complex baseband
at ``fs``. Frozen: numpy and scipy only.

The traffic generator hands every modulator seeded integers in 0..3 at
the configuration's ``symbol_rate``. Here they are audio samples at that
rate (8 kHz for ``analog_voice``) on four levels, (2k - 3) / 3. They are
resampled to ``fs``, band-passed to the voice band (``BAND_HZ``), scaled
to a peak of one and FM-modulated at ``PEAK_DEV_HZ``. Carson's bandwidth,
2 · (2.5 + 3) = 11 kHz, then fits a 12.5 kHz channel.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as _sig

PEAK_DEV_HZ = 2500.0
BAND_HZ = (300.0, 3000.0)
BAND_TAPS = 255


def modulate(dibits: np.ndarray, fs: float = 25000.0,
             symbol_rate: float = 8000.0, amp: float = 1.0) -> np.ndarray:
    """Audio samples ``dibits`` at ``symbol_rate`` → FM at ``fs``,
    complex64, ``len(dibits) · fs / symbol_rate`` samples."""
    levels = (2.0 * np.asarray(dibits, np.float64) - 3.0) / 3.0
    a, b = int(round(fs)), int(round(symbol_rate))
    g = math.gcd(a, b)
    audio = _sig.resample_poly(levels, a // g, b // g)
    band = _sig.firwin(BAND_TAPS, BAND_HZ, pass_zero=False, fs=fs)
    audio = np.convolve(audio, band, mode="same")
    audio /= max(float(np.max(np.abs(audio))), 1e-12)
    phase = 2.0 * np.pi * np.cumsum(PEAK_DEV_HZ * audio) / fs
    return (amp * np.exp(1j * phase)).astype(np.complex64)
