"""Batched wideband spectrum measurement + channel-peak detection (port
of ``radiocapture_tpu.scan.spectrum``).

The reference's scan front half:

- ``fft_vector.py:37-60``: stream_to_vector(16384) → fft_vcc(blackman-
  harris, shifted) → mag² → nlog10 → moving_average(100 frames), one
  averaged frame out. Here one step windows ``[frames, L]`` blocks,
  transforms them with ``torch.fft`` (cuFFT on the card) and adds their
  log-power to an explicit (sum, count) state, in float32 on the device.

- ``fft_peak_detection.py:46-65``: min-shift to non-negative, scipy
  ``find_peaks`` with width ∈ [3 kHz, 30 kHz] in bins and prominence 1,
  keep peaks above 2× the mean, map bin → absolute frequency via
  ``bin·hz_per_bin − bw/2 + center`` (numpy and scipy on the host, as in
  the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sig

from radiocapture_tpu_torch.device import resolve


class SpectrumState(NamedTuple):
    acc: torch.Tensor     # [fft_len] running sum of log-power frames (f32)
    count: torch.Tensor   # [] frames accumulated (f32)


class SpectrumScanner:
    """Streaming averaged log-power spectrum of a wideband source.

    ``step`` consumes ``[T]`` complex IQ or ``[T, 2]`` float32 re/im (T a
    multiple of ``fft_len``; numpy, or a tensor on the state's device)
    and accumulates per-frame log10(|FFT|²); ``spectrum_db`` reads the
    running average, DC-centred like the reference's shifted FFT
    (fft_vector.py:38).
    """

    def __init__(self, fft_len: int = 16384):
        self.fft_len = fft_len
        # Blackman-Harris per the reference (scipy's 4-term window)
        self.window = _sig.windows.blackmanharris(fft_len).astype(
            np.float32)
        self._windows: dict = {}     # device → the window there

    def init(self, device=None) -> SpectrumState:
        """Zero state on ``device`` (``None``: the card)."""
        dev = resolve(device)
        return SpectrumState(
            acc=torch.zeros(self.fft_len, dtype=torch.float32, device=dev),
            count=torch.zeros((), dtype=torch.float32, device=dev))

    def _window(self, device) -> torch.Tensor:
        w = self._windows.get(device)
        if w is None:
            w = self._windows[device] = torch.as_tensor(self.window,
                                                        device=device)
        return w

    def step(self, state: SpectrumState, x) -> SpectrumState:
        """Add the frames of ``x`` to ``state``. The block goes to the
        device as float32 (complex64), never the bf16 wire: the noise
        floor ``find_channels`` shifts by must not move."""
        dev = state.acc.device
        if isinstance(x, np.ndarray):
            if np.iscomplexobj(x):
                x = torch.from_numpy(np.ascontiguousarray(x, np.complex64))
            else:
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        x = x.to(dev)
        if not x.is_complex():
            x = torch.view_as_complex(x.to(torch.float32).contiguous())
        frames = x.to(torch.complex64).reshape(-1, self.fft_len) \
            * self._window(dev)
        spec = torch.fft.fftshift(torch.fft.fft(frames, dim=-1), dim=-1)
        logp = torch.log10(torch.clamp(spec.abs() ** 2, min=1e-30))
        return SpectrumState(acc=state.acc + logp.sum(0),
                             count=state.count + frames.shape[0])

    @staticmethod
    def spectrum_db(state: SpectrumState) -> np.ndarray:
        """Averaged log10 power per bin, [fft_len], DC-centred."""
        acc = state.acc.detach().cpu().numpy()
        n = float(state.count)
        return acc / max(n, 1.0)


@dataclass
class ChannelPeak:
    frequency: float       # absolute Hz
    bin: int
    power_db: float        # shifted log-power at the peak
    width_hz: float
    prominence: float


def find_channels(spectrum_db: np.ndarray, samp_rate: float,
                  center_freq: float, min_width_hz: float = 3000.0,
                  max_width_hz: float = 30000.0, prominence: float = 1.0,
                  mean_factor: float = 2.0) -> list[ChannelPeak]:
    """Peak detection with the reference's tuning
    (fft_peak_detection.py:52-72): widths in bins derived from Hz, peaks
    kept when the min-shifted value exceeds ``mean_factor`` × mean."""
    data = np.asarray(spectrum_db, np.float64).copy()
    n = len(data)
    hz_per_bin = samp_rate / n
    data += abs(data.min())
    avg = data.mean()
    idx, props = _sig.find_peaks(
        data, width=[min_width_hz / hz_per_bin, max_width_hz / hz_per_bin],
        prominence=prominence)
    out = []
    for i, b in enumerate(idx):
        if data[b] > avg * mean_factor:
            freq = b * hz_per_bin - samp_rate / 2.0 + center_freq
            out.append(ChannelPeak(
                frequency=float(int(freq)), bin=int(b),
                power_db=float(data[b]),
                width_hz=float(props["widths"][i] * hz_per_bin),
                prominence=float(props["prominences"][i])))
    return out
