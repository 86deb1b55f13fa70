"""Polyphase rational resampler, streaming (port of
``radiocapture_tpu.ops.resample``).

The reference's ``filter.rational_resampler_fff`` to the 8 kHz audio rate
(logging_receiver.py:216-221). The recorder runs it per open analog call
on audio the runtime has already fetched to the host, so it runs on CPU
tensors and gets no device kernel: a kernel would add a host → device →
host round trip per call per block for ~800 output samples. Same
polyphase gather as the JAX package: indices precomputed in numpy, then
``frames · coefs`` summed over the taps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.ops import taps as _taps


class RationalResamplerState(NamedTuple):
    history: torch.Tensor  # [kp] trailing input samples, float32


def design_resampler_taps(interp: int, decim: int,
                          atten_db: float = 60.0) -> np.ndarray:
    """Prototype low-pass at min(π/interp, π/decim) with gain=interp."""
    cutoff = 0.5 / max(interp, decim)
    transition = 0.2 / max(interp, decim)
    t = _taps.low_pass_2(float(interp), 1.0, cutoff, transition, atten_db)
    # pad to a multiple of interp so the polyphase split is rectangular
    pad = (-len(t)) % interp
    if pad:
        t = np.concatenate([t, np.zeros(pad, np.float32)])
    return t


def resampler_init(taps, interp: int) -> RationalResamplerState:
    kp = len(taps) // interp
    return RationalResamplerState(history=torch.zeros(kp,
                                                      dtype=torch.float32))


def rational_resample(state: RationalResamplerState, x: torch.Tensor,
                      taps: torch.Tensor, interp: int, decim: int
                      ) -> tuple[RationalResamplerState, torch.Tensor]:
    """Resample the 1-D ``x`` by interp/decim; ``len(x)·interp`` must be
    a multiple of ``decim``. Upsample by ``interp`` (zero-stuffing),
    filter with ``taps`` (which carry the ×interp gain), downsample by
    ``decim``."""
    k = taps.shape[0]
    kp = k // interp
    n_in = x.shape[0]
    n_out = n_in * interp // decim
    if n_in * interp % decim != 0:
        raise ValueError(
            f"block of {n_in} with {interp}/{decim} gives fractional output")
    hp = taps.reshape(kp, interp).T                    # [interp, kp]
    z = torch.cat([state.history, x.to(torch.float32)])    # [kp + n_in]
    # output m sits at upsampled position p = m·decim:
    #   y[m] = Σ_j hp[p % interp, j] · z[p // interp + kp - j]
    p = np.arange(n_out) * decim
    phase = torch.from_numpy(p % interp)
    base = p // interp + kp
    gather_idx = torch.from_numpy(base[:, None] - np.arange(kp)[None, :])
    y = torch.sum(z[gather_idx] * hp[phase], dim=-1)
    return RationalResamplerState(history=z[z.shape[0] - kp:]), y


def resample_ratio(in_rate: float, out_rate: float) -> tuple[int, int]:
    """Smallest (interp, decim) with out = in · interp / decim."""
    g = math.gcd(int(round(in_rate)), int(round(out_rate)))
    return int(round(out_rate)) // g, int(round(in_rate)) // g
