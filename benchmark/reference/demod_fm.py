"""Plain reference of the analog voice demodulator (``AnalogVoicePipeline``
after the bank): quadrature discriminator → 75 µs de-emphasis → power, a
lane at a time over every lane at once, in float64.

The reference receiver's analog chain (logging_receiver.py:210-222) is
squelch → ``analog.fm_demod_cf`` (discriminator, 75 µs de-emphasis, audio
low-pass and decimation) → high-pass → resample → wav. Departures:

- Only the part in the step is here: the discriminator at the channel
  rate, ``gain · arg(x[n] · conj(x[n-1]))`` with ``gain = channel_fs /
  (2π · max_dev)``, the de-emphasis, and the power ``mean |x|²`` over the
  block that the squelch reads. The audio low-pass, the resample to 8 kHz
  and the high-pass run per open call on the host (``audio/recorder.py``).
- The de-emphasis is the one-pole filter matched by the bilinear
  transform, ``y[n] = z1 · y[n-1] + b0 · (d[n] + d[n-1])``, as ``ops/fm.py``
  describes it: ``z1`` and ``b0`` are worked out in float64 from
  ``tau_s`` and the channel rate and rounded once to float32, the values
  the configuration's float32 tracker states. ``fm_demod_cf`` designs its
  de-emphasis as an IIR of the same kind.
- The discriminator's product ``x · conj(x_prev)`` is taken in complex64,
  as the float32 tracker takes it, so that a step of π falls on the side
  of the branch cut the program's falls on; atan2 and everything after it
  are float64.

The channel samples are the program's (judged on their own by the
channelizer's numbers), and each kept pair starts from the program's
state before it, as the other references do. ``dtype=torch.bfloat16``
runs the same chain in bfloat16 (the discriminator, the de-emphasis and
the power): the control of the correctness check.

The judge and the control find this module by the name a path gives
(``reference/demod_<name>.py``). It has the names every demodulator
module has; the voice chain takes no decisions and slices nothing, so
``forced`` returns None and ``dibits`` is None.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STATE = ("quad.prev", "deemph.y_last", "deemph.x_last")
CIRCLES: dict = {}   # no angle in the carried state
dibits = None        # no slicer: the chain's answers are audio and power


def f32(v: float) -> float:
    return float(np.float32(v))


class Params:
    """The chain's constants for one configuration at one channel rate."""

    def __init__(self, cfg: dict, channel_fs: float):
        self.gain = f32(channel_fs / (2.0 * math.pi * cfg["max_dev_hz"]))
        w_ca = 2.0 * channel_fs * math.tan(1.0 / (cfg["tau_s"]
                                                  * 2.0 * channel_fs))
        k = -w_ca / (2.0 * channel_fs)
        self.z1 = f32((1.0 + k) / (1.0 - k))
        self.b0 = f32(-k / (1.0 - k))


def sizes(prm: Params) -> dict:
    """No shape beyond the channelizer's that ``work/`` counts need."""
    return {}


def init(lanes: int, prm: Params, dev) -> dict:
    return {"quad.prev": torch.zeros(lanes, dtype=torch.complex128,
                                     device=dev),
            "deemph.y_last": torch.zeros(lanes, dtype=torch.float64,
                                         device=dev),
            "deemph.x_last": torch.zeros(lanes, dtype=torch.float64,
                                         device=dev)}


def discriminator(x: torch.Tensor, prev: torch.Tensor, prm: Params,
                  dtype) -> torch.Tensor:
    """gain · arg(x[n] · conj(x[n-1])) over [L, N] complex samples, in
    ``dtype``."""
    xm1 = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    if dtype == torch.float64:
        d = x.to(torch.complex64) * torch.conj(xm1.to(torch.complex64))
        return prm.gain * torch.atan2(d.imag.to(torch.float64),
                                      d.real.to(torch.float64))
    a, b = x.real.to(dtype), x.imag.to(dtype)
    c, e = xm1.real.to(dtype), (-xm1.imag).to(dtype)
    return prm.gain * torch.atan2(b * c + a * e, a * c - b * e)


def deemphasis(u: torch.Tensor, y0: torch.Tensor, prm: Params
               ) -> torch.Tensor:
    """``y[n] = z1 · y[n-1] + b0 · u[n]`` along each lane of u [L, N] from
    ``y[-1] = y0``, one sample at a time, in u's dtype."""
    out = torch.empty_like(u)
    y = y0.to(u.dtype)
    for n in range(u.shape[1]):
        y = prm.z1 * y + prm.b0 * u[:, n]
        out[:, n] = y
    return out


def track(planes: torch.Tensor, state: dict, prm: Params,
          dtype=torch.float64):
    """One block of the chain on lane-major channel samples ``planes``
    [L, N] (complex) from ``state``. Returns (state after, audio [L, N],
    power [L])."""
    disc = discriminator(planes, state["quad.prev"], prm, dtype)
    dm1 = torch.cat([state["deemph.x_last"].to(dtype)[:, None],
                     disc[:, :-1]], dim=1)
    audio = deemphasis(disc + dm1, state["deemph.y_last"], prm)
    re, im = planes.real.to(dtype), planes.imag.to(dtype)
    power = (re * re + im * im).mean(-1)
    new = {"quad.prev": planes[:, -1].to(torch.complex128),
           "deemph.y_last": audio[:, -1].to(torch.float64),
           "deemph.x_last": disc[:, -1].to(torch.float64)}
    return new, audio, power


def forced(outs: tuple, prm: Params) -> None:
    """The voice chain takes no decision from the program's outputs."""
    return None


def gaps(outs: tuple, audio_ref: torch.Tensor,
         power_ref: torch.Tensor) -> tuple:
    """(max |audio - reference| of each lane [L], |power - reference| /
    reference of each lane [L]) of the program's lane-major outputs
    (audio [L, N], power [L])."""
    audio, power = outs
    da = (audio.to(torch.float64) - audio_ref.to(torch.float64)).abs()
    pr = power_ref.to(torch.float64)
    return da.amax(-1), (power.to(torch.float64) - pr).abs() / pr
