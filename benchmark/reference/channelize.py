"""What the plain reference channelizers share: each kind is a module of
its own, ``reference/chan_<kind>.py``, found by the name a path gives,
whose ``Chan`` turns the wideband block of one step into the per-slot
channel samples and the channelizer's carried state, in float64
(complex128), from the configuration and the benchmark's own wire blocks
alone. A ``Chan`` has ``n_lanes``, ``slot_hz`` and ``channel_fs``
(static: the lanes a source, the wideband offsets of its slots, the
channel rate), ``sizes()`` (the shapes ``work/`` counts need) and
``__call__(prev, x, k, prec)``.

Every filter is designed here from the configuration's rates (the frozen
``taps`` module), the slot offsets and mixer phase steps are worked out
from the slot grid, and the mixer phase of block k is the phase step
times the outputs before it, so nothing depends on the program: no taps,
operands, bins or state of its are read. The state the channelizer
carries into block k (raw wideband history, PFB bins, split halves) is
recomputed from the tail of block k-1.

``prec`` selects the arithmetic: ``None`` is the reference (float64
throughout); ``"control"`` is the control of the correctness check, the
same chain one precision step below what the configuration states:
float8 (e4m3, scaled per tensor) operands in place of the wire banks'
bfloat16, TF32 operands in place of the float32 complex banks, float32
accumulation and complex64 results.
"""

from __future__ import annotations

import math

import numpy as np
import torch


TWO32 = 1 << 32
FP8_MAX = 448.0


def slot_offsets(cfg: dict, samp_rate: float, n_sources: int) -> np.ndarray:
    """Slot centres in cycles per input sample, float32 [S, C]: the
    configuration's grid centred on each source."""
    c = cfg["slots"]
    offs = ((np.arange(c) - c // 2) * cfg["slot_grid_hz"] / samp_rate
            ).astype(np.float32)
    return np.tile(offs, (n_sources, 1))


def phase_step(offsets: np.ndarray, decim: int) -> np.ndarray:
    """The uint32 mixer step a decimated output, ``(-f·D mod 1)·2^32`` in
    float32 arithmetic, truncated and held in [0, 2^32) (int64)."""
    v = np.remainder(-np.asarray(offsets, np.float32) * np.float32(decim),
                     np.float32(1.0)).astype(np.float32)
    return np.clip((v.astype(np.float64) * 4294967296.0).astype(np.int64),
                   0, TWO32 - 1)


def phase_at(step: np.ndarray, outputs_before: int) -> np.ndarray:
    """The mixer phase after ``outputs_before`` outputs, mod 2^32."""
    return np.array([[(int(s) * outputs_before) % TWO32 for s in row]
                     for row in np.atleast_2d(step)], np.int64
                    ).reshape(np.shape(step))


def padded(h: np.ndarray, d: int) -> np.ndarray:
    pad = (-len(h)) % d
    return np.concatenate([h, np.zeros(pad, h.dtype)]) if pad else h


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 values through float8 e4m3, scaled so the largest magnitude
    sits at the format's largest finite value."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def rounded(z: torch.Tensor, kind: str) -> torch.Tensor:
    """complex ``z`` with its real and imaginary parts rounded by
    ``kind`` (``tf32`` or ``fp8``), as complex64."""
    r = torch.view_as_real(z.to(torch.complex64)).contiguous()
    r = round_tf32(r) if kind == "tf32" else round_fp8(r)
    return torch.view_as_complex(r.contiguous())


def modulated(h: np.ndarray, offs: torch.Tensor) -> torch.Tensor:
    """Correlation-reversed modulated taps ``grev[r, c, j] = h[K-1-j] ·
    e^{j2πf(K-1-j)}`` [R, C, K] complex128, with exact angles."""
    dev = offs.device
    k = torch.arange(len(h), dtype=torch.float64, device=dev)
    hh = torch.as_tensor(np.asarray(h, np.float64), device=dev)
    ang = 2.0 * math.pi * offs.to(torch.float64)[..., None] * k
    return torch.polar(hh.expand_as(ang).contiguous(), ang).flip(-1)


def ramp(phase0: np.ndarray, step: np.ndarray, n: int, dev) -> torch.Tensor:
    """``e^{iθ}`` of the uint32 phase ramp, [R, C, n] complex128."""
    p0 = torch.as_tensor(phase0, device=dev)[..., None]
    st = torch.as_tensor(step, device=dev)[..., None]
    u = (p0 + st * torch.arange(n, device=dev)) % TWO32
    ang = u.to(torch.float64) * (2.0 * math.pi / TWO32)
    return torch.polar(torch.ones_like(ang), ang)


def bank(z: torch.Tensor, grev: torch.Tensor, d: int, n: int,
         prec: str | None = None, chunk_bytes: float = 1.0e9
         ) -> torch.Tensor:
    """``y[r, c, m] = Σ_j grev[r, c, j] · z[r, m·D + j]`` for m < n, the
    decimating correlation of each row of z [R, L] with its slots' taps
    grev [R, C, K], before the mixer rotation. Polyphase: z as frames of
    D samples, one batched product a tap frame. With ``prec`` (``fp8`` or
    ``tf32``) z and grev are rounded to it first and the sums are taken
    in complex64."""
    r, length = z.shape
    c, k = grev.shape[1:]
    p = -(-k // d)
    if prec is None:
        z, grev = z.to(torch.complex128), grev.to(torch.complex128)
    else:
        z, grev = rounded(z, prec), rounded(grev, prec)
    g = torch.nn.functional.pad(grev, (0, p * d - k))
    g = g.reshape(r, c, p, d)
    need = (n + p) * d
    if length < need:
        z = torch.nn.functional.pad(z, (0, need - length))
    frames = z[:, :need].reshape(r, n + p, d)
    rows = max(1, int(chunk_bytes // (n * d * z.element_size() * 4)))
    out = []
    for r0 in range(0, r, rows):
        fr, gr = frames[r0:r0 + rows], g[r0:r0 + rows]
        acc = None
        for q in range(p):
            t = torch.matmul(gr[:, :, q], fr[:, q:q + n].transpose(1, 2))
            acc = t if acc is None else acc + t
        out.append(acc)
    return torch.cat(out)


def wire_complex(x: torch.Tensor) -> torch.Tensor:
    """[S, T, 2] wire block → [S, T] complex128 (bf16 and float32 are
    exact in float64)."""
    return torch.view_as_complex(x.to(torch.float64).contiguous())


def tail(prev: torch.Tensor | None, like: torch.Tensor, n: int
         ) -> torch.Tensor:
    """The last ``n`` samples of the previous block, zeros before the
    first block (the program's initial state)."""
    if prev is None:
        return torch.zeros(like.shape[0], n, dtype=like.dtype,
                           device=like.device)
    return prev[:, prev.shape[1] - n:]


def grid_hz(cfg: dict) -> np.ndarray:
    """The slot grid's offsets from a source's centre, Hz."""
    c = cfg["slots"]
    return (np.arange(c) - c // 2) * cfg["slot_grid_hz"]


def lanes(y: torch.Tensor) -> torch.Tensor:
    """[S, C, N] → lane-major [S·C, N]."""
    return y.reshape(-1, y.shape[-1])
