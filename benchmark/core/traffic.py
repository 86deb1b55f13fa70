"""The one traffic generator: a ring of distinct wire blocks made on the
device from the seed, as the traffic file and the configuration set it.

Each source carries seeded complex noise and ``channels_per_source``
synthesized control channels of the configuration's modulation (the
frozen modulator ``reference/mod_<modulation>.py``), each on
a slot drawn from the seed. One baseband channel of seeded random
dibits is modulated on the host (the frozen modulators), copied to the
device once, and placed on every source by a circular shift and a
frequency shift drawn from the seed, so no per-source host work or
upload is needed. The composite is quantized to the source's ADC
(``adc_bits``, two's-complement levels (k + 1/2) / 2^(b-1)) and rounded
to the wire's dtype. Every seed gets the same sizes: only the content
moves with the seed.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from benchmark.reference import modulators as _mod

BASEBAND_RATE = 25000.0
WIRE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def block_len(traffic: dict, multiple: int) -> int:
    t = int(round(traffic["samp_rate"] * traffic["block_s"]))
    if t % multiple:
        raise ValueError(f"block of {t} samples is not a multiple of "
                         f"{multiple}")
    return t


def baseband(cfg: dict, n: int, samp_rate: float,
             rng: np.random.Generator) -> np.ndarray:
    """``n`` samples of one control channel at ``samp_rate``, complex64."""
    seconds = n / samp_rate
    n_sym = int(math.ceil(seconds * cfg["symbol_rate"])) + 16
    dibits = rng.integers(0, 4, n_sym)
    modulate = importlib.import_module(
        f"benchmark.reference.mod_{cfg['modulation']}").modulate
    bb = modulate(dibits, fs=BASEBAND_RATE, symbol_rate=cfg["symbol_rate"])
    up = _mod.upsample_to(bb, BASEBAND_RATE, samp_rate)
    if len(up) < n:
        up = np.concatenate([up, np.zeros(n - len(up), np.complex64)])
    return up[:n]


def make_ring(cfg: dict, traffic: dict, seed: int, dev, block: int,
              slot_hz: np.ndarray, chunk: int = 8
              ) -> tuple[torch.Tensor, np.ndarray]:
    """The ring [R, S, T, 2] of wire blocks (R = ``ring_blocks``, T =
    ``block`` samples) and the lanes that carry a channel, sorted;
    ``slot_hz`` lists the wideband offsets of the slots a channel may sit
    on, in the order of a source's lanes (lane = source · len(slot_hz) +
    slot)."""
    sig = traffic["signal"]
    s = traffic["sources"]
    r = traffic["ring_blocks"]
    fs = traffic["samp_rate"]
    length = r * block
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bb = torch.as_tensor(baseband(cfg, length, fs, rng), device=dev)
    n_ch = sig["channels_per_source"]
    slots = np.stack([rng.choice(len(slot_hz), n_ch, replace=False)
                      for _ in range(s)])
    shifts = rng.integers(0, length, (s, n_ch))
    phases = rng.uniform(0.0, 2.0 * math.pi, (s, n_ch))
    q = float(1 << (sig["adc_bits"] - 1))
    wire = WIRE[traffic["wire"]]
    ring = torch.empty((r, s, block, 2), dtype=wire, device=dev)
    n = torch.arange(length, device=dev, dtype=torch.float64)
    idx = torch.arange(length, device=dev)
    for s0 in range(0, s, chunk):
        s1 = min(s, s0 + chunk)
        x = torch.randn((s1 - s0, length, 2), generator=gen, device=dev,
                        dtype=torch.float32) * sig["noise_rms"]
        xc = torch.view_as_complex(x)
        for i in range(s1 - s0):
            for j in range(n_ch):
                f = float(slot_hz[slots[s0 + i, j]]) / fs
                ang = torch.remainder(2.0 * math.pi * f * n
                                      + phases[s0 + i, j], 2.0 * math.pi)
                rot = torch.polar(torch.ones_like(ang), ang)
                src = bb[(idx + int(shifts[s0 + i, j])) % length]
                xc[i] += (sig["amplitude"] * src * rot).to(torch.complex64)
        x = torch.clamp(torch.floor(x * q) + 0.5, -q + 0.5, q - 0.5) / q
        ring[:, s0:s1] = x.view(s1 - s0, r, block, 2).transpose(0, 1).to(wire)
    lanes = (np.arange(s)[:, None] * len(slot_hz) + slots).ravel()
    return ring, np.sort(lanes)
