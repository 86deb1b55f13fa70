"""The analog voice kernel's plan (``csrc/fm_voice.cu``), emulated on the
CPU against the plain tracker and the JAX reference: 32-slot tiles of one
source with the lanes past C masked, time tiles of WARPS chunks of CHUNK
samples, each chunk's discriminator value before its first sample taken
from the two samples before it (or from the lane state at n = 0), a local
IIR per chunk from a zero start, the chunks joined through ``z1^CHUNK``
from the tile's carried output, a partial last tile, and the power as
each chunk's float sum of |x|² added to a double. The CUDA kernel
cannot run here; this holds the index arithmetic it shares with the
emulation, at the constants ``ops/fm_kernel.py`` launches it with, to
``voice_track_plain`` and through it to JAX ``quadrature_demod`` →
``fm_deemphasis`` → ``mean(|x|²)`` on the CPU."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops import fm as JFM
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.ops import fm
from radiocapture_tpu_torch.ops import fm_kernel as fk

torch.set_num_threads(1)   # six test workers share the machine

TILE, CHUNK, WARPS = fk.TILE, fk.CHUNK, fk.WARPS
SPAN = CHUNK * WARPS
FS = 25000.0
GAIN = FS / (2 * np.pi * 5000.0)
# The IIR in another association order (tests/test_torch_voice.py's
# IIR_TOL), × max|audio|; power: float32 mean against a double sum.
IIR_TOL = 1e-5
POWER_REL = 1e-5


def _disc(are, aim, pr, pi):
    """gain · arg(x · conj(prev)) on [TILE] rows."""
    prod = torch.complex(are, aim) * torch.conj(torch.complex(pr, pi))
    return GAIN * torch.atan2(prod.imag, prod.real)


def _tiled(y_re, y_im, quad, deemph):
    """The kernel's plan, one block after another; returns what
    ``voice_track_plain`` returns, and how often each audio sample was
    written."""
    s_n, n, c_n = y_re.shape
    z1, b0 = fm.deemph_coefs(FS)
    zp = [float(np.float32(np.float64(z1) ** (k + 1))) for k in range(CHUNK)]
    a = zp[CHUNK - 1]
    audio = torch.zeros((s_n, c_n, n))
    writes = torch.zeros((s_n, c_n, n), dtype=torch.int64)
    power = torch.zeros((s_n, c_n))
    prev = quad.prev.clone()
    y_last, x_last = deemph.y_last.clone(), deemph.x_last.clone()
    tiles = -(-c_n // TILE)
    zero = torch.zeros(TILE)
    for blk in range(s_n * tiles):
        s = blk // tiles
        c = (blk % tiles) * TILE + torch.arange(TILE)
        active = c < c_n
        cc = c.clamp(max=c_n - 1)

        def load(k):
            if not 0 <= k < n:
                return zero, zero
            return (torch.where(active, y_re[s, k, cc], zero),
                    torch.where(active, y_im[s, k, cc], zero))

        pr0 = torch.where(active, prev[s, cc].real, zero)
        pi0 = torch.where(active, prev[s, cc].imag, zero)
        carry = torch.where(active, y_last[s, cc], zero)
        xl0 = torch.where(active, x_last[s, cc], zero)
        acc = torch.zeros((WARPS, TILE), dtype=torch.float64)
        for t in range(-(-n // SPAN)):
            ends, chunks = torch.zeros((WARPS, TILE)), []
            for w in range(WARPS):             # before the barrier
                n0 = t * SPAN + w * CHUNK
                ar, ai = zip(*(load(k) for k in range(n0 - 2, n0 + CHUNK)))
                ar, ai = list(ar), list(ai)
                if n0 == 0:
                    ar[1], ai[1] = pr0, pi0
                dprev = xl0 if n0 == 0 else _disc(ar[1], ai[1], ar[0], ai[0])
                vk, v, pw = zero, [], zero
                for j in range(CHUNK):
                    d = _disc(ar[j + 2], ai[j + 2], ar[j + 1], ai[j + 1])
                    vk = z1 * vk + b0 * (d + dprev)
                    v.append(vk)
                    dprev = d
                    pw = ar[j + 2] * ar[j + 2] + (ai[j + 2] * ai[j + 2] + pw)
                    if n0 + j == n - 1:
                        last = (ar[j + 2], ai[j + 2], d)
                acc[w] += pw.double()          # the chunk's float sum
                ends[w] = vk
                chunks.append(v)
            next_carry = carry
            for w in range(WARPS):             # after it
                n0 = t * SPAN + w * CHUNK
                yin = carry
                for w2 in range(w):
                    yin = a * yin + ends[w2]
                for j in range(CHUNK):
                    if n0 + j >= n:
                        break
                    y = zp[j] * yin + chunks[w][j]
                    audio[s, c[active], n0 + j] = y[active]
                    writes[s, c[active], n0 + j] += 1
                    if n0 + j == n - 1:
                        last_y = y
            for w in range(WARPS):
                next_carry = a * next_carry + ends[w]
            carry = next_carry
        power[s, c[active]] = (acc.sum(0) / n).float()[active]
        prev[s, c[active]] = torch.complex(last[0], last[1])[active]
        x_last[s, c[active]] = last[2][active]
        y_last[s, c[active]] = last_y[active]
    return ((fm.QuadDemodState(prev), fm.DeemphState(y_last, x_last),
             audio, power), writes)


def _planes(rng, s, n, c):
    """[S, N, C] float32 planes: an FM tone on every lane (2.5 kHz
    deviation at 25 kS/s, far from the atan2 branch cut) under -30 dB
    noise."""
    t = np.arange(n)[None, :, None] / FS
    f = rng.uniform(300.0, 3000.0, (s, 1, c))
    tone = 0.8 * np.sin(2 * np.pi * f * t)
    noise = rng.standard_normal((s, n, c)) + 1j * rng.standard_normal(
        (s, n, c))
    x = (np.exp(2j * np.pi * 0.1 * np.cumsum(tone, 1))
         + 0.03 * noise).astype(np.complex64)
    return x


@pytest.mark.parametrize("s,n,c", [(1, 2500, 64), (3, 1001, 40),
                                   (2, 37, 5), (2, 9, 33), (1, 512, 32)])
def test_voice_tile_plan_matches_plain_and_jax(s, n, c):
    """Two blocks in a row from a mid-stream start: every audio sample
    written once; audio and ``y_last`` within IIR_TOL·max|audio| of the
    plain tracker and of JAX, power within POWER_REL, ``prev`` identical
    and ``x_last`` within float32 rounding of the plain version's. Lanes
    off the tile (5, 33, 40), N off the 256-sample time tile (2500, 1001),
    within one (37), shorter than one 16-sample chunk (9) and a whole
    number of time tiles (512)."""
    rng = np.random.default_rng(n + c)
    x = _planes(rng, s, 40 + 2 * n, c)
    head = torch.from_numpy(x[:, :40])
    st0 = fk.voice_track_plain(head.real.contiguous(),
                               head.imag.contiguous(),
                               fm.quad_demod_init((s, c)),
                               fm.deemph_init((s, c)), GAIN, FS)[:2]
    st = [st0, st0]
    jq = JFM.QuadDemodState(prev=jnp.asarray(st0[0].prev.numpy()))
    jd = JFM.DeemphState(*(jnp.asarray(t.numpy()) for t in st0[1]))
    for b in range(2):
        blk = x[:, 40 + b * n:40 + (b + 1) * n]
        y_re = torch.from_numpy(blk.real.copy())
        y_im = torch.from_numpy(blk.imag.copy())
        got, writes = _tiled(y_re, y_im, *st[0])
        want = fk.voice_track_plain(y_re, y_im, *st[1], GAIN, FS)
        st = [got[:2], want[:2]]
        xj = jnp.asarray(blk.transpose(0, 2, 1))
        jq, disc = JFM.quadrature_demod(jq, xj, GAIN)
        jd, jaudio = JFM.fm_deemphasis(jd, disc, FS)
        assert bool((writes == 1).all())
        scale = float(want[2].abs().max())
        for ref in (want[2].numpy(), np.asarray(jaudio)):
            np.testing.assert_allclose(got[2].numpy(), ref, rtol=0,
                                       atol=IIR_TOL * scale)
        np.testing.assert_allclose(got[3].numpy(), want[3].numpy(),
                                   rtol=POWER_REL)
        np.testing.assert_allclose(
            got[3].numpy(), np.asarray(jnp.mean(jnp.abs(xj) ** 2, axis=-1)),
            rtol=POWER_REL)
        assert torch.equal(got[0].prev, want[0].prev)
        np.testing.assert_allclose(got[1].x_last.numpy(),
                                   want[1].x_last.numpy(), rtol=1e-6,
                                   atol=1e-6)
        for y_last in (want[1].y_last.numpy(), np.asarray(jd.y_last)):
            np.testing.assert_allclose(got[1].y_last.numpy(), y_last,
                                       rtol=0, atol=IIR_TOL * scale)


def test_plan_constants_are_the_kernels(monkeypatch):
    """The emulated plan's constants are the ones the kernel is built
    with (``csrc/fm_voice.cu``) and the ones ``kernel_args`` hands its
    launcher, which refuses any other plan."""
    src = (kernels.CSRC / "fm_voice.cu").read_text()
    built = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
             for name in ("TILE", "CHUNK", "WARPS")}
    assert built == {"TILE": TILE, "CHUNK": CHUNK, "WARPS": WARPS}
    assert "if (chunk != CHUNK || warps != WARPS)" in src
    # kernel_args launches nothing; its one CUDA call is the stream
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    y = torch.zeros((1, 4, 2))
    args, (audio, power) = fk.kernel_args(
        y, y, fm.quad_demod_init((1, 2)), fm.deemph_init((1, 2)), GAIN, FS)
    assert len(args) == len(kernels._SIGNATURES["fm_voice_launch"])
    assert args[7:10] == (1, 4, 2) and args[13:15] == (CHUNK, WARPS)
    assert audio.shape == (1, 4, 2) and power.shape == (1, 2)
    with pytest.raises(ValueError, match="empty block"):
        fk.kernel_args(y[:, :0], y[:, :0], fm.quad_demod_init((1, 2)),
                       fm.deemph_init((1, 2)), GAIN, FS)


@pytest.mark.parametrize("spec", ["12,16,2", "8,32,1,probe"])
def test_variant_builds_change_only_the_plan(spec):
    """``tools/voice_variants.py`` rewrites the kernel's plan constants,
    its blocks-per-SM bound and, for a probe, the discriminator's atan2f:
    each target is present in the source, so no variant silently times
    the package's plan."""
    from radiocapture_tpu_torch.tools import voice_variants as vv
    v = vv.parse(spec)
    src = (kernels.CSRC / "fm_voice.cu").read_text()
    out = vv.variant_source(src, v)
    assert f"constexpr int CHUNK = {v[0]};" in out
    assert f"constexpr int WARPS = {v[1]};" in out
    assert f"__launch_bounds__(THREADS, {v[2]})" in out
    assert ("atan2f(dim, dre)" not in out) == ("probe" in v)
    assert "atan2f(dim, dre)" in src
