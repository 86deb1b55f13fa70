"""The fused analog voice tracker: discriminator → de-emphasis → squelch
power, for every (source, slot) lane of the bank output.

Replaces the chain after the bank in ``radiocapture_tpu.frontend.
pipeline.AnalogVoicePipeline._step_impl`` (pipeline.py:420-423):
``fm.quadrature_demod``, the ``fm.fm_deemphasis`` ``associative_scan``
and the power meter ``mean(|chan|²)``. The CUDA kernel
(``csrc/fm_voice.cu``) runs one thread per lane and reads the time-major
bank planes once.
"""

from __future__ import annotations

import torch

from radiocapture_tpu_torch.ops import fm as _fm


def voice_track_plain(y_re: torch.Tensor, y_im: torch.Tensor,
                      quad: _fm.QuadDemodState, deemph: _fm.DeemphState,
                      gain: float, samp_rate: float):
    """Plain PyTorch version of the tracker: ``fm.quadrature_demod``,
    then ``fm.fm_deemphasis`` (75 µs at ``samp_rate``), then the power.

    y_re, y_im [S, N, C] float32 bank planes. Returns (quad, deemph,
    audio [S, C, N] float32, power [S, C] float32); the states are new
    tensors."""
    x = torch.complex(y_re, y_im).transpose(1, 2)          # [S, C, N]
    quad, disc = _fm.quadrature_demod(quad, x, gain)
    deemph, audio = _fm.fm_deemphasis(deemph, disc, samp_rate)
    power = torch.mean(x.abs() ** 2, dim=-1)
    return quad, deemph, audio, power


def voice_track(y_re: torch.Tensor, y_im: torch.Tensor,
                quad: _fm.QuadDemodState, deemph: _fm.DeemphState,
                gain: float, samp_rate: float):
    """The fused tracker: ``voice_track_plain`` on CPU tensors, the CUDA
    kernel on CUDA tensors. On CUDA the lane state (``quad.prev``,
    ``deemph.y_last``, ``deemph.x_last``) is updated IN PLACE and the
    same tensors are returned; audio is an [S, C, N] view of a
    time-major [S, N, C] buffer.

    The kernel moves ~246 MB at the bench shape (8192 lanes × 2500
    samples), 0.07 ms at the card's 3.35 TB/s; its serial chain is one
    FMA per sample. With only ~2 warps per SM it hides load latency by
    loading eight samples of both planes ahead of computing them."""
    if y_re.device.type == "cpu":
        return voice_track_plain(y_re, y_im, quad, deemph, gain, samp_rate)
    if y_re.device.type != "cuda":
        raise ValueError(f"voice_track: unsupported device {y_re.device}")
    from radiocapture_tpu_torch import kernels
    s, n, c = y_re.shape
    if n < 1:
        raise ValueError("voice_track: empty block")
    prev = torch.view_as_real(quad.prev)
    for name, t, shape in (
            ("y_re", y_re, (s, n, c)), ("y_im", y_im, (s, n, c)),
            ("quad.prev", prev, (s, c, 2)),
            ("deemph.y_last", deemph.y_last, (s, c)),
            ("deemph.x_last", deemph.x_last, (s, c))):
        if (t.device != y_re.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"voice_track: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on "
                             f"{y_re.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    z1, b0 = _fm.deemph_coefs(samp_rate)
    audio = torch.empty((s, n, c), dtype=torch.float32, device=y_re.device)
    power = torch.empty((s, c), dtype=torch.float32, device=y_re.device)
    err = kernels.load().fm_voice_launch(
        y_re.data_ptr(), y_im.data_ptr(), prev.data_ptr(),
        deemph.y_last.data_ptr(), deemph.x_last.data_ptr(),
        audio.data_ptr(), power.data_ptr(), s, n, c, gain, z1, b0,
        torch.cuda.current_stream(y_re.device).cuda_stream)
    kernels.check(err, "fm_voice")
    voice_track.launches += 1
    return quad, deemph, audio.transpose(1, 2), power


voice_track.launches = 0
