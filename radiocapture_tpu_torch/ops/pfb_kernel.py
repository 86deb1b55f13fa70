"""The pfb frontend's coarse polyphase channelizer: plain versions and
CUDA wrappers of the two entry points of ``csrc/pfb_rows.cu``.

``pfb_rows`` replaces no Pallas kernel: in the JAX package XLA fuses
``PfbChannelizer.__call__`` (channelizer.py:276-290: history ++ block, the
window stack, the einsum over P, the flip) under ``jit``. Its plain
version, ``pfb_rows_plain``, is the eager chain the port ran before the
kernel: a cat, one multiply and P-1 in-place ``addcmul_`` passes over the
shifted row views, a flip. The kernel reads the wire block and the
history where they lie, keeps the P taps' sums in registers and writes
the flipped rows once, bit for bit the plain version's on the card.

``pfb_bins`` is the whole ``__call__`` (channelizer.py:276-295: the
combiner, the M-point IDFT, the channel rotation, the bins bin-major) in
one launch: the same staging and sums, then each row's channels through
one folded [M, M] table (``bins_table``). Its plain version,
``pfb_bins_plain``, is the chain the pfb step ran before it:
``pfb_rows_plain``, ``torch.fft.ifft``, the rotation, bin-major.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# csrc/pfb_rows.cu's constants that pfb_bins' plan depends on
MB_MAX = 16          # pfb_rows' branches a block, pfb_bins' warps a slab
WARPS_MAX = 8        # warps a block aims for
WIRE_K = {True: 11, False: 7}   # rows a lane, by bf16 wire
K_SMALL = 3          # rows a lane where the wire's K does not fit
CB = 8               # channels a thread sums at once
SMEM_MAX = 232448    # shared memory a block can use on the H100
# pfb_bins against pfb_bins_plain on the card, × max|bins|: the IDFT's sum
# order is not cuFFT's and the rotation is folded into its table (at most
# 6.0e-7 measured, at M = 100, on an H100 80GB HBM3 at 700 W)
BINS_REL = 2e-6


def pfb_rows_plain(history: torch.Tensor, x: torch.Tensor,
                   hp2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the combiner.

    history [S, (P-1)·M] complex64; x [S, T] complex or an [S, T, 2]
    bf16/float32 wire block (bf16 → float32 is exact), T % M == 0; hp2
    [M, P] float32, the reversed-row polyphase taps. Returns (v [S, T/M,
    M] complex64 with v[s, t, m] = v'[t, M-1-m], v'[t, m'] = Σ_q hp2[m', q]
    · zr[t + P-1-q, m'] over the rows zr of M samples of history ++ x; the
    new history, the last (P-1)·M samples of history ++ x).

    The P shifted row views are accumulated in float32, one in-place
    multiply-add each; the [N, P, M] window stack the JAX einsum reads is
    never built (at 128 sources × 100 ms of 2.4 MS/s it would be 5.9 GB)."""
    m, p = hp2.shape
    s = history.shape[0]
    if x.is_complex():
        xc = x.to(torch.complex64)
    else:
        xc = torch.view_as_complex(x.to(torch.float32).contiguous())
    n = xc.shape[1] // m
    z = torch.cat([history, xc], dim=1)
    zr = torch.view_as_real(z).view(s, n + p - 1, m, 2)
    h = hp2[..., None]
    acc = zr[:, p - 1:p - 1 + n] * h[:, 0]
    for q in range(1, p):
        acc.addcmul_(zr[:, p - 1 - q:p - 1 - q + n], h[:, q])
    v = torch.view_as_complex(acc.contiguous()).flip(-1)  # undo the flip
    return v, z[:, z.shape[1] - (p - 1) * m:].contiguous()


def _rotation_angles(m: int) -> np.ndarray:
    """The rotation's angles 2πc/M [M] in float64, taken in float32 as the
    JAX ``PfbChannelizer`` takes them (channelizer.py:293-294)."""
    return (np.float32(2.0 * np.pi / m)
            * np.arange(m, dtype=np.float32)).astype(np.float64)


def rotation(m: int) -> np.ndarray:
    """The per-channel rotation e^{j2πc/M} [M] complex64 from the K-1 group
    delay, exponentiated in float64 at ``_rotation_angles``."""
    return np.exp(1j * _rotation_angles(m)).astype(np.complex64)


def bins_table(m: int) -> np.ndarray:
    """``pfb_bins``' folded table W [M, M] complex64: W[c, m'] =
    e^{+j2π((c·(M-1-m')) mod M)/M} · rot[c], the flip, the IDFT twiddle
    and the rotation (``rotation``'s float32 angles) in float64, rounded
    once, so bins[s, c, t] = Σ_m' v'[t, m'] · W[c, m'] over the unflipped
    branch sums v'."""
    c = np.arange(m)[:, None]
    k = (c * (m - 1 - np.arange(m))[None, :]) % m
    w = np.exp(2j * np.pi * k / m) * np.exp(1j * _rotation_angles(m))[:, None]
    return w.astype(np.complex64)


def pfb_bins_plain(history: torch.Tensor, x: torch.Tensor,
                   hp2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pfb_bins``: ``pfb_rows_plain``, the
    M-point inverse FFT of each row (``norm="forward"``, as the JAX
    ``ifft · M``), the rotation, time-major, then copied bin-major.
    Returns (bins [S, M, T/M] complex64, contiguous; the new history)."""
    v, hist = pfb_rows_plain(history, x, hp2)
    f = torch.fft.ifft(v, dim=-1, norm="forward")
    rot = torch.as_tensor(rotation(hp2.shape[0]), device=f.device)
    return (f * rot).transpose(1, 2).contiguous(), hist


def _check(name: str, history: torch.Tensor, x: torch.Tensor,
           hp2: torch.Tensor) -> torch.Tensor:
    """Both entries' validation; returns x as an [S, T, 2] real view."""
    if x.dtype == torch.complex64 and x.dim() == 2:
        x = torch.view_as_real(x)
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3
            or x.shape[-1] != 2 or not x.is_contiguous()
            or x.data_ptr() % (2 * x.element_size())):
        raise ValueError(f"{name}: x must be a contiguous [S, T, 2] bf16 "
                         f"or float32 wire block or an [S, T] complex64 "
                         f"block, got {x.dtype} {tuple(x.shape)} "
                         f"(contiguous: {x.is_contiguous()})")
    if (hp2.dtype != torch.float32 or hp2.dim() != 2
            or not hp2.is_contiguous() or hp2.device != x.device):
        raise ValueError(f"{name}: hp2 must be a contiguous [M, P] "
                         f"float32 tensor on {x.device}, got {hp2.dtype} "
                         f"{tuple(hp2.shape)} on {hp2.device}")
    s, t = x.shape[:2]
    m, p = hp2.shape
    if t % m:
        raise ValueError(f"{name}: block {t} is not a multiple of M={m}")
    shape = (s, (p - 1) * m)
    if (history.dtype != torch.complex64 or tuple(history.shape) != shape
            or not history.is_contiguous() or history.device != x.device):
        raise ValueError(f"{name}: history must be a contiguous "
                         f"complex64 tensor of shape {shape} on {x.device}, "
                         f"got {history.dtype} {tuple(history.shape)} on "
                         f"{history.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    return x


def pfb_rows_args(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor):
    """Validate the kernel's inputs and allocate its outputs: (the
    arguments of the C entry point ``pfb_rows_launch``, (v, new history)).
    Raises ValueError on what the kernel does not take: another dtype or
    shape, T % M ≠ 0, a non-contiguous or misaligned tensor, tensors on
    different devices, or tensors off the card."""
    x = _check("pfb_rows", history, x, hp2)
    s, t = x.shape[:2]
    m, p = hp2.shape
    shape = (s, (p - 1) * m)
    v = torch.empty((s, t // m, m), dtype=torch.complex64, device=x.device)
    hist = torch.empty(shape, dtype=torch.complex64, device=x.device)
    args = (history.data_ptr(), x.data_ptr(), hp2.data_ptr(), v.data_ptr(),
            hist.data_ptr(), s, t, m, p, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    return args, (v, hist)


def pfb_rows(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The combiner on one block: ``pfb_rows_plain`` on CPU tensors, one
    launch of the CUDA kernel ``csrc/pfb_rows.cu`` on CUDA tensors, which
    reads x (an [S, T, 2] bf16/float32 wire block, or an [S, T] complex64
    block as its float32 view) and the history in place; what it does not
    take raises (``pfb_rows_args``). Returns (v [S, T/M, M] complex64, a
    new [S, (P-1)·M] history).

    Bound by bytes: the block read once, the rows written once (0.110 ms
    at 3.35 TB/s for 128 sources × 240000 bf16 samples, M = 6, P = 24)."""
    if x.device.type == "cpu":
        return pfb_rows_plain(history, x, hp2)
    from radiocapture_tpu_torch import kernels
    args, outs = pfb_rows_args(history, x, hp2)
    kernels.check(kernels.load().pfb_rows_launch(*args), "pfb_rows")
    pfb_rows.launches += 1
    return outs


pfb_rows.launches = 0


def bins_plan(m: int, p: int, bf16: bool) -> tuple[int, int, int, int]:
    """``pfb_bins``' launch plan for M branches and P taps: (k rows a lane,
    wb warps a slab over the branches, slabs, shared memory bytes a block).
    A block holds every branch of its 32·k·slabs rows: ⌈M/16⌉ rounds of
    wb = ⌈M/rounds⌉ warps, slabs as ``pfb_rows`` takes them; k is the
    wire's K unless the planes, the padded table and the taps pass the
    shared memory a block can use, then K_SMALL. Raises ValueError for an
    M whose planes pass it even then (M > 115 at P = 24)."""
    rounds = -(-m // MB_MAX)
    wb = -(-m // rounds)
    slabs = 1 if wb >= WARPS_MAX else WARPS_MAX // wb
    cpad = -(-m // CB) * CB
    for k in (WIRE_K[bf16], K_SMALL):
        shared = 8 * m * (cpad + slabs * 32 * k + p - 1) + 4 * m * p
        if shared <= SMEM_MAX:
            return k, wb, slabs, shared
    raise ValueError(f"pfb_bins: M={m}, P={p} needs {shared} bytes of "
                     f"shared memory a block, more than {SMEM_MAX}")


@functools.cache
def device_table(m: int, device: torch.device) -> torch.Tensor:
    """``bins_table(m)`` on ``device``, copied there once (a copy from
    pageable host memory would synchronize the stream every step); the
    kernel only reads it."""
    return torch.as_tensor(bins_table(m), device=device)


def pfb_bins_args(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor):
    """Validate ``pfb_bins``' inputs as ``pfb_rows_args`` does, plan the
    launch (``bins_plan``; an M it cannot hold raises ValueError) and
    allocate the outputs: (the arguments of ``pfb_bins_launch``, (bins
    [S, M, T/M], new history))."""
    x = _check("pfb_bins", history, x, hp2)
    s, t = x.shape[:2]
    m, p = hp2.shape
    bf16 = x.dtype == torch.bfloat16
    k, wb, slabs, _ = bins_plan(m, p, bf16)
    table = device_table(m, x.device)
    bins = torch.empty((s, m, t // m), dtype=torch.complex64,
                       device=x.device)
    hist = torch.empty((s, (p - 1) * m), dtype=torch.complex64,
                       device=x.device)
    args = (history.data_ptr(), x.data_ptr(), hp2.data_ptr(),
            table.data_ptr(), bins.data_ptr(), hist.data_ptr(), s, t, m, p,
            int(bf16), k, wb, slabs,
            torch.cuda.current_stream(x.device).cuda_stream)
    return args, (bins, hist)


def pfb_bins(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The coarse PFB on one block, bin-major: ``pfb_bins_plain`` on CPU
    tensors, one launch of ``csrc/pfb_rows.cu``'s ``pfb_bins`` kernel on
    CUDA tensors (the combiner's staging and sums, then the IDFT and the
    rotation through ``bins_table``), which reads x and the history in
    place; what it does not take raises (``pfb_bins_args``). Returns
    (bins [S, M, T/M] complex64, a new [S, (P-1)·M] history), the
    history bit for bit ``pfb_rows``', the bins within a few float32 ulps
    of max|bins| of the plain version's (another sum order than cuFFT's).

    Bound by bytes, as ``pfb_rows``: 0.110 ms at the bench shape on bf16
    (the IDFT counted at an FFT's 5·M·log2 M FLOP a row); the kernel's
    direct IDFT does 8·M² FLOP a row, which keeps it off that bound from
    M ~ 20."""
    if x.device.type == "cpu":
        return pfb_bins_plain(history, x, hp2)
    from radiocapture_tpu_torch import kernels
    args, outs = pfb_bins_args(history, x, hp2)
    kernels.check(kernels.load().pfb_bins_launch(*args), "pfb_bins")
    pfb_bins.launches += 1
    return outs


pfb_bins.launches = 0
