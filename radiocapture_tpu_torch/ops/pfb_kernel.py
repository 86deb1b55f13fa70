"""The pfb frontend's coarse polyphase combiner: plain version and CUDA
wrapper.

``pfb_rows`` (``csrc/pfb_rows.cu``) replaces no Pallas kernel: in the JAX
package XLA fuses ``PfbChannelizer.__call__`` (channelizer.py:276-290:
history ++ block, the window stack, the einsum over P, the flip) under
``jit``. Its plain version, ``pfb_rows_plain``, is the eager chain the
port ran before the kernel: a cat, one multiply and P-1 in-place
``addcmul_`` passes over the shifted row views, a flip. The kernel reads
the wire block and the history where they lie, keeps the P taps' sums in
registers and writes the flipped rows once, bit for bit the plain
version's on the card.
"""

from __future__ import annotations

import torch


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


def pfb_rows_args(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor):
    """Validate the kernel's inputs and allocate its outputs: (the
    arguments of the C entry point ``pfb_rows_launch``, (v, new history)).
    Raises ValueError on what the kernel does not take: another dtype or
    shape, T % M ≠ 0, a non-contiguous or misaligned tensor, tensors on
    different devices, or tensors off the card."""
    if x.dtype == torch.complex64 and x.dim() == 2:
        x = torch.view_as_real(x)
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3
            or x.shape[-1] != 2 or not x.is_contiguous()
            or x.data_ptr() % (2 * x.element_size())):
        raise ValueError(f"pfb_rows: x must be a contiguous [S, T, 2] bf16 "
                         f"or float32 wire block or an [S, T] complex64 "
                         f"block, got {x.dtype} {tuple(x.shape)} "
                         f"(contiguous: {x.is_contiguous()})")
    if (hp2.dtype != torch.float32 or hp2.dim() != 2
            or not hp2.is_contiguous() or hp2.device != x.device):
        raise ValueError(f"pfb_rows: hp2 must be a contiguous [M, P] "
                         f"float32 tensor on {x.device}, got {hp2.dtype} "
                         f"{tuple(hp2.shape)} on {hp2.device}")
    s, t = x.shape[:2]
    m, p = hp2.shape
    if t % m:
        raise ValueError(f"pfb_rows: block {t} is not a multiple of M={m}")
    shape = (s, (p - 1) * m)
    if (history.dtype != torch.complex64 or tuple(history.shape) != shape
            or not history.is_contiguous() or history.device != x.device):
        raise ValueError(f"pfb_rows: history must be a contiguous "
                         f"complex64 tensor of shape {shape} on {x.device}, "
                         f"got {history.dtype} {tuple(history.shape)} on "
                         f"{history.device}")
    if x.device.type != "cuda":
        raise ValueError(f"pfb_rows: the kernel takes CUDA tensors, got "
                         f"{x.device}")
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
