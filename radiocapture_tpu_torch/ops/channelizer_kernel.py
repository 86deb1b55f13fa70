"""The channelizer banks' kernels: tap matrices, plain references, CUDA
wrappers.

**The fused wire bank** (``bank_fused``, ``csrc/xlat_bank.cu``) replaces
``radiocapture_tpu.ops.pallas_channelizer.bank_fused_pallas`` (with
``_fused_kernel``, ``fused_tap_matrix`` and ``fused_rotation_tables``).
Per source ``s`` the bank is one real GEMM

    acc[s, n, :] = z2[s][n·2D : n·2D + P·2D] · g2[s]      [N, 2C]

where ``z2[s]`` is the flat re/im-interleaved row buffer (history ++
block) and ``g2[s]`` the ``[P·2D, 2C]`` interleaved-row tap matrix that
absorbs the complex multiply, followed by the exact uint32 mixer
rotation ``y = (acc_re + i·acc_im) · e^{iθ}``,
``θ = u32_to_angle(phase0 + step·n mod 2^32)``.
Outputs are time-major ``[S, N, C]`` float32 planes: the layout the
tracker kernels read with coalesced loads, so the TPU kernel's transpose
pass is gone. The window matrix is never materialized: chunk q of window
row n is row n+q of z2 viewed as rows of 2D values (``kernel_rows``), so
the kernel reads each operand tile as a plain box of that matrix.

**The bank's operands** (``bank_operands``, ``csrc/bank_operands.cu``)
replace no Pallas kernel: in the JAX package XLA fuses the operand build
of ``XlatBank.call_wire`` (channelizer.py:200-224) under ``jit``. One
launch writes z2 (history ++ block ++ one zero sample, bf16), the
modulated taps in the bank kernel's slot-group layout and the phase
step, bit for bit ``bank_operands_plain``, the eager build.

**The complex bank** (``bank_complex``, ``csrc/xlat_complex.cu``)
replaces ``bank_matmul_pallas`` (with ``_bank_kernel``) and the rotation
after it in ``XlatBank.__call__``: the same correlation on history ++
block, in float32 throughout, with outputs ``[S, C, N]`` complex64. The
kernel reads the wire block (bf16 or float32) and the complex64 history
where they lie.
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.ops.fir import U32_MASK, phase_step_u32, rotate


def _reversed_taps(taps: np.ndarray | torch.Tensor,
                   offsets_norm: torch.Tensor, p: int, d: int
                   ) -> torch.Tensor:
    """Per-slot modulated taps in correlation order,
    ``g[s, c, k] = h[K-1-k]·e^{j2πf(K-1-k)}``: [S, C, K] complex64.

    The phasor is factorized e^{j2πf(qD+j)} = e^{j2πf·qD}·e^{j2πf·j}
    (``XlatBank.call_wire`` in the JAX package): C·(P+D) sin/cos pairs
    instead of C·K."""
    dev = offsets_norm.device
    off = offsets_norm.to(torch.float32)
    s, c = off.shape
    two_pi = float(np.float32(2.0 * np.pi))
    # tap K-1-k = (P-1-q)·D + (D-1-j) for k = q·D + j: the reversed index
    # ramps give the reversed taps without a flip pass
    qd = torch.arange(p - 1, -1, -1, dtype=torch.float32, device=dev) * d
    jj = torch.arange(d - 1, -1, -1, dtype=torch.float32, device=dev)
    ac = two_pi * off[..., None] * qd                      # [S, C, P]
    af = two_pi * off[..., None] * jj                      # [S, C, D]
    ph = (torch.complex(torch.cos(ac), torch.sin(ac))[..., :, None]
          * torch.complex(torch.cos(af), torch.sin(af))[..., None, :])
    h = torch.as_tensor(taps, dtype=torch.float32, device=dev).flip(0)
    return (h.reshape(p, d) * ph).reshape(s, c, p * d)


def tap_matrix(taps: np.ndarray | torch.Tensor, offsets_norm: torch.Tensor,
               p: int, d: int, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Per-source modulated, correlation-reversed, interleaved tap matrix,
    the layout the plain version reads.

    ``taps`` [P·D] real (``XlatBank.device_taps`` passes them already on
    the device); ``offsets_norm`` [S, C] cycles/sample.
    Returns ``g2`` [S, P·2D, 2C] of ``dtype`` with, for reversed tap k,
    row 2k = [g_re | g_im] and row 2k+1 = [-g_im | g_re]. The phasor is
    computed in float32 and rounded once to ``dtype`` before the rows are
    laid out."""
    grev = _reversed_taps(taps, offsets_norm, p, d).transpose(1, 2)
    s, k, c = grev.shape                                   # [S, K, C]
    gr, gi = grev.real.to(dtype), grev.imag.to(dtype)
    row_re = torch.cat([gr, gi], dim=-1)                   # [S, K, 2C]
    row_im = torch.cat([-gi, gr], dim=-1)
    return torch.stack([row_re, row_im], dim=2).reshape(s, 2 * k, 2 * c)


def bank_fused_plain(z2: torch.Tensor, g2: torch.Tensor,
                     phase0: torch.Tensor, step: torch.Tensor, n: int,
                     p: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the bank kernel, computed in float32.

    z2 [S, L] (L ≥ (n+P-1)·2D) float32/bf16; g2 [S, P·2D, 2C];
    phase0, step [S, C] int64 uint32 values. Returns y_re, y_im
    [S, n, C] float32."""
    s, length = z2.shape
    c = g2.shape[-1] // 2
    zf = z2.to(torch.float32)
    w = zf.as_strided((s, n, p * 2 * d), (zf.stride(0), 2 * d, 1))
    acc = torch.matmul(w, g2.to(torch.float32))            # [S, n, 2C]
    ramp = (phase0[:, None, :]
            + step[:, None, :] * torch.arange(n, device=z2.device)[:, None]
            ) & U32_MASK                                   # [S, n, C]
    y = rotate(torch.complex(acc[..., :c], acc[..., c:]), ramp)
    return y.real.contiguous(), y.imag.contiguous()


SLOT_GROUP = 64     # slots per kernel block: its 128 GEMM columns


def kernel_width(d: int) -> int:
    """W: the kernel's row of 2D values, rounded up to a multiple of 8
    (a tensor map's strides are multiples of 16 bytes)."""
    return -(-2 * d // 8) * 8


def kernel_rows(z2: torch.Tensor, n: int, p: int, d: int) -> torch.Tensor:
    """The A operand of the bank kernel: ``z2`` [S, L] as rows of
    W = ``kernel_width(d)`` values, [S, rows, W] with rows ≥ n+P-1, so
    that window row m is rows m .. m+P-1.

    When W = 2D, L is a multiple of 2D and z2 contiguous and 16-byte
    aligned (``XlatBank.operands`` makes it so), this is a view;
    otherwise the first n+P-1 rows are copied with each row zero-padded
    to W."""
    s, length = z2.shape
    d2, w = 2 * d, kernel_width(d)
    if (w == d2 and length % d2 == 0 and z2.is_contiguous()
            and z2.data_ptr() % 16 == 0):
        return z2.view(s, length // d2, d2)
    rows = n + p - 1
    zb = z2[:, :rows * d2].reshape(s, rows, d2)
    return torch.nn.functional.pad(zb, (0, w - d2)).contiguous()


def _slot_groups(x: torch.Tensor, w: int) -> torch.Tensor:
    """[S, 2, C, P, 2D] (the re-column and im-column tap rows of each
    slot) → [S, G, 128, P·W], zero for slots past C and pad values."""
    s, _, c, p, d2 = x.shape
    g = -(-c // SLOT_GROUP)
    if g * SLOT_GROUP != c or w != d2:
        x = torch.nn.functional.pad(x, (0, w - d2, 0, 0,
                                        0, g * SLOT_GROUP - c))
    x = x.reshape(s, 2, g, SLOT_GROUP, p * w).transpose(1, 2)
    return x.reshape(s, g, 2 * SLOT_GROUP, p * w).contiguous()


def kernel_taps(g2: torch.Tensor, p: int, d: int) -> torch.Tensor:
    """The B operand of the bank kernel from ``g2`` [S, P·2D, 2C]
    (``tap_matrix``, columns [re C | im C]): K-major slot groups
    [S, G, 128, P·W], G = ceil(C/64), W = ``kernel_width(d)``. Row j < 64
    of group g is the re column of slot 64g+j, row 64+j its im column;
    zero for slots past C and for the W-2D pad values of each window
    chunk."""
    s, k2, c2 = g2.shape
    x = g2.reshape(s, k2, 2, c2 // 2).permute(0, 2, 3, 1)
    return _slot_groups(x.reshape(s, 2, c2 // 2, p, 2 * d), kernel_width(d))


def kernel_tap_matrix(taps: np.ndarray | torch.Tensor,
                      offsets_norm: torch.Tensor, p: int, d: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``kernel_taps(tap_matrix(taps, offsets_norm, p, d, dtype), p, d)``,
    the same values, built in the kernel's layout directly: no [P·2D, 2C]
    matrix to transpose."""
    g = torch.view_as_real(_reversed_taps(taps, offsets_norm, p, d))
    s, c, k, _ = g.shape                                   # [S, C, K, 2]
    rows = torch.empty((s, 2, c, k, 2), dtype=dtype, device=g.device)
    rows[:, 0].copy_(g)                                    # (g_re, g_im)
    rows[:, 0, ..., 1].neg_()                              # (g_re, -g_im)
    rows[:, 1, ..., 0].copy_(g[..., 1])
    rows[:, 1, ..., 1].copy_(rows[:, 0, ..., 0])           # (g_im, g_re)
    return _slot_groups(rows.reshape(s, 2, c, p, 2 * d), kernel_width(d))


def wire_z2(history: torch.Tensor, x2: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """The bank's row buffer z2 [S, (K+T)·2] of ``dtype``: the [S, K-1]
    complex64 history ++ the [S, T, 2] wire block ++ one zero sample, each
    rounded once to ``dtype``. The zero sample makes the row (N+P)·2D
    values long, a whole number of 2D-value rows (``kernel_rows``)."""
    hist2 = torch.view_as_real(history).to(dtype)
    return torch.cat([hist2, x2.to(dtype),
                      hist2.new_zeros((x2.shape[0], 1, 2))],
                     dim=1).reshape(x2.shape[0], -1)


def bank_operands_plain(history: torch.Tensor, x2: torch.Tensor,
                        offsets_norm: torch.Tensor,
                        taps: torch.Tensor, p: int, d: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the operands kernel: (z2 bf16
    ``wire_z2``, g2 ``kernel_tap_matrix`` in bf16, step
    ``phase_step_u32``), what ``bank_fused`` takes on CUDA."""
    return (wire_z2(history, x2, torch.bfloat16),
            kernel_tap_matrix(taps, offsets_norm, p, d),
            phase_step_u32(offsets_norm, d))


def operands_args(history: torch.Tensor, x2: torch.Tensor,
                  offsets_norm: torch.Tensor, taps: torch.Tensor, p: int,
                  d: int, parts: int = 3):
    """Validate the operands kernel's inputs and allocate its outputs:
    (the arguments of the C entry point ``bank_operands_launch``, (z2, g2,
    step)). Raises ValueError on what the kernel does not take: another
    dtype or shape, a non-contiguous or misaligned block, tensors on
    different devices, or tensors off the card. ``parts`` 1 or 2 has the
    launch write only g2 and step, or only z2: a measurement aid."""
    if (x2.dtype not in (torch.bfloat16, torch.float32) or x2.dim() != 3
            or x2.shape[-1] != 2 or not x2.is_contiguous()
            or x2.data_ptr() % (2 * x2.element_size())):
        raise ValueError(f"bank_operands: x2 must be a contiguous [S, T, 2] "
                         f"bf16 or float32 wire block, got {x2.dtype} "
                         f"{tuple(x2.shape)} (contiguous: "
                         f"{x2.is_contiguous()})")
    s, t = x2.shape[:2]
    c, k = offsets_norm.shape[-1], p * d
    for name, v, dt, shape in (
            ("history", history, torch.complex64, (s, k - 1)),
            ("offsets_norm", offsets_norm, torch.float32, (s, c)),
            ("taps", taps, torch.float32, (k,))):
        if (v.device != x2.device or v.dtype != dt
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"bank_operands: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on "
                             f"{x2.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if x2.device.type != "cuda":
        raise ValueError(f"bank_operands: the kernel takes CUDA tensors, "
                         f"got {x2.device}")
    w = kernel_width(d)
    z2 = torch.empty((s, (k + t) * 2), dtype=torch.bfloat16,
                     device=x2.device)
    g2 = torch.empty((s, -(-c // SLOT_GROUP), 2 * SLOT_GROUP, p * w),
                     dtype=torch.bfloat16, device=x2.device)
    step = torch.empty((s, c), dtype=torch.int64, device=x2.device)
    args = (history.data_ptr(), x2.data_ptr(), offsets_norm.data_ptr(),
            taps.data_ptr(), z2.data_ptr(), g2.data_ptr(), step.data_ptr(),
            s, t, c, p, d, w, int(x2.dtype == torch.bfloat16), parts,
            torch.cuda.current_stream(x2.device).cuda_stream)
    return args, (z2, g2, step)


def bank_operands(history: torch.Tensor, x2: torch.Tensor,
                  offsets_norm: torch.Tensor, taps: torch.Tensor, p: int,
                  d: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wire bank's operands for one block: ``bank_operands_plain`` on
    CPU tensors, the CUDA kernel ``csrc/bank_operands.cu`` on CUDA tensors,
    one launch for all three, bit for bit the plain version's on the card
    (g2 up to the sign of a zero tap).

    history [S, K-1] complex64; x2 [S, T, 2] bf16 or float32 wire block;
    offsets_norm [S, C] float32; taps [K] float32, K = p·d. Returns z2
    [S, (K+T)·2] bf16, g2 [S, G, 128, P·W] bf16, step [S, C] int64. On
    CUDA what the kernel does not take raises (``operands_args``).

    Bound by bytes (the block read once, z2 and the taps written once);
    the taps' sin/cos come from the factorized phasor, C·(P+D) pairs a
    source, in shared memory."""
    if x2.device.type == "cpu":
        return bank_operands_plain(history, x2, offsets_norm, taps, p, d)
    from radiocapture_tpu_torch import kernels
    args, outs = operands_args(history, x2, offsets_norm, taps, p, d)
    kernels.launch("bank_operands", *args)
    return outs


def bank_fused(z2: torch.Tensor, g2: torch.Tensor, phase0: torch.Tensor,
               step: torch.Tensor, n: int, p: int, d: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused bank: ``bank_fused_plain`` on CPU tensors, the CUDA
    kernel ``csrc/xlat_bank.cu`` on CUDA tensors (bf16 operands, float32
    accumulation, exact uint32 rotation). On CPU g2 is ``tap_matrix``'s
    [S, P·2D, 2C]; on CUDA it is the kernel's [S, G, 128, P·W]
    (``kernel_tap_matrix``, or ``kernel_taps`` of ``tap_matrix``'s), and
    z2 and g2 must be bf16 (``XlatBank.operands`` makes them so): another
    dtype or layout raises.

    The kernel is compute-bound: per 100 ms source block at 2.4 MS/s with
    64 slots the GEMM is 2500·2880·128·2 ≈ 1.84 GFLOP on 1.0 MB of input,
    ~1.9 kFLOP per input byte, far above the H100's ~295 FLOP/byte bf16
    ridge. It is a TMA-fed ``wgmma`` GEMM: window row n's chunk q is row
    n+q of z2 viewed as rows of 2D values (``kernel_rows``), so a block's
    P shifted operand tiles are row offsets into one span of that matrix,
    loaded once by one tensor map; the taps go in K-major groups of 64
    slots, re and im columns of a slot in one block so the rotation is a
    per-thread epilogue."""
    if z2.device.type == "cpu":
        return bank_fused_plain(z2, g2, phase0, step, n, p, d)
    if z2.device.type != "cuda":
        raise ValueError(f"bank_fused: unsupported device {z2.device}")
    from radiocapture_tpu_torch import kernels
    s, length = z2.shape
    c = phase0.shape[-1]
    w = kernel_width(d)
    for name, t, dt, shape in (
            ("z2", z2, torch.bfloat16, (s, length)),
            ("g2", g2, torch.bfloat16,
             (s, -(-c // SLOT_GROUP), 2 * SLOT_GROUP, p * w)),
            ("phase0", phase0, torch.int64, (s, c)),
            ("step", step, torch.int64, (s, c))):
        if (t.device != z2.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"bank_fused: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on "
                             f"{z2.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if length < (n + p - 1) * 2 * d:
        raise ValueError(f"bank_fused: z2 rows hold {length} values, "
                         f"need {(n + p - 1) * 2 * d}")
    zb = kernel_rows(z2, n, p, d)
    y_re = torch.empty((s, n, c), dtype=torch.float32, device=z2.device)
    y_im = torch.empty_like(y_re)
    kernels.launch(
        "xlat_bank", zb.data_ptr(), g2.data_ptr(), phase0.data_ptr(),
        step.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), s, n, p, w, c,
        zb.shape[1], zb.stride(0),
        torch.cuda.current_stream(z2.device).cuda_stream)
    return y_re, y_im


def bank_complex_plain(z: torch.Tensor, grev: torch.Tensor,
                       phase0: torch.Tensor, step: torch.Tensor, n: int,
                       d: int) -> torch.Tensor:
    """Plain PyTorch version of the complex bank kernel, float32.

    z [S, L] complex64 (L ≥ (n-1)·D + K); grev [S, C, K] complex64
    correlation-reversed modulated taps; phase0, step [S, C] int64 uint32
    values. Returns y [S, C, n] complex64 with
    ``y[s, c, m] = e^{iθ} Σ_k grev[s, c, k] · z[s, m·D + k]``."""
    s = z.shape[0]
    c, k = grev.shape[1:]
    zr = torch.view_as_real(z.contiguous()).reshape(s, -1)
    # window row m: the 2K interleaved re/im values from z[m·D] on
    w = zr.as_strided((s, n, 2 * k), (zr.stride(0), 2 * d, 1))
    gt = grev.transpose(1, 2)                               # [S, K, C]
    gr, gi = gt.real, gt.imag
    g2 = torch.stack([torch.cat([gr, gi], -1), torch.cat([-gi, gr], -1)],
                     dim=2).reshape(s, 2 * k, 2 * c)
    acc = torch.matmul(w, g2)                               # [S, n, 2C]
    y = torch.complex(acc[..., :c], acc[..., c:]).transpose(1, 2)
    ramp = (phase0[:, :, None]
            + step[:, :, None] * torch.arange(n, device=z.device)
            ) & U32_MASK                                    # [S, C, n]
    return rotate(y, ramp).contiguous()


def complex_z(x: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """history ++ block as complex64 [S, K-1+T]: what the plain version
    reads, from the [S, T, 2] wire block ``x`` (bf16 → float32 is exact)
    and the [S, K-1] complex64 ``history``."""
    xc = torch.view_as_complex(x.to(torch.float32).contiguous())
    return torch.cat([history, xc], dim=1)


def complex_args(x: torch.Tensor, history: torch.Tensor, grev: torch.Tensor,
                 phase0: torch.Tensor, step: torch.Tensor, d: int):
    """Validate the complex bank kernel's inputs and allocate its output:
    (the arguments of the C entry point ``xlat_complex_launch``, y).
    Raises ValueError on what the kernel does not take: another dtype or
    shape, a non-contiguous or misaligned tensor, tensors on different
    devices, or tensors off the card."""
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3
            or x.shape[-1] != 2 or not x.is_contiguous()
            or x.data_ptr() % (2 * x.element_size())):
        raise ValueError(f"bank_complex: x must be a contiguous [S, T, 2] "
                         f"bf16 or float32 wire block, got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()})")
    t = x.shape[1]
    c, k = grev.shape[1:]
    s = x.shape[0]
    for name, v, dt, shape in (
            ("history", history, torch.complex64, (s, k - 1)),
            ("grev", grev, torch.complex64, (s, c, k)),
            ("phase0", phase0, torch.int64, (s, c)),
            ("step", step, torch.int64, (s, c))):
        if (v.device != x.device or v.dtype != dt
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"bank_complex: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on "
                             f"{x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if x.device.type != "cuda":
        raise ValueError(f"bank_complex: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    n = t // d
    y = torch.empty((s, c, n), dtype=torch.complex64, device=x.device)
    args = (x.data_ptr(), history.data_ptr(), grev.data_ptr(),
            phase0.data_ptr(), step.data_ptr(), y.data_ptr(), s, t, n, k, d,
            c, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    return args, y


def bank_complex(x: torch.Tensor, history: torch.Tensor, grev: torch.Tensor,
                 phase0: torch.Tensor, step: torch.Tensor, d: int
                 ) -> torch.Tensor:
    """The complex bank on one block: ``bank_complex_plain`` of
    ``complex_z(x, history)`` on CPU tensors, the CUDA kernel
    ``csrc/xlat_complex.cu`` on CUDA tensors. Returns y [S, C, T//d]
    complex64.

    x [S, T, 2] is the block as it arrives, a bf16 or float32 wire block
    (a complex64 block as ``torch.view_as_real``, a view); history
    [S, K-1] complex64; grev [S, C, K] complex64; phase0, step [S, C]
    int64 uint32 values. On CUDA the kernel reads x and history in place
    (no conversion, no concatenation); another dtype, a non-contiguous
    tensor or a shape that does not match raises (``complex_args``).

    At the shape ``SpectrumSplit2`` sends (D=2, K=20, C=2) the kernel is
    memory-bound: each warp stages the spans of its tiles of 32·R outputs
    in shared memory by ``cp.async``, one tile ahead, as float32
    polyphase planes, and each lane computes R consecutive outputs of
    every slot from the planes' rows with the taps in registers. Other
    shapes (the time-sharded mesh step, C=64) take the general path,
    bound by float32 FMAs: a block stages its outputs' span as polyphase
    planes, each thread holds 4 outputs × 8 slots and the taps stream
    through shared memory; a span too large for shared memory is read
    from device memory. Every output is one ``fmaf`` chain in k order,
    the same bits on every path."""
    if x.device.type == "cpu":
        return bank_complex_plain(complex_z(x, history), grev, phase0, step,
                                  x.shape[1] // d, d)
    if x.device.type != "cuda":
        raise ValueError(f"bank_complex: unsupported device {x.device}")
    from radiocapture_tpu_torch import kernels
    args, y = complex_args(x, history, grev, phase0, step, d)
    if y.shape[-1] == 0:
        return y
    kernels.launch("xlat_complex", *args)
    return y
