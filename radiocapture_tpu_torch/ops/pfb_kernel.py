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
one launch: the same staging and sums, then each row's IDFT, factored as
M = M1·M2 (``idft_factors``, ``factored_tables``: M2 DFTs of length M1,
then M1 of length M2 with the twiddles and the rotation in their
constants) or, where the plan does not factor M, through one folded
[M, M] table (``bins_table``). Its plain version, ``pfb_bins_plain``, is
the chain the pfb step ran before it: ``pfb_rows_plain``,
``torch.fft.ifft``, the rotation, bin-major.

``pfb_fine`` is the fine stage after it (``csrc/pfb_fine.cu``): each
slot's row of bin samples mixed to the slot's offset by the phasor of an
exact uint32 ramp, one real prototype filter for every slot, and the
rotation, written as the trackers' time-major float32 planes. Its plain
version, ``pfb_fine_plain``, is the same float32 arithmetic in eager
PyTorch, one complex row a slot.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radiocapture_tpu_torch.ops.channelizer_kernel import complex_z
from radiocapture_tpu_torch.ops.fir import U32_MASK, rotate
from radiocapture_tpu_torch.utils import trace

# csrc/pfb_rows.cu's constants that pfb_bins' plan depends on
MB_MAX = 16          # pfb_rows' branches a block, pfb_bins' warps a slab
WARPS_MAX = 8        # warps a block aims for
WIRE_K = {True: 11, False: 7}   # rows a lane, by bf16 wire
K_SMALL = 3          # rows a lane where the wire's K does not fit
K_MID = 7            # rows a lane between the two
CB = 8               # channels a direct-path thread sums at once
CB_NARROW = 6        # ... where 6 pads no more channels (direct_chunk)
FACTOR_MAX = 16      # the largest factor of a factored IDFT
SMEM_MAX = 232448    # shared memory a block can use on the H100
# what an H100 SM holds for the plan's blocks: shared memory (less the 1 KB
# CUDA reserves a block), registers (64 a thread under the kernel's
# __launch_bounds__(512, 2)), threads
SM_SHARED, BLOCK_RESERVED, SM_REGS, REGS, SM_THREADS = (233472, 1024,
                                                        65536, 64, 2048)
# M that the plan leaves on the direct table although it factors: where
# the direct path measured faster on an H100 (2·3 and 2·4 save too few
# FLOP for the factored epilogue's second pass through the planes)
DIRECT_M = (6, 8)
# pfb_bins against pfb_bins_plain on the card, × max|bins|: the IDFT's sum
# order is not cuFFT's and the rotation is folded into its tables (at most
# 2.9e-7 measured with the factored IDFT, at M = 25, and 7.7e-7 with the
# direct table at M = 100, on an H100 80GB HBM3 at 700 W)
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


def idft_factors(m: int) -> tuple[int, int]:
    """The factored IDFT's (M1, M2) for M branches: M1·M2 = M, 2 ≤ M1 ≤
    M2 ≤ FACTOR_MAX, the pair with the least M1 + M2 (8·M·(M1 + M2) FLOP
    a row against the direct table's 8·M²). (1, M), the direct table, for
    an M with no such pair (a prime such as 7, 11 or 13, or one whose
    cofactor passes FACTOR_MAX, as 2·53) and for the M of ``DIRECT_M``."""
    pairs = [(a, m // a) for a in range(2, int(m ** 0.5) + 1)
             if m % a == 0 and m // a <= FACTOR_MAX]
    if not pairs or m in DIRECT_M:
        return 1, m
    return min(pairs, key=sum)


def _even(n: int) -> int:
    return n + (n & 1)


def _whole(n: int, c: int) -> int:
    return -(-n // c) * c


def direct_chunk(m: int) -> int:
    """The direct path's channels a thread (csrc/pfb_rows.cu's
    ``direct_chunk``): CB_NARROW where it pads no more of the M channels
    than CB, else CB."""
    return CB_NARROW if _whole(m, CB_NARROW) <= _whole(m, CB) else CB


def factored_tables(m: int, m1: int, m2: int) -> np.ndarray:
    """The factored IDFT's constants, flat complex64: W1 [M1, M1] then T2
    [M, M2], each row padded with zeros to an even length (two constants a
    16-byte load). With u[m] = v'[M-1-m] (the flip) and m = M2·m1 + m2,
    c = c1 + M1·c2:

        A[c1, m2] = Σ_m1 u[M2·m1 + m2] · W1[c1, m1]
        bins[c]   = Σ_m2 A[c1, m2] · T2[c, m2]
        W1[c1, m1] = e^{+j2π((c1·m1) mod M1)/M1}
        T2[c, m2]  = e^{+j2π((c·m2) mod M)/M} · rot[c]

    so T2 folds the twiddle e^{j2πc1·m2/M}, the second stage's own
    e^{j2πc2·m2/M2} and the rotation (``rotation``'s float32 angles), all
    in float64, rounded once."""
    c1 = np.arange(m1)
    w1 = np.zeros((m1, _even(m1)), np.complex128)
    w1[:, :m1] = np.exp(2j * np.pi * ((c1[:, None] * c1) % m1) / m1)
    c = np.arange(m)
    t2 = np.zeros((m, _even(m2)), np.complex128)
    t2[:, :m2] = (np.exp(2j * np.pi * ((c[:, None] * np.arange(m2)) % m) / m)
                  * np.exp(1j * _rotation_angles(m))[:, None])
    return np.concatenate([w1.ravel(), t2.ravel()]).astype(np.complex64)


def plan_table(m: int, m1: int, m2: int) -> np.ndarray:
    """The table ``pfb_bins_launch`` reads for the plan (M1, M2): the
    direct [M, M] ``bins_table`` at M1 = 1, else ``factored_tables``."""
    return bins_table(m) if m1 == 1 else factored_tables(m, m1, m2)


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
    kernels.launch("pfb_rows", *args)
    return outs


def _blocks_per_sm(threads: int, shared: int) -> int:
    """The blocks of ``threads`` threads and ``shared`` bytes of shared
    memory one H100 SM holds at once."""
    return min(SM_SHARED // (shared + BLOCK_RESERVED),
               SM_REGS // (REGS * threads), SM_THREADS // threads)


@functools.cache
def bins_plan(m: int, p: int, bf16: bool,
              factors: tuple[int, int] | None = None
              ) -> tuple[int, int, int, int, int, int]:
    """``pfb_bins``' launch plan for M branches and P taps: (k rows a lane,
    wb warps a slab over the branches, slabs, M1, M2, shared memory bytes
    a block). A block holds every branch of its 32·k·slabs rows, its wb
    warps a slab taking them in rounds (slabs = 8 // wb below 8 warps);
    the IDFT is factored as M1·M2 (``idft_factors``, or ``factors``;
    (1, M) is the direct table, which a prime M such as 7, 11 or 13, an M
    whose cofactor passes FACTOR_MAX and DIRECT_M's 6 and 8 keep: there
    2·3 and 2·4 save too few FLOP for the factored epilogue's second
    pass through the planes, and measured slower on an H100).

    A block runs its phases (staging, sums, IDFT, stores) one after
    another, so only other blocks on an SM overlap them: of k in (the
    wire's K, K_MID, K_SMALL) and wb in (⌈M/⌈M/16⌉⌉, 8, 16) whose planes,
    table and taps fit the shared memory a block can use, the plan takes
    the one an SM holds the most working warps of (blocks × min(wb, M) ×
    slabs); then a k above K_SMALL (whose tiles stage 24% more rows than
    they sum and reload each lane's window more often); then the most
    blocks, the larger k, the fewer warps (none idle). On an H100: M =
    25, bf16, 7 rows and 8 warps (four blocks an SM) 0.131 ms against
    0.148 with 11 rows and 13 warps (two); M = 50, 7 rows and 16 warps
    0.300 against 0.325 with 3 rows and 8 warps; M = 100, float32, 3 rows
    and 16 warps (two blocks) 0.808 against 0.875 with 7 rows (one).
    Raises ValueError for an M whose planes pass the shared memory a
    block can use even at K_SMALL (M > 115 at P = 24 on the direct
    table). A plan made counts its host seconds in ``setup.plans_s``."""
    with trace.timed("setup.plans_s"):
        m1, m2 = factors or idft_factors(m)
        if m1 * m2 != m or not (m1 == 1 or 2 <= m1 <= m2 <= FACTOR_MAX):
            raise ValueError(
                f"pfb_bins: no plan factors M={m} as {m1}·{m2}")
        table = (m * _whole(m, direct_chunk(m)) if m1 == 1
                 else m1 * _even(m1) + m * _even(m2))
        best = None
        for k in dict.fromkeys((WIRE_K[bf16], K_MID, K_SMALL)):
            for wb in dict.fromkeys((-(-m // -(-m // MB_MAX)), 8, MB_MAX)):
                slabs = 1 if wb >= WARPS_MAX else WARPS_MAX // wb
                shared = (8 * (table + m * (slabs * 32 * k + p - 1))
                          + 4 * m * p)
                if shared > SMEM_MAX:
                    continue
                blocks = _blocks_per_sm(32 * wb * slabs, shared)
                key = (blocks * min(wb, m) * slabs, k > K_SMALL, blocks, k,
                       -wb)
                if best is None or key > best[0]:
                    best = key, (k, wb, slabs, m1, m2, shared)
    if best is None:
        raise ValueError(f"pfb_bins: M={m}, P={p} needs {shared} bytes of "
                         f"shared memory a block, more than {SMEM_MAX}")
    return best[1]


@functools.cache
def device_table(m: int, m1: int, m2: int,
                 device: torch.device) -> torch.Tensor:
    """``plan_table(m, m1, m2)`` on ``device``, copied there once (a copy
    from pageable host memory would synchronize the stream every step);
    the kernel only reads it. Timed as ``bins_plan``'s plans are."""
    with trace.timed("setup.plans_s"):
        return torch.as_tensor(plan_table(m, m1, m2), device=device)


def pfb_bins_args(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor):
    """Validate ``pfb_bins``' inputs as ``pfb_rows_args`` does, plan the
    launch (``bins_plan``; an M it cannot hold raises ValueError) and
    allocate the outputs: (the arguments of ``pfb_bins_launch``, (bins
    [S, M, T/M], new history))."""
    x = _check("pfb_bins", history, x, hp2)
    s, t = x.shape[:2]
    m, p = hp2.shape
    bf16 = x.dtype == torch.bfloat16
    k, wb, slabs, m1, m2, _ = bins_plan(m, p, bf16)
    table = device_table(m, m1, m2, x.device)
    bins = torch.empty((s, m, t // m), dtype=torch.complex64,
                       device=x.device)
    hist = torch.empty((s, (p - 1) * m), dtype=torch.complex64,
                       device=x.device)
    args = (history.data_ptr(), x.data_ptr(), hp2.data_ptr(),
            table.data_ptr(), bins.data_ptr(), hist.data_ptr(), s, t, m, p,
            int(bf16), k, wb, slabs, m1, m2,
            torch.cuda.current_stream(x.device).cuda_stream)
    return args, (bins, hist)


def pfb_bins(history: torch.Tensor, x: torch.Tensor, hp2: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The coarse PFB on one block, bin-major: ``pfb_bins_plain`` on CPU
    tensors, one launch of ``csrc/pfb_rows.cu``'s ``pfb_bins`` kernel on
    CUDA tensors (the combiner's staging and sums, then the IDFT and the
    rotation, factored as ``bins_plan`` says, or through ``bins_table``),
    which reads x and the history in place; what it does not take raises
    (``pfb_bins_args``). Returns (bins [S, M, T/M] complex64, a new
    [S, (P-1)·M] history), the history bit for bit ``pfb_rows``', the
    bins within a few float32 ulps of max|bins| of the plain version's
    (another sum order than cuFFT's).

    Bound by bytes, as ``pfb_rows``: 0.110 ms at the bench shape on bf16
    (the IDFT counted at an FFT's 5·M·log2 M FLOP a row); the factored
    IDFT does 8·M·(M1 + M2) FLOP a row, the direct table 8·M²."""
    if x.device.type == "cpu":
        return pfb_bins_plain(history, x, hp2)
    from radiocapture_tpu_torch import kernels
    args, outs = pfb_bins_args(history, x, hp2)
    kernels.launch("pfb_bins", *args)
    return outs


# ---- the fine stage: csrc/pfb_fine.cu

# csrc/pfb_fine.cu's constants that the fine stage's plan depends on
FINE_D = 16          # the decimation it is built for: samples a row
FINE_O = 15          # outputs a lane group
FINE_LANES = 4       # lanes a group: each takes 4 of a row's 16 samples
FINE_WP = 2          # warps a part (real or imaginary) a block
FINE_MIX = 8         # threads a row in the mixing pass
FINE_BLOCKS = 3      # blocks an SM holds (its __launch_bounds__)
FINE_G = 3           # slot rows a store group
FINE_NB = FINE_WP * 32 // FINE_LANES * FINE_O   # outputs a tile
FINE_RB_MAX = 12     # slot rows a block at most: four store groups
FINE_RB_MIN = 2      # ... and at least, where there are two
# pfb_fine (the kernel, and its plan emulated on the CPU) against
# pfb_fine_plain and the float64 function, × max|y|: both mix by phasors
# of float32 angles (float(u)·2π/2^32) and sum in float32 in other orders
# (5.8e-7 measured against float64 on the CPU)
FINE_REL = 2e-6


def mixer_sigma(fine: torch.Tensor) -> torch.Tensor:
    """The mixer's uint32 step σ = round(f·2^32) mod 2^32 of each fine
    offset f (float32, cycles per bin sample), as int64: f·2^32 is exact
    in float64 and rounds half to even, as the kernel's
    ``__double2ll_rn`` does."""
    return torch.round(fine.to(torch.float64) * 4294967296.0).to(
        torch.int64) & U32_MASK


def pfb_fine_plain(x: torch.Tensor, rows: torch.Tensor,
                   history: torch.Tensor, taps: torch.Tensor,
                   fine: torch.Tensor, phase0: torch.Tensor,
                   step: torch.Tensor, d: int) -> torch.Tensor:
    """Plain PyTorch version of the fine stage, float32.

    x [R, T, 2] the bins (float32, or a bf16 wire: bf16 → float32 is
    exact), T % d == 0; rows [S] int64, row s's bin; history [S, K-1]
    complex64; taps [K] float32, the real prototype h; fine [S] float32,
    each row's offset f; phase0, step [S] int64 uint32 values. Returns y
    [S, T//d] complex64 with, over z = history ++ x[rows[s]], σ =
    ``mixer_sigma(f)`` and ``rotate``'s phasors:

        w[m] = z[m] · e^{iα(-σ·m)}
        y[n] = e^{iα(v)} Σ_k h[K-1-k] · w[n·d + k],
        v = phase0 + step·n + σ·(n·d + K-1)   (mod 2^32)

    which is ``bank_complex`` of the taps modulated to f (``modulated_
    taps``) up to the rounding of the modulation's angle: the per-output
    factor e^{i2πf(n·d + K-1)} folds into the rotation."""
    k = taps.shape[0]
    z = complex_z(x[rows], history)                       # [S, L]
    n = x.shape[1] // d
    sig = mixer_sigma(fine)[:, None]
    m = torch.arange(z.shape[1], device=z.device)
    w = rotate(z, (-sig * m) & U32_MASK)
    hr = taps.to(torch.float32).flip(0)
    acc = []
    for part in (w.real.contiguous(), w.imag.contiguous()):
        win = part.as_strided((part.shape[0], n, k), (part.stride(0), d, 1))
        acc.append(torch.matmul(win, hr))                 # [S, n]
    nn = torch.arange(n, device=z.device)
    v = (phase0[:, None] + step[:, None] * nn + sig * (nn * d + k - 1)
         ) & U32_MASK
    return rotate(torch.complex(*acc), v)


def fine_bytes(k: int) -> int:
    """A block's shared memory at K taps, as ``csrc/pfb_fine.cu``'s
    ``fine_bytes``, with the Q = ⌈K/D⌉ tap rows rounded up to QP, whole
    groups of FINE_O: the raw span and the mixed rows (NB + QP - 1 rows of
    128 bytes each), the QP·D taps, the mixer's row steps, the copies'
    mbarrier, and for a store group of FINE_G rows their planes' offsets,
    phase0, step and sigma and their two parts' sums."""
    qp = -(-(-(-k // FINE_D)) // FINE_O) * FINE_O
    rows, rstride = FINE_NB + qp - 1, FINE_WP * 64 // FINE_MIX
    return (2 * 128 * rows + 4 * qp * FINE_D + 8 * -(-rows // rstride) + 8
            + 20 * FINE_G + 8 * FINE_NB * FINE_G)


@functools.cache
def fine_plan(rows: int, n: int, k: int, sms: int) -> int:
    """The fine stage's slot rows a block for ``rows`` rows of N outputs
    at K taps on a card of ``sms`` SMs. A block takes one tile of FINE_NB
    outputs of rb consecutive rows, one after another, staging a bin's
    span once for the rows that read it, and stores its rows' outputs
    into the planes FINE_G rows at a time, one run of slots a time step;
    a run costs the store path what one float does. rb is the most, up
    to FINE_RB_MAX (four whole store groups), that leaves four waves of
    blocks on the card, and at least FINE_RB_MIN: on an H100 at 8192
    rows, 12 rows a block took 1.4787 ms, 15 1.4849, 16 1.4878; at the
    runtime's 64 rows two rows a block 0.0180 against one 0.0202 (a
    partial wave of blocks storing runs of two), at 128 0.0324 against
    0.0346, at 256 0.0579 against 0.0623. Raises ValueError where a
    block's shared memory passes what one can use."""
    if fine_bytes(k) > SMEM_MAX:
        raise ValueError(f"pfb_fine: K={k} taps need more shared memory "
                         f"than a block can use ({SMEM_MAX} bytes)")
    blocks = rows * -(-n // FINE_NB)
    return max(min(FINE_RB_MIN, rows),
               min(FINE_RB_MAX, blocks // (4 * sms * FINE_BLOCKS)))


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_slots(s: int, c: int) -> None:
    if c < 1 or s % c:
        raise ValueError(f"pfb_fine: {s} rows are not whole sources of "
                         f"C = {c} slots")


def pfb_fine_args(x: torch.Tensor, rows: torch.Tensor,
                  history: torch.Tensor, taps: torch.Tensor,
                  fine: torch.Tensor, phase0: torch.Tensor,
                  step: torch.Tensor, d: int, c: int, rb: int | None = None,
                  out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Validate the fine-stage kernel's inputs, plan its launch
    (``fine_plan``, or ``rb`` rows a block) and allocate its outputs, or
    take ``out``: (the arguments of the C entry point ``pfb_fine_launch``,
    the planes (y_re, y_im) [S/c, T//d, c] float32 of the S rows as c
    slots a source). Raises ValueError on what the kernel does not take:
    another dtype or shape, d ≠ FINE_D, an even tap count, S not a
    multiple of c, a non-contiguous or misaligned tensor (the bulk copies
    read whole 16-byte spans of history and bins), planes of another
    shape or not contiguous, tensors on different devices, or tensors off
    the card. The values of ``rows`` are not checked: that would sync
    with the host."""
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[-1] != 2
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"pfb_fine: x must be contiguous 16-byte aligned "
                         f"[R, T, 2] float32 bins, got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()})")
    t = x.shape[1]
    k = taps.shape[0] if taps.dim() == 1 else -1
    if d != FINE_D or t % d or k % 2 == 0:
        raise ValueError(f"pfb_fine: the kernel takes D = {FINE_D}, T % D "
                         f"== 0 and an odd tap count, got D = {d}, T = {t}, "
                         f"K = {k}")
    s = rows.shape[0] if rows.dim() == 1 else -1
    n = t // d

    def expect(name, v, dt, shape):
        if (v.device != x.device or v.dtype != dt
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"pfb_fine: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")

    for name, v, dt, shape in (
            ("rows", rows, torch.int64, (s,)),
            ("history", history, torch.complex64, (s, k - 1)),
            ("taps", taps, torch.float32, (k,)),
            ("fine", fine, torch.float32, (s,)),
            ("phase0", phase0, torch.int64, (s,)),
            ("step", step, torch.int64, (s,))):
        expect(name, v, dt, shape)
    _check_slots(s, c)
    pshape = (s // c, n, c)
    y_re, y_im = out or (torch.empty(pshape, dtype=torch.float32,
                                     device=x.device) for _ in range(2))
    expect("y_re", y_re, torch.float32, pshape)
    expect("y_im", y_im, torch.float32, pshape)
    if history.data_ptr() % 16:
        raise ValueError("pfb_fine: history must be 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"pfb_fine: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    rb = rb or fine_plan(s, n, k, _sms(x.device))
    args = (x.data_ptr(), rows.data_ptr(), history.data_ptr(),
            taps.data_ptr(), fine.data_ptr(), phase0.data_ptr(),
            step.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), s, t, n, k, c,
            rb, torch.cuda.current_stream(x.device).cuda_stream)
    return args, (y_re, y_im)


def pfb_fine(x: torch.Tensor, rows: torch.Tensor, history: torch.Tensor,
             taps: torch.Tensor, fine: torch.Tensor, phase0: torch.Tensor,
             step: torch.Tensor, d: int, c: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pfb fine stage on one block, its S rows taken as c slots a
    source (row s·c + j is slot j of source s): the planes of
    ``pfb_fine_plain`` on CPU tensors, one launch of the CUDA kernel
    ``csrc/pfb_fine.cu`` on CUDA tensors, which reads the bins (through
    ``rows``) and the history in place and writes the planes itself;
    what it does not take raises (``pfb_fine_args``). Returns the
    time-major float32 planes y_re, y_im [S/c, T//d, c] the trackers read
    (the operands as ``pfb_fine_plain`` takes them).

    Bound by float32 FMAs: the real-tap filter's 2 FMAs a tap for each
    output and part, 3.83e10 FLOP at the bench shape (8192 rows × 2500
    outputs × 467 taps, 0.571 ms at 67 TFLOP/s), where the modulated
    taps took 4; the mixing about 8 FLOP a staged sample more."""
    if x.device.type == "cpu":
        s, n = rows.shape[0], x.shape[1] // d
        _check_slots(s, c)
        y = pfb_fine_plain(x, rows, history, taps, fine, phase0, step, d)
        yt = y.view(s // c, c, n).transpose(1, 2)
        return yt.real.contiguous(), yt.imag.contiguous()
    from radiocapture_tpu_torch import kernels
    args, planes = pfb_fine_args(x, rows, history, taps, fine, phase0, step,
                                 d, c)
    kernels.launch("pfb_fine", *args)
    return planes
