#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``radiocapture_tpu_torch``) on one CUDA
card: builds the eight CUDA kernel files and drives the port's three
paths, the scan slice, live SDR ingest and the mesh steps.

1. P25 C4FM control: checks the bank and fsk tracker kernels against
   their plain PyTorch versions (the tracker with the P25 and the EDACS
   parameters, at lane counts on and off its 32-slot tile), decodes a P25
   grant through ``ControlPipeline.step`` at 2.4 MS/s × 64 slots, and
   times the bench shape (128 sources × 100 ms blocks), with the fsk
   tracker's latency floor: the clock64() cycles of its feedback loop
   alone (``track_kernel.chain_probe``) over the SM clock that
   ``nvidia-smi`` reads while the tracker runs.
2. ``receiver_split2`` → CQPSK: checks the complex bank and CQPSK
   tracker kernels against their plain versions, decodes two CQPSK
   control channels and a Phase 2 TDMA superframe through
   ``SpectrumSplit2.step`` → ``CqpskControlPipeline.step`` (two 2.4 MS/s
   sources → four 1.2 MS/s halves × 64 slots), and times its bench shape
   (128 physical sources → 256 halves × 64 slots = 16384 CQPSK lanes),
   with the AGC kernel (``csrc/agc.cu``) against ``cqpsk.agc_scale``
   within AGC_REL_TOL (``agc kernel:``), the complex bank on the bf16
   wire block and history in place
   beside ``SpectrumSplit2.step`` alone, in turns with the chain it
   replaced (the block converted and concatenated, then the kernel of
   ``radiocapture_tpu_torch/tools/xlat_complex_54b2cf5.cu``; every output
   must be bit-identical), the CQPSK tracker in turns with the
   per-sample-loop kernel it replaced
   (``radiocapture_tpu_torch/tools/cqpsk_track_54b2cf5.cu``) and with the
   symbol-major kernel that did all its work in the lane's own warp
   (``radiocapture_tpu_torch/tools/cqpsk_track_b498eb2.cu``; against
   each, every lane's outputs and state must be bit-identical) and its
   chain's floor
   (``cqpsk_kernel.chain_probe``, as for the fsk tracker). Then the
   wire bank's operands kernel (``csrc/bank_operands.cu``) against
   ``XlatBank.operands_plain`` at the C4FM bench, the CQPSK bench (split2's
   float32 halves), the 32-slot dp×tp tile and a block shorter than K-1:
   z2, the phase step and the bank's outputs bit-identical, the taps up
   to the sign of zero, in turns with the eager build (``operands
   kernel:``). Both bench steps' profiles must show none of the eager
   glue's kernels (GLUE_KERNELS: the z2 ``cat``, the tap build's
   sin/cos/complex multiplies, the AGC's hypot/pow/mean).
   Then the ``pfb`` and ``fft`` frontend modes: a P25 grant through
   ``ControlPipeline.p25_c4fm(64, 2.4e6, frontend=...)`` for each (pfb
   launching ``pfb_bins`` once a step, as often as ``pfb_fine``, and
   ``pfb_rows`` and ``xlat_complex`` no time), the pfb combiner's time-major entry
   (``csrc/pfb_rows.cu``'s ``pfb_rows``) against its eager plain version at
   the bench shape on bf16 and float32 wires, complex64 at M = 8 and 16,
   and a block shorter than (P-1)·M, every output and the new history
   bit-identical, with eager / kernel / kernel / eager ms, its bytes
   bound and a grouped ``conv1d`` yardstick (``pfb rows kernel:``); the
   step's coarse PFB in one kernel (``pfb_bins``, the same file: the
   combiner, the IDFT, factored as M1·M2 where the plan factors M, and
   the rotation) against ``pfb_bins_plain`` within
   ``BINS_REL``·max|bins|, the new history bit-identical, at the bench
   shape on bf16 and float32 wires, the pfb mode's banks at M = 8, 16,
   20, 25, 50 and 100 and a 60-sample block, each in turns with the chain
   it replaced (``pfb_rows``, cuFFT, the bin-major multiply), beside its
   bytes bound and one ``torch.fft.ifft`` of the rows (``pfb bins
   kernel:``), and with its plan in turns with commit ef6af1a's kernel,
   the direct [M, M] table (``tools/pfb_rows_ef6af1a.cu``; ``pfb bins
   turns:``); the pfb fine stage (``PfbXlatBank``: ``csrc/pfb_fine.cu``,
   each slot's bin mixed to its offset and filtered by the one real
   K2 = 467-tap prototype, each row reading its slot's bin in place from
   the bin-major bins through a row index) against ``pfb_fine_plain``
   within ``FINE_REL`` and against the complex bank on the gathered rows'
   modulated taps within COMPLEX_REL_TOL (``pfb fine kernel:``), with the
   bins within ``BINS_REL`` of the time-major rows transposed (``pfb
   bins:``), timed at 8192 rows beside its bound and a grouped
   ``conv1d`` (``pfb fine bank:``), the new fine history read through
   the row index bit-identical to the gathered rows' (``pfb fine
   history:``), both modes' step at 128 sources (``bench pfb:``,
   ``bench fft:``; fft's block is 390336 samples, 162.6 ms; the pfb
   profile may run no ``cat``, no ``addcmul_``, no gather, no cuFFT, no
   complex multiply, no ``pfb_rows``, no kernel P-1 times a step and
   none of ``planes()``' copies),
   the pfb step again at the live config's 10 MS/s sources (M = 25,
   128 sources × 100 ms, ``bench pfb 10 MS/s:``) with
   ``pfb_bins``' share of it and in turns with the same step on commit
   ef6af1a's ``pfb_bins``, and
   the step with ``fsk4_block = 10`` against the tracker kernel's
   (``fsk4 block:``) and a P25 grant through it (``decode fsk4
   block:``, no tracker kernel launched).
3. The site runtime: checks the fused analog voice kernel against its
   plain version (small, ragged and bench shapes; audio, power and the
   de-emphasis output within tolerance, the carried discriminator value
   bit for bit), times it in turns with the one-thread-per-lane kernel it
   replaced (``radiocapture_tpu_torch/tools/fm_voice_334afe8.cu``, built
   with the package's flags), runs ``SiteRuntime``
   on the card (two 2.4 MS/s sources × 64 slots, 100 ms blocks) through
   a P25 C4FM grant → recorded LDU call and an EDACS grant → recorded
   analog call, with one block where a source delivers nothing, and times
   ``SiteRuntime.step`` at 128 sources × 64 slots (groups ``c4fm`` and
   ``analog``); the decode and the timing again with ``frontend_mode:
   pfb`` (``runtime decode pfb:``, ``runtime bench pfb:``).
4. The scan slice, on the kernels above: ``SpectrumScanner`` on cuFFT
   (two carriers, held per bin to the CPU port's spectrum, the same
   peaks), ``trial_p25_lock`` (three candidates; only the true control
   channel locks, deciding as the CPU port), the scan CLI's fft mode on
   a written capture, ``ScanningReceiver``'s squelch cycle over 40
   channels and both ``file_to_wav`` chains against the CPU port
   (``decode scan:``, ``decode scanner:``, ``decode file_to_wav:``);
   then ``bench scan:`` on one 2.4 MS/s source (the spectrum over 10 s,
   the trial bank at 64 slots with its host parts, the band scan's 192
   candidates in passes of 40, ``run_fft_scan`` and both
   ``file_to_wav`` chains over 10 s) and a ``tools:`` JSON line.
5. Live SDR ingest, through ``providers_from_config`` into ``SiteRuntime``
   on the card: a real-time fake rtl_tcp daemon (a P25 grant, bf16
   uploads, no zero-filled block, no drop; ``decode live rtl_tcp:``), a
   cs16 driver host into ``receiver_split2`` (a CQPSK grant through the
   complex bank and the CQPSK tracker; ``decode live rciq split2:``), a
   driver host leaving three blocks out (exactly those zero-filled, one
   block apart, then a grant again; ``decode live dropout:``), the site
   at 8, 32 and 128 real-time rtl_tcp sources from child processes until
   one is not real time (``bench live:``), the control-plane soak at 256
   concurrent calls (``soak:``) and 30 s of call churn with flat
   ``memory_allocated`` (``longevity:``), and a ``live:`` JSON line.
6. The mesh slice (``parallel/mesh.py`` on ``torch.distributed``): the
   stream tracker (``track_stream``, the second entry of
   ``csrc/fsk_track.cu``) against its plain version on a P25 fixture,
   ragged noise and the bench shape (8192 lanes × 1250 track-rate
   samples) with its floor, and ``fsk_track`` in turns with commit
   3e03d30's kernel (``tools/fsk_track_3e03d30.cu``; every lane
   bit-identical: ``mesh stream tracker:``, ``fsk track turns:``); the
   P25 grant through ``entry.dryrun_multichip``'s two mesh steps at world
   size 1 (NCCL) and 2 (gloo, both ranks on this card), each rank's
   collectives log held to the JAX formulas, and the time-sharded stream
   on the card against the CPU's (``mesh decode:``); then ``bench
   mesh:``, both mesh steps at 128 sources × 64 slots × 240000-sample
   blocks at world size 1 and 2 (step p50/p95, each collective's bytes
   and ms, the staged host bytes, peak memory), with the complex bank's
   general path at the time-sharded shape (1440 taps, the wide plan)
   beside its bound (``mesh complex bank:``) and in turns with the
   general path it replaced (``complex general turns: mesh``; every
   output bit-identical). Ranks are processes started by
   ``parallel.mesh.spawn`` after the kernels are built here, so they
   only load the library.

    python3 chip_smoke.py

At both bench shapes the channelizer bank kernel is timed beside its
bound (bf16 FLOP over the H100's 989 TFLOP/s, or bytes over 3.35 TB/s)
and its library yardstick (one cuBLAS bf16 ``torch.bmm`` of the window
matrix).

Phases print one line each; any failure raises (non-zero exit). The
lines before the last are the kernels' JSON summary (each kernel's ms,
plain ms, bound, library ms and its launches in the main path's runs;
``pfb_rows``, which no path runs since ``pfb_bins`` took the step, is
marked ``"on_main_path": false`` with 0 launches and keeps the count of
its standalone call apart) and the card's ``nvidia-smi`` name and power
limit; the last line is the JSON result.
Without a CUDA device it fails before printing any result. Imports no
JAX and nothing of the JAX package ``radiocapture_tpu``.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SAMP_RATE = 2.4e6
SLOTS = 64
BLOCK = 240_000            # 100 ms at 2.4 MS/s
BENCH_SOURCES = 128        # bench.py's batch
BANK_REL_TOL = 0.03        # bf16 operands (test_ops_channelizer.py:176)
NOISE_VALID_AGREE = 0.99   # tracker on noise: emit masks
NOISE_SYM_ATOL = 1e-3      # tracker on noise: first NOISE_SYM_N symbols
NOISE_SYM_N = 100
# At the bench shape (8192 noise lanes) the loop amplifies float32
# rounding that differs by ~1e-6 per sample (atan2f and the complex
# multiply compiled otherwise) past NOISE_SYM_ATOL on a few lanes within
# NOISE_SYM_N samples (4-5 of 8192, up to 3.8e-3, H100). So there this
# share of the lanes is held to NOISE_SYM_ATOL, and every lane to
# NOISE_SYM_BOUND: a layout or indexing fault errs by the symbol size
# (~10) from the first sample.
BENCH_SYM_LANES = 0.995
NOISE_SYM_BOUND = 0.1
DEADLINE_MS = 100.0
PROFILE_STEPS = 10
PROFILE_ROWS = 12
# split2 → CQPSK path
HALF_RATE = SAMP_RATE / 2          # each split2 half
CQ_GRID_HZ = 12.5e3                # slot grid around each half's centre
CHANNEL_FS = 25000.0               # CQPSK channel rate (bank output)
COMPLEX_REL_TOL = 1e-4             # f32 complex bank: sum order only
AGC_REL_TOL = 2e-6                 # agc gain vs plain: float32 sum order
AGC_SMALL = ((3, 37, 5), (2, 100, 70))   # (S, N, C) beside the bench's
TILE_SLOTS = SLOTS // 2            # the dp x tp tile at world 2
# device kernels the glue kernels replaced; no profiled step may run one
GLUE_KERNELS = ("CatArrayBatchedCopy", "cos_kernel_cuda", "sin_kernel_cuda",
                "MulFunctor<c10::complex", "hypot", "pow_tensor", "MeanOps")
# the pfb combiner's eager chain (history ++ block, P-1 addcmul_ passes),
# the fine stage's bin gather (advanced indexing), and what pfb_bins
# folds in: cuFFT's inverse FFT, the rotation's complex multiply and the
# time-major combiner pfb_rows; the pfb step's profile may run none of
# them, nor any kernel P-1 times
PFB_GLUE = ("CatArrayBatchedCopy", "addcmul", "gpu_index_kernel", "fft",
            "MulFunctor<c10::complex", "pfb_rows_kernel")
# grouped conv1d yardstick of the pfb rows against the kernel's (cuDNN's
# float32 sum order), × max|v|
PFB_CONV_REL = 1e-4
CQ_NOISE_AGREE = 0.99              # CQPSK tracker on noise: emit masks
# first NOISE_SYM_N symbols within NOISE_SYM_ATOL on this share of the
# noise lanes. No all-lane bound here: a differential phase near the ±4
# branch cut that a ~1e-7 difference moves across changes by ~8.
CQ_SYM_LANES = 0.995
# site runtime path
VOICE_REL_TOL = 1e-5       # fm_voice audio on signal lanes, × max|audio|
POWER_REL_TOL = 1e-5       # fm_voice power, relative
# Noise lanes of the fm_voice check: where a phase step sits near ±π the
# two atan2f calls may land on opposite sides of the branch cut and the
# discriminator differs by 2π·gain at that sample (then decays through
# the IIR, z1 ≈ 0.57). This share of noise-lane samples is held to the
# signal lanes' bound.
VOICE_NOISE_SHARE = 0.99
VOICE_MAX_DEV = 5000.0     # AnalogVoicePipeline's discriminator scale
RT_CENTER = 857.0e6
RT_P25_CC, RT_P25_VC = 857.5e6, 856.2e6
RT_EDACS_CC, RT_EDACS_VC = 857.8e6, 856.6e6
RT_SECONDS = 2.0           # the decode phase's capture
RT_KEYUP_S = 0.3           # EDACS voice carrier keys up after the grant
RT_STARVE_BLOCK = 12       # source 1 delivers nothing in this block
TONE_HZ = 1000.0
RT_BENCH_STEPS = 30
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W) for each kernel's bound
BF16_PEAK = 989e12         # FLOP/s, tensor cores
F32_PEAK = 67e12           # FLOP/s, CUDA cores
HBM_RATE = 3.35e12         # bytes/s
# Lower bounds on the trackers' arithmetic per lane-sample (complex
# conjugate product, atan2, filters, loop updates); their bound is the
# bytes either way.
FSK_OPS = 20
CQPSK_OPS = 40
VOICE_OPS = 10
RAGGED_SLOTS = 40          # a lane count off the fsk tracker's 32-slot tile
PFB_ROWS = 64              # pfb fine-stage rows held to the plain version
# pfb_bins beside the bench shape: (M, wire) of the pfb mode's 80 dB banks
# at M · BIN_RATE, PFB_BINS_SOURCES sources × 100 ms
BIN_RATE = 400e3
PFB_BINS_CASES = ((8, "complex64"), (16, "float32"), (20, "bfloat16"),
                  (25, "bfloat16"), (50, "bfloat16"), (100, "float32"))
PFB_BINS_SOURCES = 16
LIVE_PFB_RATE = 10e6       # configs/config_example_live.py's bladerf: M = 25
CLOCK_RUN_S = 1.0          # tracker run while nvidia-smi samples clocks
# the scan slice (scan/, tools/file_to_wav.py)
SCAN_CENTER = 857.0e6
SCAN_CC = 857.5e6          # the P25 site's control channel (test_scan.py)
SCAN_ANALOG = 856.7e6      # bench capture: an analog FM tone, -300 kHz
SCAN_VOICE = 857.1e6       # bench capture: P25 LDU1 voice, +100 kHz
SCAN_BENCH_S = 10.0        # spectrum, run_fft_scan and file_to_wav
SCAN_TRIAL_S = 2.0         # the trial bank and the band scan
TRIAL_SLOTS = 64           # trial_p25_lock's max_slots
BAND_PASS = 40             # run_band_scan's slots a pass (ov_scan.py:34)
SCAN_CHANNELS = 40         # the conventional scanner's channels
OFFSET_TOL_HZ = 1.0        # trial offsets, card vs CPU
# live SDR ingest (frontend/ingest.py, rtl_tcp.py, rciq.py) and L7
LIVE_DECODE_S = 3.0        # real-time stream through rt.run per decode
LIVE_WAIT_S = 20.0         # deadline on a live phase's waits
LIVE_GAP = 3               # blocks the driver host leaves out
LIVE_AFTER_BLOCKS = 15     # blocks run after the stream resumes
LIVE_CADENCE_TOL_S = 0.02  # zero-filled blocks' spacing against a block
LIVE_BENCH_SOURCES = (8, 32, 128)
LIVE_BENCH_S = 10.0
LIVE_WARM_STEPS = 5
LIVE_SPAWN_S = 120.0       # the senders' child processes starting
LIVE_SENDERS_PER_PROC = 16
SOAK_TARGET = 256
SOAK_TIMEOUT_S = 420
LONGEVITY_S = 30.0
LONGEVITY_FLAT_FROM = 10   # cycles before memory_allocated is held flat
# the mesh slice (parallel/mesh.py, entry.dryrun_multichip)
MESH_SMALL = ((1, 5, 37), (2, 40, 200), (3, 64, 1250))   # (S, C, M) streams
MESH_WORLDS = (1, 2)       # ranks on the one card: NCCL at 1, gloo at 2
MESH_BENCH_STEPS = 30      # timed steps per world and step, for p50/p95
MESH_TIMED_STEPS = 3       # steps with the communicator timing each op
MESH_WARM_STEPS = 3
# The time-sharded pre-scan stream of the grant lane, card vs CPU: the
# complex bank's FMA chain against the CPU's GEMM (float32, sum order
# only, within COMPLEX_REL_TOL of |y|), through the discriminator's gain
# (~6.6 at 25 kS/s) and the boxcar: the pipeline's float32 tolerance
# (test_ops_channelizer.py:28).
MESH_TRK_ATOL = 2e-3
# The analog WAV, card vs CPU: the card's bank takes bf16 operands, so
# its channels are within BANK_REL_TOL of the CPU's; the FM discriminator
# sees that as phase noise. Held as a share of PCM full scale.
WAV_REL_TOL = BANK_REL_TOL


def log(*parts):
    print(*parts, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, timed with CUDA events after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (nested tuples), each storage
    counted once: what a kernel reads and writes at the least."""
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            seen[(o.data_ptr(), o.numel())] = o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            for x in o:
                walk(x)
    walk(objs)
    return sum(seen.values())


def bound(ops: float, peak: float, nbytes: int) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it:
    operations over the peak for their type, or bytes over HBM_RATE."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def grid_offsets(n_sources: int, dev,
                 samp_rate: float = SAMP_RATE) -> torch.Tensor:
    """bench.py's slot grid: 25 kHz spacing around the centre."""
    offs = ((np.arange(SLOTS) - SLOTS // 2) * 25e3 / samp_rate).astype(
        np.float32)
    return torch.as_tensor(np.tile(offs, (n_sources, 1)), device=dev)


# the main path's kernels (``fsk_track_stream`` is the second entry of
# ``csrc/fsk_track.cu``), each counted in ``launch.<name>``
KERNELS = ("bank_operands", "xlat_bank", "fsk_track", "xlat_complex", "agc",
           "cqpsk_track", "fm_voice", "fsk_track_stream", "pfb_rows",
           "pfb_bins", "pfb_fine")


def kernel_counts() -> dict:
    """Launch counts of the main path's kernels since the last reset."""
    from radiocapture_tpu_torch.utils import trace
    return {k: trace.counter(f"launch.{k}") for k in KERNELS}


def reset_kernel_counts() -> None:
    from radiocapture_tpu_torch.utils import trace
    trace.reset("launch.")


def check_bank(got, want, what: str) -> float:
    """Bank kernel planes vs the plain version's within
    BANK_REL_TOL·max|y|; returns max |err|."""
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ok = err <= BANK_REL_TOL * scale
    log(f"bank kernel vs plain: {what} max_abs_err={err:.3e} "
        f"tol={BANK_REL_TOL * scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bank kernel disagrees with plain")
    return err


def check_track_noise(got, want, what: str,
                      lane_share: float = 1.0) -> float:
    """Tracker kernel vs plain on noise lanes, (syms, valid) [S, C, M]:
    emit masks agree on NOISE_VALID_AGREE of samples; the first
    NOISE_SYM_N symbols are within NOISE_SYM_ATOL on ``lane_share`` of
    the lanes and within NOISE_SYM_BOUND on all. Returns the max |err|
    of those symbols."""
    agree = float(np.mean(got[1] == want[1]))
    head = np.abs(got[0][..., :NOISE_SYM_N]
                  - want[0][..., :NOISE_SYM_N]).max(-1)     # [S, C]
    share = float(np.mean(head <= NOISE_SYM_ATOL))
    worst = float(head.max())
    ok = (agree >= NOISE_VALID_AGREE and share >= lane_share
          and worst <= NOISE_SYM_BOUND)
    log(f"tracker kernel vs plain: {what}: valid agreement {agree:.5f} "
        f"(>= {NOISE_VALID_AGREE}); first {NOISE_SYM_N} syms within "
        f"{NOISE_SYM_ATOL} on {share:.5f} of {head.size} lanes "
        f"(>= {lane_share}), max_abs_err={worst:.3e} "
        f"(<= {NOISE_SYM_BOUND}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("tracker kernel disagrees with plain on noise")
    return worst


def phase_bank(dev, pipe) -> float:
    """Bank kernel vs plain on mid-stream inputs: the 100 ms block, ragged
    N (off the 128-row tile) and slot counts off and over the 64-slot
    group, with z2 one sample short of whole 2D-value rows (the wrapper
    copies it into rows); returns max |err|."""
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    bank = pipe.bank
    p, d = bank.p, bank.decim
    rng = np.random.default_rng(1)
    worst = 0.0
    for s, n, c in ((1, BLOCK // d, SLOTS), (2, 1001, 40), (3, 37, 5),
                    (2, 777, 2 * SLOTS)):
        length = (n * d + bank.ntaps - 1) * 2
        z2 = torch.as_tensor(rng.standard_normal((s, length)).astype(
            np.float32), device=dev).to(torch.bfloat16)
        offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, c)).astype(
            np.float32), device=dev)
        g2 = ck.tap_matrix(bank.taps, offs, p, d, torch.bfloat16)
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)),
                                 dtype=torch.int64, device=dev)
        step = phase_step_u32(offs, d)
        got = ck.bank_fused(z2, ck.kernel_taps(g2, p, d), phase0, step, n,
                            p, d)
        want = ck.bank_fused_plain(z2, g2, phase0, step, n, p, d)
        worst = max(worst, check_bank(
            got, want, f"S={s} N={n} P={p} D={d} C={c}"))
    return worst


def run_tracker(track_fn, planes, state, prm):
    """Stream [S, N, C] planes block by block through a tracker; returns
    the concatenated (syms, valid, dibits) [S, C, M] as numpy."""
    quad, sh, fs = state
    outs = []
    for y_re, y_im in planes:
        quad, sh, fs, sy, va, di = track_fn(y_re, y_im, quad, sh, fs, prm)
        outs.append((sy, va, di))
    return [torch.cat([o[i] for o in outs], -1).cpu().numpy()
            for i in range(3)]


def fresh_lanes(s, c, prm, dev):
    """Zero tracker lane state for [S, C] lanes of ``prm``."""
    from radiocapture_tpu_torch.demod import fsk4 as K
    from radiocapture_tpu_torch.ops import fm
    return (fm.quad_demod_init((s, c), dev),
            torch.zeros((s, c, len(prm.sym_taps) - 1), device=dev),
            K.fsk4_init((s, c), dev))


def phase_tracker(dev, pipe) -> float:
    """Tracker kernel vs plain: identical dibits on a modulated P25
    fixture (four blocks in a row); stated agreement on noise with the
    P25 and the EDACS parameters (NT 3 at sym_decim 2, NT 1 at 1) and at
    a lane count off the 32-slot tile. Returns max |err| of syms over the
    compared ranges."""
    from radiocapture_tpu_torch.demod import track_kernel as tk
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    prm = pipe.track_params
    nb = BLOCK // pipe.decim

    dibits, expected = streams.p25_control_stream(
        8, channel=0x1000, group=100, source=555000)
    iq = M.c4fm_modulate(dibits, fs=pipe.channel_fs)
    iq2 = M.awgn(M.freq_shift(iq, pipe.channel_fs, 240.0), 30.0)
    n = len(iq) // nb * nb
    lanes = np.stack([iq[:n], iq2[:n]], -1)[None]          # [1, n, 2]
    planes = [(torch.as_tensor(lanes[:, i:i + nb].real.copy(), device=dev),
               torch.as_tensor(lanes[:, i:i + nb].imag.copy(), device=dev))
              for i in range(0, n, nb)]
    got = run_tracker(tk.track, planes, fresh_lanes(1, 2, prm, dev), prm)
    want = run_tracker(tk.track_plain, planes, fresh_lanes(1, 2, prm, dev),
                       prm)
    for lane in range(2):
        gd = got[2][0, lane][got[1][0, lane].astype(bool)]
        wd = want[2][0, lane][want[1][0, lane].astype(bool)]
        if not np.array_equal(gd, wd):
            raise AssertionError(f"tracker dibits differ on fixture lane "
                                 f"{lane}: {len(gd)} vs {len(wd)}")
        g = streams.grants(gd)
        if len(g) < 4 or not all(x in expected for x in g):
            raise AssertionError(f"fixture lane {lane} decoded {g}")
    err = float(np.abs(got[0] - want[0]).max())
    log(f"tracker kernel vs plain: P25 fixture {n} samples x 2 lanes "
        f"in {len(planes)} blocks: compacted dibits identical, "
        f"{len(g)} grants, max_abs_err(syms)={err:.3e} ok")

    rng = np.random.default_rng(2)
    edacs = ControlPipeline.edacs(SLOTS, SAMP_RATE).track_params
    # the ragged case has enough lanes (320) that BENCH_SYM_LANES lets one
    # drift past NOISE_SYM_ATOL, as lanes do at the bench shape
    for name, p, s, c, share in (
            ("P25", prm, 2, SLOTS, 1.0), ("EDACS", edacs, 2, SLOTS, 1.0),
            ("P25", prm, 8, RAGGED_SLOTS, BENCH_SYM_LANES)):
        noise = [tuple(torch.as_tensor(rng.standard_normal(
            (s, nb, c)).astype(np.float32), device=dev) for _ in range(2))]
        got = run_tracker(tk.track, noise, fresh_lanes(s, c, p, dev), p)
        want = run_tracker(tk.track_plain, noise, fresh_lanes(s, c, p, dev),
                           p)
        err = max(err, check_track_noise(
            got, want, f"{name} noise S={s} C={c} N={nb}", share))
    return err


def frontend_block(pipe, samp_rate: float = SAMP_RATE) -> int:
    """The pipeline's block: 100 ms where its block multiple divides it
    (xlat, pfb; BLOCK at 2.4 MS/s), else one multiple (fft: 390336
    samples, 162.6 ms)."""
    bm = pipe.block_multiple
    return bm * max(1, round(samp_rate * 0.1) // bm)


def phase_decode(dev, pipe, what: str = "decode",
                 need=("bank_operands", "xlat_bank", "fsk_track"),
                 keep: dict | None = None) -> dict:
    """The port's main path: 4 sources × 64 slots at 2.4 MS/s, bf16 wire
    blocks, P25 control channel at +50 kHz on source 0 and −300 kHz on
    source 3, through ``pipe`` (its frontend's bank). Fails unless every
    kernel in ``need`` ran. Returns the kernels' launch counts of this
    run; ``keep`` takes the fixture slots' dibits and valid flags."""
    from radiocapture_tpu_torch.device import complex_to_wire
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    n_src = 4
    blk = frontend_block(pipe)
    dibits, expected = streams.p25_control_stream(
        8, channel=0x1000, group=100, source=555000)
    up = M.upsample_to(M.c4fm_modulate(dibits, fs=25000.0), 25000.0,
                       SAMP_RATE)
    n_blocks = -(-len(up) // blk) + 1
    n = n_blocks * blk
    placed = {0: 50e3, 3: -300e3}
    wide = np.stack([
        M.multi_channel(SAMP_RATE, [(placed[i], up)] if i in placed else [],
                        n, rng=np.random.default_rng(10 + i))
        for i in range(n_src)])
    offs = grid_offsets(n_src, dev)
    slot = {i: int(round(f / 25e3)) + SLOTS // 2 for i, f in placed.items()}
    state = pipe.init(n_src, dev)
    reset_kernel_counts()
    dib, val = [], []
    t0 = time.perf_counter()
    for b in range(n_blocks):
        xb = complex_to_wire(wide[:, b * blk:(b + 1) * blk], dev)
        state, (syms, valid, dibs) = pipe.step(state, xb, offs)
        dib.append(dibs.cpu().numpy())
        val.append(valid.cpu().numpy())
        if not bool(torch.isfinite(syms).all()):
            raise AssertionError("non-finite symbols")
    torch.cuda.synchronize()
    launches = kernel_counts()
    dt = time.perf_counter() - t0
    dib, val = np.concatenate(dib, -1), np.concatenate(val, -1)
    if dib.shape != (n_src, SLOTS, n // (pipe.decim * pipe.sym_decim)):
        raise AssertionError(f"output shape {dib.shape}")
    if keep is not None:
        keep.update({(i, c): (dib[i, c], val[i, c]) for i, c in slot.items()})
    for i, c in slot.items():
        g = streams.grants(dib[i, c][val[i, c].astype(bool)])
        if len(g) < 4 or not all(e in expected for e in g):
            raise AssertionError(f"source {i} slot {c}: grants {g}")
        log(f"{what}: source {i} slot {c} ({placed[i] / 1e3:+.0f} kHz): "
            f"{len(g)} GRP_V_CH_GRANT, first channel={g[0][0]:#x} "
            f"group={g[0][1]} source={g[0][2]} ok")
    log(f"{what}: {type(pipe.bank).__name__}, {n_src} sources x {SLOTS} "
        f"slots x {n_blocks} blocks of {blk} bf16 samples in {dt:.3f} s; "
        f"launches {launches}")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return launches


def profile_steps(step, what: str, forbid: tuple = (), most: int = 0,
                  kernels: list | None = None) -> float:
    """``torch.profiler`` over PROFILE_STEPS steady-state calls of
    ``step()``: logs the device kernels and copies by time per step (share
    of all device time). Fails if a device kernel's name holds one of
    ``forbid``, or, with ``most``, if one runs ``most`` times a step or
    more. With ``kernels``, appends each device kernel's (full name,
    launches a step, ms a step) to it. Returns the device busy share:
    kernel time (copies excluded) over wall time, profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    kern = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    dev_ms = (sum(e.self_device_time_total for e in kern) / 1e3
              / PROFILE_STEPS)
    copy_ms = (sum(e.self_device_time_total for e in dev if e not in kern)
               / 1e3 / PROFILE_STEPS)
    if dev_ms <= 0.0:
        raise AssertionError("the profiler saw no device kernel")
    if kernels is not None:
        kernels.extend((e.key, e.count / PROFILE_STEPS,
                        e.self_device_time_total / 1e3 / PROFILE_STEPS)
                       for e in kern)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    log(f"profile: {what}: {PROFILE_STEPS} steps, wall {wall_ms:.3f} ms/step "
        f"(profiler on), device kernels {dev_ms:.3f} ms/step, busy share "
        f"{dev_ms / wall_ms:.3f}, copies {copy_ms:.3f} ms/step, host syncs "
        f"{syncs / PROFILE_STEPS:.1f}/step")
    for e in dev[:PROFILE_ROWS]:
        ms = e.self_device_time_total / 1e3 / PROFILE_STEPS
        log(f"profile: {what}: {ms:8.3f} ms/step "
            f"{100 * ms / (dev_ms + copy_ms):5.1f}% "
            f"x{e.count / PROFILE_STEPS:<4.1f} {e.key[:90]}")
    if forbid:
        found = [e.key for e in dev if any(f in e.key for f in forbid)]
        log(f"profile: {what}: {len(dev)} device kernels, none of "
            f"{list(forbid)}: {'ok' if not found else found}")
        if found:
            raise AssertionError(f"{what}: the step ran {found}")
    if most:
        many = [(e.key[:60], e.count / PROFILE_STEPS) for e in dev
                if e.count >= most * PROFILE_STEPS]
        log(f"profile: {what}: no device kernel {most} times a step or "
            f"more: {'ok' if not many else many}")
        if many:
            raise AssertionError(f"{what}: the step ran {many}")
    return dev_ms / wall_ms


def bank_at_bench(dev, bank, state, x2, offs, what: str
                  ) -> tuple[dict, float]:
    """The bank kernel on the operands a pipeline step builds from a
    mid-stream state: its ms beside the plain version's, its bound, and
    the library yardstick (one bf16 ``torch.bmm`` of the window matrix,
    materialised outside the timed region, by the tap matrix: the GEMM
    without the rotation, bf16 out). Returns (numbers, max |err|)."""
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    p, d = bank.p, bank.decim
    n = x2.shape[1] // d
    z2, gk, step = bank.operands(state, x2, offs)
    g2 = ck.tap_matrix(bank.device_taps(dev), offs, p, d, torch.bfloat16)
    phase0 = state.phase
    s, c = phase0.shape

    def new():
        return ck.bank_fused(z2, gk, phase0, step, n, p, d)

    res = {"bank_ms": cuda_ms(new, 10), "bank_plain_ms": cuda_ms(
        lambda: ck.bank_fused_plain(z2, g2, phase0, step, n, p, d), 3)}
    got = new()
    err = check_bank(got, ck.bank_fused_plain(z2, g2, phase0, step, n, p, d),
                     f"{what} S={s} N={n} D={d} C={c}")
    win = z2.as_strided((s, n, p * 2 * d), (z2.stride(0), 2 * d, 1)
                        ).contiguous().to(torch.bfloat16)
    res["bank_library_ms"] = cuda_ms(lambda: torch.bmm(win, g2), 10)
    del win
    flops = 2.0 * s * n * (p * 2 * d) * (2 * c)
    res["bank_bound_ms"], res["bank_bound_by"] = bound(
        flops, BF16_PEAK, tensor_bytes(z2, gk, phase0, step, got))
    res["bank_share_of_bound"] = res["bank_bound_ms"] / res["bank_ms"]
    log(f"bank kernel: {what} S={s} N={n} D={d} P={p} C={c}: "
        f"{res['bank_ms']:.4f} ms, bound {res['bank_bound_ms']:.4f} ms "
        f"({res['bank_bound_by']}, {flops:.4g} FLOP), share of bound "
        f"{res['bank_share_of_bound']:.3f}; library (bf16 bmm, no "
        f"rotation) {res['bank_library_ms']:.4f} ms; plain "
        f"{res['bank_plain_ms']:.3f} ms")
    return res, err


def track_vs_plain(y_re, y_im, state_fn, prm, what: str):
    """The fsk tracker kernel on [S, N, C] planes from ``state_fn()``
    (fresh copies: the kernel updates lane state in place), timed by CUDA
    events, and its plain version timed by the host clock; the noise
    checks at BENCH_SYM_LANES. Returns (kernel ms, plain ms, max |err|,
    the kernel's outputs)."""
    from radiocapture_tpu_torch.demod import track_kernel as tk
    timed = state_fn()
    ms = cuda_ms(lambda: tk.track(y_re, y_im, *timed, prm), 5)
    got = tk.track(y_re, y_im, *state_fn(), prm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tk.track_plain(y_re, y_im, *state_fn(), prm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_track_noise([o.cpu().numpy() for o in got[3:]],
                            [o.cpu().numpy() for o in want[3:]], what,
                            BENCH_SYM_LANES)
    return ms, plain_ms, err, got


def sm_clock_mhz(run) -> list:
    """SM clock readings (MHz) that ``nvidia-smi`` takes every 50 ms while
    ``run()`` keeps the card busy."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    return [float(v) for v in out.split() if v.replace(".", "").isdigit()]


def chain_floor(name: str, probe, n: int, unit: str, launch) -> tuple:
    """A tracker's latency floor: the median of 5 runs of ``probe()`` (the
    clock64() cycles of its feedback loop alone, one warp, for n ``unit``)
    over the median SM clock that ``nvidia-smi`` reads while ``launch()``
    runs the tracker back to back for CLOCK_RUN_S (a lone warp runs the
    card at a lower clock, so the probe's own time would not say it).
    Returns (floor ms, how it was computed, cycles, the clock readings)."""
    probe()                                                   # warm-up
    cycles = sorted(probe() for _ in range(5))
    once = cuda_ms(launch, 3)
    reps = max(1, int(CLOCK_RUN_S * 1e3 / once))

    def run():          # outputs dropped as they come
        for _ in range(reps):
            launch()

    clocks = sm_clock_mhz(run)
    if not clocks:
        raise AssertionError("nvidia-smi read no SM clock")
    mhz = float(np.median(clocks))
    cyc = cycles[len(cycles) // 2]
    floor_ms = cyc / (mhz * 1e6) * 1e3
    how = (f"clock64 probe: {cyc} cycles for {n} {unit} "
           f"({cyc / n:.1f} per sample) / {mhz:.0f} MHz SM clock "
           f"(nvidia-smi median of {len(clocks)} readings during the "
           f"kernel)")
    log(f"tracker floor: {name}: {how} = {floor_ms:.4f} ms; cycles of 5 "
        f"runs {cycles}")
    return floor_ms, how, cyc, clocks


def track_floor(y_re, y_im, state_fn, prm) -> dict:
    """The fsk tracker's latency floor at this shape (``chain_floor``):
    ``track_kernel.chain_probe`` replays the boxcar outputs of 32 bench
    lanes from shared memory for the block's M tracked samples."""
    from radiocapture_tpu_torch.demod import track_kernel as tk
    from radiocapture_tpu_torch.ops import fm
    from radiocapture_tpu_torch.ops.fir import batched_fir
    quad, sym_hist, _ = state_fn()
    m = y_re.shape[1] // prm.sym_decim
    x = torch.complex(y_re[0, :, :32], y_im[0, :, :32]).T     # [32, N]
    _, disc = fm.quadrature_demod(fm.QuadDemodState(quad.prev[0, :32]), x,
                                  prm.gain)
    _, xn = batched_fir(sym_hist[0, :32], disc, prm.sym_taps, prm.sym_decim)
    rows = xn[:, :tk.PROBE_ROWS].T.contiguous()
    timed = state_fn()
    floor_ms, how, cyc, clocks = chain_floor(
        "fsk_track", lambda: tk.chain_probe(rows, m, prm), m,
        "tracked samples", lambda: tk.track(y_re, y_im, *timed, prm))
    return {"track_floor_ms": floor_ms, "track_floor_how": how,
            "track_chain_cycles": cyc, "sm_clock_mhz": clocks}


def phase_bench(dev, pipe) -> tuple[dict, float, float]:
    """bench.py's shape: 128 sources × 64 slots × 240,000 bf16 samples.
    Times the step and each kernel beside its plain version, and holds
    each kernel's output at this shape against the plain version's.
    Returns (timings, bank max |err|, tracker max |err|)."""
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    s = BENCH_SOURCES
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(s, dev)
    state = pipe.init(s, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        state, out = pipe.step(state, x, offs)
    torch.cuda.synchronize()
    win_ms = []
    for _ in range(5):
        win_ms.append(cuda_ms(lambda: pipe.step(state, x, offs), 5))
    peak = torch.cuda.max_memory_allocated(dev)
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        state, out = pipe.step(state, x, offs)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    box = [state]

    def one_step():
        box[0] = pipe.step(box[0], x, offs)[0]

    busy = profile_steps(one_step, "c4fm", GLUE_KERNELS)
    state = box[0]
    med, mn = float(np.median(win_ms)), min(win_ms)
    res = {"step_ms_median": med, "step_ms_min": mn,
           "msps_median": s * BLOCK / med / 1e3,
           "msps_best": s * BLOCK / mn / 1e3,
           "latency_p50_ms": lat[len(lat) // 2],
           "latency_p95_ms": lat[int(len(lat) * 0.95)],
           "peak_mem_bytes": peak, "profile_busy_share": busy}

    # each kernel beside its plain version, on the operands the step
    # builds, from the mid-stream state
    bank_res, bank_err = bank_at_bench(dev, pipe.bank, state.bank, x, offs,
                                       "c4fm bench shape")
    res.update(bank_res)
    n = BLOCK // pipe.decim
    z2, gk, step = pipe.bank.operands(state.bank, x, offs)
    y_re, y_im = ck.bank_fused(z2, gk, state.bank.phase, step, n,
                               pipe.bank.p, pipe.decim)
    prm = pipe.track_params

    def lane_state():   # the kernel updates its lane state in place
        return (state.quad._replace(prev=state.quad.prev.clone()),
                state.sym_hist.clone(),
                type(state.fsk4)(*(t.clone() for t in state.fsk4)))

    (res["track_ms"], res["track_plain_ms"], track_err,
     got) = track_vs_plain(y_re, y_im, lane_state, prm,
                           f"bench shape S={s} C={SLOTS} N={n}")
    res["track_bound_ms"], res["track_bound_by"] = bound(
        FSK_OPS * y_re.numel(), F32_PEAK,
        tensor_bytes(y_re, y_im, lane_state(), got))
    res.update(track_floor(y_re, y_im, lane_state, prm))
    # the EDACS parameters (NT 1, sym_decim 1: 2500 tracked samples per
    # lane) and a lane count off the 32-slot tile, on the same planes
    edacs = ControlPipeline.edacs(SLOTS, SAMP_RATE).track_params
    (res["track_edacs_ms"], res["track_edacs_plain_ms"], err,
     _) = track_vs_plain(y_re, y_im,
                         lambda: fresh_lanes(s, SLOTS, edacs, dev), edacs,
                         f"EDACS bench shape S={s} C={SLOTS} N={n}")
    track_err = max(track_err, err)
    res["track_edacs_floor_ms"] = track_floor(
        y_re, y_im, lambda: fresh_lanes(s, SLOTS, edacs, dev),
        edacs)["track_floor_ms"]
    c = RAGGED_SLOTS
    r_re, r_im = (y[..., :c].contiguous() for y in (y_re, y_im))

    def ragged_state():
        return tuple(type(t)(*(v[:, :c].contiguous() for v in t))
                     if isinstance(t, tuple) else t[:, :c].contiguous()
                     for t in lane_state())

    (res["track_ragged_ms"], res["track_ragged_plain_ms"], err,
     _) = track_vs_plain(r_re, r_im, ragged_state, prm,
                         f"bench shape S={s} C={c} N={n}")
    track_err = max(track_err, err)
    log("bench: " + json.dumps({"sources": s, "slots": SLOTS,
                                "block": BLOCK, "wire": "bf16",
                                "window_step_ms": win_ms, **res}))
    log(f"bench: step median {med:.3f} ms (min {mn:.3f}) = "
        f"{res['msps_median']:.1f} MS/s; latency p50 "
        f"{res['latency_p50_ms']:.3f} / p95 {res['latency_p95_ms']:.3f} ms "
        f"vs {DEADLINE_MS:.0f} ms deadline; bank {res['bank_ms']:.3f} ms "
        f"(plain {res['bank_plain_ms']:.3f}); track {res['track_ms']:.3f} "
        f"ms (plain {res['track_plain_ms']:.1f}, bound "
        f"{res['track_bound_ms']:.3f}, floor {res['track_floor_ms']:.3f}); "
        f"EDACS track {res['track_edacs_ms']:.3f} ms (floor "
        f"{res['track_edacs_floor_ms']:.3f}); bank bound "
        f"{res['bank_bound_ms']:.3f} ms, library "
        f"{res['bank_library_ms']:.3f} ms; peak {peak / 2 ** 30:.2f} GiB")
    return res, bank_err, track_err


def turns(plain, kernel, iters: int) -> dict:
    """``plain`` and ``kernel`` timed in turns (plain, kernel, kernel,
    plain; CUDA events, ``iters`` calls each)."""
    t = [cuda_ms(f, iters) for f in (plain, kernel, kernel, plain)]
    return {"plain_turns_ms": [t[0], t[3]], "kernel_turns_ms": [t[1], t[2]],
            "speedup": (t[0] + t[3]) / (t[1] + t[2])}


def check_operands(bank, state, x, offs, what: str) -> dict:
    """The operands kernel (``XlatBank.operands``) against
    ``operands_plain`` on one block: z2 and the phase step bit-identical,
    g2 bit-identical up to the sign of zero, and the wire bank's outputs on
    the two operand sets bit-identical. Times the two in turns, each part
    of the kernel alone (the taps and step, the z2 rows), beside their
    bytes bounds."""
    from radiocapture_tpu_torch import kernels
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    p, d = bank.p, bank.decim
    taps = bank.device_taps(x.device)
    z2, g2, step = bank.operands(state, x, offs)
    pz2, pg2, pstep = bank.operands_plain(state, x, offs)
    z_same = torch.equal(z2.view(torch.int16), pz2.view(torch.int16))
    diff = g2.view(torch.int16) != pg2.view(torch.int16)
    signs = int(diff.sum())
    g_same = torch.equal(g2, pg2) and bool(
        (g2[diff] == 0).all() and (pg2[diff] == 0).all())
    s_same = torch.equal(step, pstep)
    n = x.shape[1] // d
    y = ck.bank_fused(z2, g2, state.phase, step, n, p, d)
    py = ck.bank_fused(pz2, pg2, state.phase, pstep, n, p, d)
    y_same = all(torch.equal(a, b) for a, b in zip(y, py))
    err = max(float((z2.float() - pz2.float()).abs().max()),
              float((g2.float() - pg2.float()).abs().max()))
    res = turns(lambda: bank.operands_plain(state, x, offs),
                lambda: bank.operands(state, x, offs), 10)
    lib = kernels.load()
    part_ms, part_bytes = {}, {}
    for part, name, tensors in ((1, "taps", (offs, taps, g2, step)),
                                (2, "rows", (state.history, x, z2))):
        args, _ = ck.operands_args(state.history, x, offs, taps, p, d, part)
        part_ms[name] = cuda_ms(lambda: kernels.check(
            lib.bank_operands_launch(*args), "bank_operands"), 10)
        part_bytes[name] = tensor_bytes(*tensors)
    nbytes = tensor_bytes(state.history, x, offs, taps, z2, g2, step)
    res.update({"ms": res["kernel_turns_ms"][0],
                "plain_ms": res["plain_turns_ms"][0],
                "bound_ms": nbytes / HBM_RATE * 1e3, "bound_by": "bytes",
                "max_abs_err": err, "g2_sign_of_zero_bits": signs,
                "taps_ms": part_ms["taps"], "rows_ms": part_ms["rows"],
                "taps_bound_ms": part_bytes["taps"] / HBM_RATE * 1e3,
                "rows_bound_ms": part_bytes["rows"] / HBM_RATE * 1e3})
    ok = z_same and g_same and s_same and y_same
    log(f"operands kernel: {what} S={x.shape[0]} T={x.shape[1]} "
        f"{str(x.dtype).split('.')[-1]} wire C={offs.shape[1]} K={bank.ntaps}"
        f": z2 identical {z_same}, g2 identical {g_same} ({signs} "
        f"sign-of-zero bits), step identical {s_same}, xlat_bank outputs "
        f"identical {y_same}; eager {res['plain_turns_ms'][0]:.4f}, kernel "
        f"{res['kernel_turns_ms'][0]:.4f}, {res['kernel_turns_ms'][1]:.4f}, "
        f"eager {res['plain_turns_ms'][1]:.4f} ms: {res['speedup']:.2f}x; "
        f"bound "
        f"{res['bound_ms']:.4f} ms ({nbytes} B), share "
        f"{res['bound_ms'] / res['ms']:.3f}; taps part alone "
        f"{res['taps_ms']:.4f} ms (bound {res['taps_bound_ms']:.4f}), rows "
        f"part alone {res['rows_ms']:.4f} ms (bound "
        f"{res['rows_bound_ms']:.4f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("operands kernel differs from operands_plain")
    return res


def mid_state(bank, s: int, c: int, dev, gen):
    """A random mid-stream wire bank state: complex64 history, uint32
    phase."""
    return bank.init(s, dev)._replace(
        history=torch.randn((s, bank.ntaps - 1), dtype=torch.complex64,
                            generator=gen, device=dev),
        phase=torch.randint(0, 2 ** 32, (s, c), generator=gen, device=dev))


def phase_operands_kernel(dev, pipe, sp) -> dict:
    """``operands kernel:`` at the three shapes the main path gives it:
    the C4FM bench (128 sources x 240000 bf16 samples, 64 slots), the
    CQPSK bench (split2's float32 halves, 256 logical sources x 120000
    samples, 64 slots) and the dp x tp tile at world 2 (the C4FM block,
    32 slots), each from a random mid-stream state; and a block shorter
    than K-1 at three sources."""
    from radiocapture_tpu_torch.frontend.pipeline import (
        CqpskControlPipeline, split2_sources)
    s = BENCH_SOURCES
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    bank = pipe.bank
    res = {"c4fm": check_operands(bank, mid_state(bank, s, SLOTS, dev, gen),
                                  x, grid_offsets(s, dev), "c4fm bench")}
    tile = grid_offsets(s, dev)[:, :TILE_SLOTS].contiguous()
    res["tile"] = check_operands(bank, mid_state(bank, s, TILE_SLOTS, dev,
                                                 gen), x, tile,
                                 f"dp x tp tile {TILE_SLOTS} slots")
    short = x[:3, :bank.decim * 7].contiguous()
    check_operands(bank, mid_state(bank, 3, SLOTS, dev, gen), short,
                   grid_offsets(3, dev), "short block")
    cq = CqpskControlPipeline.p25_cqpsk(SLOTS, HALF_RATE)
    _, halves = sp.step(sp.init(s, dev), x)
    xh = split2_sources(halves)
    res["cqpsk"] = check_operands(cq.bank, mid_state(cq.bank, 2 * s, SLOTS,
                                                     dev, gen), xh,
                                  cq_offsets(2 * s, dev), "cqpsk bench")
    return res


def agc_at_bench(y_re, y_im) -> dict:
    """``agc kernel:`` the CQPSK AGC kernel against ``cqpsk.agc_scale`` on
    the bench's bank planes and on small and ragged ones with a silent
    lane: every gain within AGC_REL_TOL relative. Its ms beside the plain
    version's, the bytes bound and ``torch.linalg.vector_norm`` over dim 1
    of each plane (the nearest library form)."""
    from radiocapture_tpu_torch.demod import cqpsk as cq
    from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
    gen = torch.Generator(device=y_re.device).manual_seed(7)
    cases = [(f"S={s} N={n} C={c} silent lane",
              torch.randn((s, n, c), generator=gen, device=y_re.device),
              torch.randn((s, n, c), generator=gen, device=y_re.device))
             for s, n, c in AGC_SMALL]
    for _, a, b in cases:
        a[0, :, 0] = 0.0
        b[0, :, 0] = 0.0
    cases.append((f"bench shape S={y_re.shape[0]} N={y_re.shape[1]} "
                  f"C={y_re.shape[2]}", y_re, y_im))
    worst = worst_abs = 0.0
    for what, a, b in cases:
        got, want = cqk.agc_scale_kernel(a, b), cq.agc_scale(a, b, dim=1)
        rel = float(((got - want).abs() / want.abs()).max())
        worst, worst_abs = max(worst, rel), max(
            worst_abs, float((got - want).abs().max()))
        ok = rel <= AGC_REL_TOL
        log(f"agc kernel vs plain: {what}: max rel err {rel:.3e} "
            f"(<= {AGC_REL_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("agc kernel disagrees with plain")
    res = {"agc_max_rel_err": worst, "agc_max_abs_err": worst_abs,
           "agc_ms": cuda_ms(lambda: cqk.agc_scale_kernel(y_re, y_im), 20),
           "agc_plain_ms": cuda_ms(
               lambda: cq.agc_scale(y_re, y_im, dim=1), 20),
           "agc_library_ms": cuda_ms(lambda: (
               torch.linalg.vector_norm(y_re, dim=1),
               torch.linalg.vector_norm(y_im, dim=1)), 20),
           "agc_bound_ms": tensor_bytes(y_re, y_im, got) / HBM_RATE * 1e3,
           "agc_bound_by": "bytes"}
    log(f"agc kernel: bench shape: {res['agc_ms']:.4f} ms, plain "
        f"{res['agc_plain_ms']:.4f} ms, bound {res['agc_bound_ms']:.4f} ms "
        f"(bytes), share {res['agc_bound_ms'] / res['agc_ms']:.3f}; library "
        f"(vector_norm over dim 1 of each plane) "
        f"{res['agc_library_ms']:.4f} ms; max rel err {worst:.3e}")
    return res


def cqpsk_floor(y_re, y_im, scale, state_fn, baud) -> dict:
    """The CQPSK tracker's latency floor at this shape (``chain_floor``):
    ``cqpsk_kernel.chain_probe`` runs the first 32 lanes from their state
    over PROBE_ROWS gained samples each, replayed from shared memory, for
    the block's N samples: the NCO on every sample and the emit step once
    per symbol."""
    from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
    n = y_re.shape[1]
    st = state_fn()
    lanes = type(st)(*(t[0, :32].contiguous() for t in st))
    rows = [(p[0, :cqk.PROBE_ROWS, :32] * scale[0, None, :32]).contiguous()
            for p in (y_re, y_im)]

    def probe():
        return cqk.chain_probe(*rows, type(lanes)(*(t.clone() for t in lanes)),
                               n, CHANNEL_FS, baud)

    timed = state_fn()
    floor_ms, how, cyc, clocks = chain_floor(
        "cqpsk_track", probe, n, "samples", lambda: cqk.track_cqpsk(
            y_re, y_im, scale, timed, CHANNEL_FS, baud))
    return {"cqpsk_track_floor_ms": floor_ms, "cqpsk_track_floor_how": how,
            "cqpsk_chain_cycles": cyc, "cqpsk_sm_clock_mhz": clocks}


def cq_offsets(n_sources: int, dev) -> torch.Tensor:
    """The CQPSK slot grid: 12.5 kHz spacing around each half's centre,
    ±400 kHz, inside the ±600 kHz split2 passband."""
    offs = ((np.arange(SLOTS) - SLOTS // 2) * CQ_GRID_HZ / HALF_RATE
            ).astype(np.float32)
    return torch.as_tensor(np.tile(offs, (n_sources, 1)), device=dev)


def check_complex_bank(got, want, what: str) -> float:
    """Complex bank kernel vs its plain version within
    COMPLEX_REL_TOL·max|y|; returns max |err|."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = err <= COMPLEX_REL_TOL * scale
    log(f"complex bank kernel vs plain: {what} max_abs_err={err:.3e} "
        f"tol={COMPLEX_REL_TOL * scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("complex bank kernel disagrees with plain")
    return err


def general_turns(what: str, x, hist, grev, phase0, step, d) -> dict:
    """``complex general turns:``: the general path in turns with the one
    it replaced (``tools/xlat_complex_54b2cf5.cu``, the same loop) on the
    same complex64 values, old, new, new, old; fails unless every output
    is bit-identical."""
    from radiocapture_tpu_torch.tools import track_turns
    t = track_turns.complex_turns(track_turns.EARLIER_COMPLEX, x, hist,
                                  grev, phase0, step, d, iters=3,
                                  pairings=("kernel",))
    old = Path(t["other"]).name
    res = {"shape": t["shape"], "other_ms": t["kernel_other_ms"],
           "package_ms": t["kernel_package_ms"],
           "speedup": t["kernel_speedup"],
           "identical_outputs": t["kernel_identical_outputs"],
           "outputs": t["outputs"]}
    log(f"complex general turns: {what} [S, T, C, K, D] {t['shape']}: "
        f"{old} {res['other_ms'][0]:.4f}, kernel {res['package_ms'][0]:.4f}"
        f", {res['package_ms'][1]:.4f}, {old} {res['other_ms'][1]:.4f} ms: "
        f"{res['speedup']:.2f}x; bit-identical outputs "
        f"{res['identical_outputs']} of {res['outputs']}")
    if res["identical_outputs"] != res["outputs"]:
        raise AssertionError(f"complex bank's general path ({what}) differs "
                             f"from the kernel it replaced")
    return res


def phase_complex_bank(dev, sp) -> float:
    """Complex bank kernel vs plain on the operands the split2 step passes
    (the wire block read in place, the complex64 history): split2's taps
    and phase step on one 100 ms block at S = 1 and 2, bf16, float32 and
    complex64 blocks, a ragged N off the kernel's warp tile, and a ragged
    wide cases (C = 40, 64) on the kernel's general path; returns max
    |err|."""
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    rng = np.random.default_rng(5)
    worst = 0.0
    for s, n, k, d, c, wire in ((1, BLOCK // 2, sp.bank.ntaps, 2, 2, "bf16"),
                                (2, BLOCK // 2, sp.bank.ntaps, 2, 2, "f32"),
                                (2, BLOCK // 2, sp.bank.ntaps, 2, 2, "c64"),
                                (3, 1001, sp.bank.ntaps, 2, 2, "bf16"),
                                (3, 1001, 1440, 96, 40, "bf16"),
                                (2, 613, 1440, 96, 64, "f32")):
        x = torch.as_tensor(rng.standard_normal((s, n * d, 2)).astype(
            np.float32), device=dev)
        if wire == "bf16":
            x = x.to(torch.bfloat16)
        elif wire == "c64":
            x = torch.view_as_real(torch.view_as_complex(x))
        hist = torch.as_tensor((rng.standard_normal((s, k - 1))
                                + 1j * rng.standard_normal((s, k - 1))
                                ).astype(np.complex64), device=dev)
        if k == sp.bank.ntaps:
            offs = torch.as_tensor(np.tile(sp.offsets, (s, 1)), device=dev)
            grev = sp.bank.modulated_taps(offs)
        else:
            offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, c)).astype(
                np.float32), device=dev)
            grev = torch.as_tensor(((rng.standard_normal((s, c, k))
                                     + 1j * rng.standard_normal((s, c, k)))
                                    / np.sqrt(k)).astype(np.complex64),
                                   device=dev)
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)),
                                 dtype=torch.int64, device=dev)
        step = phase_step_u32(offs, d)
        worst = max(worst, check_complex_bank(
            ck.bank_complex(x, hist, grev, phase0, step, d),
            ck.bank_complex_plain(ck.complex_z(x, hist), grev, phase0, step,
                                  n, d),
            f"S={s} N={n} K={k} D={d} C={c} {wire} block"))
    return worst


def check_cqpsk_noise(got, want, what: str) -> float:
    """CQPSK tracker kernel vs plain on noise lanes, (syms, valid)
    [S, C, N]: emit masks agree on CQ_NOISE_AGREE of the samples; the
    first NOISE_SYM_N symbols within NOISE_SYM_ATOL on CQ_SYM_LANES of
    the lanes. Returns the max |err| of those symbols."""
    agree = float(np.mean(got[1] == want[1]))
    head = np.abs(got[0][..., :NOISE_SYM_N]
                  - want[0][..., :NOISE_SYM_N]).max(-1)
    share = float(np.mean(head <= NOISE_SYM_ATOL))
    ok = agree >= CQ_NOISE_AGREE and share >= CQ_SYM_LANES
    log(f"cqpsk tracker kernel vs plain: {what}: valid agreement "
        f"{agree:.5f} (>= {CQ_NOISE_AGREE}); first {NOISE_SYM_N} syms "
        f"within {NOISE_SYM_ATOL} on {share:.5f} of {head.size} lanes "
        f"(>= {CQ_SYM_LANES}), max_abs_err={float(head.max()):.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cqpsk tracker kernel disagrees on noise")
    return float(head.max())


def run_cqpsk(track_fn, planes, state, baud):
    """Stream [S, N, C] planes block by block through a CQPSK tracker
    (AGC gain per block); returns (syms, valid, dibits) [S, C, M] numpy."""
    from radiocapture_tpu_torch.demod import cqpsk as cq
    outs = []
    for y_re, y_im in planes:
        scale = cq.agc_scale(y_re, y_im, dim=1)
        state, *out = track_fn(y_re, y_im, scale, state, CHANNEL_FS, baud)
        outs.append(out)
    return [torch.cat([o[i] for o in outs], -1).cpu().numpy()
            for i in range(3)]


def phase_cqpsk_tracker(dev) -> float:
    """CQPSK tracker kernel vs plain at the channel rate, two blocks each:
    the three CQPSK fixtures (4800 Bd) and the Phase 2 superframe
    (6000 Bd) give identical compacted dibits that decode; two noise
    lanes beside each hold the stated agreement. Returns max |err| of
    the compared symbols."""
    from radiocapture_tpu_torch.demod import cqpsk as cq
    from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    rng = np.random.default_rng(6)
    tdma_dib, voice = streams.tdma_superframe()
    cases = [(4800.0, [streams.cqpsk_fixture(k)
                       for k in streams.CQPSK_FIXTURES]),
             (6000.0, [(M.cqpsk_modulate(tdma_dib, fs=CHANNEL_FS,
                                         symbol_rate=6000.0), None)])]
    worst = 0.0
    for baud, fixtures in cases:
        n = max(len(iq) for iq, _ in fixtures) // 2 * 2
        lanes = np.zeros((n, len(fixtures) + 2), np.complex64)
        for i, (iq, _) in enumerate(fixtures):
            lanes[:min(n, len(iq)), i] = iq[:n]
        lanes[:, len(fixtures):] = (rng.standard_normal((n, 2))
                                    + 1j * rng.standard_normal((n, 2)))
        planes = [tuple(torch.as_tensor(np.ascontiguousarray(part(
            lanes[None, b * n // 2:(b + 1) * n // 2])), device=dev)
            for part in (np.real, np.imag)) for b in range(2)]
        shape = (1, lanes.shape[1])
        got = run_cqpsk(cqk.track_cqpsk, planes,
                        cq.cqpsk_init(CHANNEL_FS, baud, shape, dev), baud)
        want = run_cqpsk(cqk.track_cqpsk_plain, planes,
                         cq.cqpsk_init(CHANNEL_FS, baud, shape, dev), baud)
        for i, (_, expected) in enumerate(fixtures):
            gd = got[2][0, i][got[1][0, i].astype(bool)]
            wd = want[2][0, i][want[1][0, i].astype(bool)]
            if not np.array_equal(gd, wd):
                raise AssertionError(f"cqpsk dibits differ: {baud} Bd "
                                     f"lane {i}: {len(gd)} vs {len(wd)}")
            if expected is None:
                if not streams.tdma_voice_ok(streams.tdma_bursts(gd), voice):
                    raise AssertionError("TDMA superframe did not decode")
                what = "TDMA superframe: 12 bursts, voice as sent"
            else:
                g = streams.grants(gd)
                if len(g) < 4 or not all(x in expected for x in g):
                    raise AssertionError(f"cqpsk fixture lane {i}: {g}")
                what = f"{len(g)} grants"
            err = float(np.abs(got[0][0, i] - want[0][0, i]).max())
            worst = max(worst, err)
            log(f"cqpsk tracker kernel vs plain: {baud:.0f} Bd lane {i} "
                f"({n} samples, 2 blocks): compacted dibits identical, "
                f"{what}, max_abs_err(syms)={err:.3e} ok")
        noise = np.s_[:, len(fixtures):]
        worst = max(worst, check_cqpsk_noise(
            [got[0][noise], got[1][noise]], [want[0][noise], want[1][noise]],
            f"{baud:.0f} Bd noise lanes"))
    return worst


def phase_split2_decode(dev, sp) -> dict:
    """The split2 → CQPSK path: two physical 2.4 MS/s complex64 sources
    through ``SpectrumSplit2.step`` into four 1.2 MS/s halves, then
    ``p25_cqpsk(64, 1.2e6)`` and its ``tdma=True`` variant. CQPSK control
    channels sit in half 0 of source 0 at −75 kHz (NAC 0x293) and in
    half 1 of source 1 at +50 kHz (NAC 0x123); a 6000 Bd Phase 2
    superframe in half 1 of source 0 at +125 kHz. Returns the kernels'
    launch counts of this run."""
    from radiocapture_tpu_torch.frontend.pipeline import (
        CqpskControlPipeline, split2_sources)
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    n_src = 2
    dib_a, exp_a = streams.p25_control_stream(8, nac=0x293)
    dib_b, exp_b = streams.p25_control_stream(8, nac=0x123, channel=0x3000,
                                              group=300, source=888000)
    dib_t, voice = streams.tdma_superframe()

    def up(dib, baud):
        return M.upsample_to(M.cqpsk_modulate(dib, fs=CHANNEL_FS,
                                              symbol_rate=baud),
                             CHANNEL_FS, SAMP_RATE)

    sigs = {"a": up(dib_a, 4800.0), "b": up(dib_b, 4800.0),
            "tdma": up(dib_t, 6000.0)}
    # (physical source, half, offset from the half's centre)
    place = {"a": (0, 0, -75e3), "b": (1, 1, 50e3), "tdma": (0, 1, 125e3)}
    n_blocks = -(-max(map(len, sigs.values())) // BLOCK) + 1
    n = n_blocks * BLOCK
    wide = np.stack([M.multi_channel(
        SAMP_RATE, [(sp.half_center(0.0, h) + f, sigs[k])
                    for k, (s, h, f) in place.items() if s == src], n,
        rng=np.random.default_rng(20 + src)) for src in range(n_src)])
    cq = CqpskControlPipeline.p25_cqpsk(SLOTS, HALF_RATE)
    tdma = CqpskControlPipeline.p25_cqpsk(SLOTS, HALF_RATE, tdma=True)
    offs = cq_offsets(2 * n_src, dev)
    sst, cst, tst = sp.init(n_src, dev), cq.init(2 * n_src, dev), \
        tdma.init(2 * n_src, dev)
    reset_kernel_counts()
    outs = {"cq": [], "tdma": []}
    t0 = time.perf_counter()
    for b in range(n_blocks):
        x = torch.as_tensor(wide[:, b * BLOCK:(b + 1) * BLOCK], device=dev)
        sst, halves = sp.step(sst, x)
        logical = split2_sources(halves)
        cst, out_c = cq.step(cst, logical, offs)
        tst, out_t = tdma.step(tst, logical, offs)
        for key, out in (("cq", out_c), ("tdma", out_t)):
            if not bool(torch.isfinite(out[0]).all()):
                raise AssertionError("non-finite symbols")
            outs[key].append([o.cpu().numpy() for o in out[1:]])
    torch.cuda.synchronize()
    launches = kernel_counts()
    dt = time.perf_counter() - t0
    res = {k: [np.concatenate([o[i] for o in v], -1) for i in range(2)]
           for k, v in outs.items()}
    m = n // 2 // cq.decim
    if res["cq"][1].shape != (2 * n_src, SLOTS, m):
        raise AssertionError(f"output shape {res['cq'][1].shape}")

    def lane(key, name):
        s, h, f = place[name]
        src, slot = 2 * s + h, int(round(f / CQ_GRID_HZ)) + SLOTS // 2
        val, dib = res[key]
        return src, slot, dib[src, slot][val[src, slot].astype(bool)]

    for name, nac, expected in (("a", 0x293, exp_a), ("b", 0x123, exp_b)):
        src, slot, dib = lane("cq", name)
        g = streams.grants(dib, nac)
        if len(g) < 4 or not all(e in expected for e in g):
            raise AssertionError(f"split2 half {src} slot {slot}: {g}")
        log(f"split2 decode: logical source {src} (physical "
            f"{place[name][0]}, half {place[name][1]}) slot {slot} "
            f"({place[name][2] / 1e3:+.0f} kHz) NAC {nac:#x}: {len(g)} "
            f"GRP_V_CH_GRANT, first channel={g[0][0]:#x} ok")
    src, slot, dib = lane("tdma", "tdma")
    bursts = streams.tdma_bursts(dib)
    if not streams.tdma_voice_ok(bursts, voice):
        raise AssertionError(f"TDMA lane {src}/{slot}: {len(bursts)} bursts")
    log(f"split2 decode: tdma pipeline logical source {src} slot {slot}: "
        f"{len(bursts)} bursts, 36 voice codewords as sent ok")
    log(f"split2 decode: {n_src} physical sources x {n_blocks} blocks of "
        f"{BLOCK} complex64 -> {2 * n_src} halves x {SLOTS} slots, two "
        f"CQPSK pipelines, in {dt:.3f} s; launches {launches}")
    need = ("xlat_complex", "bank_operands", "xlat_bank", "agc",
            "cqpsk_track")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return launches


def phase_split2_bench(dev, sp) -> tuple[dict, float, float, float]:
    """The split2 → CQPSK bench shape: 128 physical sources × 240,000 bf16
    wire samples → 256 halves × 64 slots = 16384 CQPSK lanes × 2500
    samples per step. Times the step and each kernel of the path beside
    its plain version, and holds each kernel's output at this shape
    against the plain version's. Returns (timings, complex bank max |err|,
    CQPSK tracker max |err|, wire bank max |err|)."""
    from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
    from radiocapture_tpu_torch.frontend.pipeline import (
        CqpskControlPipeline, split2_sources)
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    from radiocapture_tpu_torch.tools import track_turns
    s = BENCH_SOURCES
    cq = CqpskControlPipeline.p25_cqpsk(SLOTS, HALF_RATE)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = cq_offsets(2 * s, dev)
    box = [sp.init(s, dev), cq.init(2 * s, dev)]

    def one_step():
        box[0], halves = sp.step(box[0], x)
        box[1], out = cq.step(box[1], split2_sources(halves), offs)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    win_ms = [cuda_ms(one_step, 5) for _ in range(5)]
    peak = torch.cuda.max_memory_allocated(dev)
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    busy = profile_steps(one_step, "split2+cqpsk", GLUE_KERNELS)
    med, mn = float(np.median(win_ms)), min(win_ms)
    res = {"step_ms_median": med, "step_ms_min": mn,
           "phys_msps_median": s * BLOCK / med / 1e3,
           "phys_msps_best": s * BLOCK / mn / 1e3,
           "latency_p50_ms": lat[len(lat) // 2],
           "latency_p95_ms": lat[int(len(lat) * 0.95)],
           "peak_mem_bytes": peak, "profile_busy_share": busy}

    # the complex bank on the operands the split2 step passes, mid-stream:
    # the bf16 wire block and the complex64 history, read in place
    bank = sp.bank
    offs2 = torch.as_tensor(np.tile(sp.offsets, (s, 1)), device=dev)
    hist, phase0 = box[0].history, box[0].phase
    grev, step = bank.modulated_taps(offs2), phase_step_u32(offs2, 2)
    n2 = BLOCK // 2
    res["xlat_complex_ms"] = cuda_ms(
        lambda: ck.bank_complex(x, hist, grev, phase0, step, 2), 10)
    res["xlat_complex_plain_ms"] = cuda_ms(
        lambda: ck.bank_complex_plain(ck.complex_z(x, hist), grev, phase0,
                                      step, n2, 2), 3)
    y = ck.bank_complex(x, hist, grev, phase0, step, 2)
    z = ck.complex_z(x, hist)
    cbank_err = check_complex_bank(
        y, ck.bank_complex_plain(z, grev, phase0, step, n2, 2),
        f"bench shape S={s} N={n2} K={bank.ntaps} D=2 C=2 bf16 block")
    # library yardstick: one float32 bmm (no TF32) of the materialised
    # window matrix [S, N, 2K] by the [2K, 2C] interleaved tap matrix
    k = bank.ntaps
    zr = torch.view_as_real(z).reshape(s, -1)
    win = zr.as_strided((s, n2, 2 * k), (zr.stride(0), 4, 1)).contiguous()
    gt = grev.transpose(1, 2)
    g2c = torch.stack([torch.cat([gt.real, gt.imag], -1),
                       torch.cat([-gt.imag, gt.real], -1)], 2).reshape(
        s, 2 * k, 2 * grev.shape[1])
    res["xlat_complex_library_ms"] = cuda_ms(lambda: torch.bmm(win, g2c), 10)
    del win, z
    res["xlat_complex_bound_ms"], res["xlat_complex_bound_by"] = bound(
        8.0 * s * n2 * grev.shape[1] * k, F32_PEAK,
        tensor_bytes(hist, x, grev, phase0, step, y))
    res["split2_step_ms"] = cuda_ms(lambda: sp.step(box[0], x), 10)
    log(f"complex bank kernel: bench shape: {res['xlat_complex_ms']:.4f} ms, "
        f"bound {res['xlat_complex_bound_ms']:.4f} ms "
        f"({res['xlat_complex_bound_by']}), library (f32 bmm, no rotation) "
        f"{res['xlat_complex_library_ms']:.4f} ms; split2 stage "
        f"(SpectrumSplit2.step) {res['split2_step_ms']:.4f} ms")
    turns = track_turns.complex_turns(track_turns.EARLIER_COMPLEX, x, hist,
                                      grev, phase0, step, 2)
    res["xlat_complex_turns"] = turns
    old = Path(turns["other"]).name
    log("complex bank turns: " + json.dumps(turns))
    log(f"complex bank turns: bf16 cast + cat + {old} "
        f"{turns['chain_other_ms'][0]:.4f}, bank_complex in place "
        f"{turns['chain_package_ms'][0]:.4f}, "
        f"{turns['chain_package_ms'][1]:.4f}, chain "
        f"{turns['chain_other_ms'][1]:.4f} ms: {turns['chain_speedup']:.2f}x; "
        f"kernels alone on the same complex64 values: {old} "
        f"{turns['kernel_other_ms'][0]:.4f}, kernel "
        f"{turns['kernel_package_ms'][0]:.4f}, "
        f"{turns['kernel_package_ms'][1]:.4f}, {old} "
        f"{turns['kernel_other_ms'][1]:.4f} ms: "
        f"{turns['kernel_speedup']:.2f}x; bit-identical outputs "
        f"{turns['chain_identical_outputs']} / "
        f"{turns['kernel_identical_outputs']} of {turns['outputs']}")
    if min(turns["chain_identical_outputs"],
           turns["kernel_identical_outputs"]) != turns["outputs"]:
        raise AssertionError("complex bank differs from the kernel it "
                             "replaced")

    # the wire bank at this path's shape, on the operands the CQPSK step
    # builds from its mid-stream state
    box[0], halves = sp.step(box[0], x)
    bank_res, bank_err = bank_at_bench(dev, cq.bank, box[1].bank,
                                       split2_sources(halves), offs,
                                       "cqpsk bench shape")
    res.update(bank_res)

    # the tracker on the planes the CQPSK step's bank gives, mid-stream
    box[0], halves = sp.step(box[0], x)
    _, y_re, y_im = cq.bank.call_planes(box[1].bank, split2_sources(halves),
                                        offs)
    res.update(agc_at_bench(y_re, y_im))
    scale = cqk.agc_scale_kernel(y_re, y_im)

    def lane_state():   # the kernel updates its lane state in place
        return type(box[1].cqpsk)(*(t.clone() for t in box[1].cqpsk))

    timed = lane_state()
    baud = cq.symbol_rate
    res["cqpsk_track_ms"] = cuda_ms(lambda: cqk.track_cqpsk(
        y_re, y_im, scale, timed, CHANNEL_FS, baud), 5)
    got = cqk.track_cqpsk(y_re, y_im, scale, lane_state(), CHANNEL_FS, baud)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cqk.track_cqpsk_plain(y_re, y_im, scale, lane_state(),
                                 CHANNEL_FS, baud)
    torch.cuda.synchronize()
    res["cqpsk_track_plain_ms"] = (time.perf_counter() - t0) * 1e3
    res["cqpsk_track_bound_ms"], res["cqpsk_track_bound_by"] = bound(
        CQPSK_OPS * y_re.numel(), F32_PEAK,
        tensor_bytes(y_re, y_im, scale, lane_state(), got))
    cq_err = check_cqpsk_noise(
        [o.cpu().numpy() for o in got[1:3]],
        [o.cpu().numpy() for o in want[1:3]],
        f"bench shape S={2 * s} C={SLOTS} N={y_re.shape[1]}")
    for key, src in (("cqpsk_track_turns", track_turns.EARLIER_CQPSK),
                     ("cqpsk_track_turns_symbol_major",
                      track_turns.SYMBOL_MAJOR_CQPSK)):
        turns = track_turns.cqpsk_turns(src, y_re, y_im, scale, lane_state,
                                        CHANNEL_FS, baud)
        res[key] = turns
        old = Path(turns["other"]).name
        log("cqpsk kernel turns: " + json.dumps(turns))
        log(f"cqpsk kernel turns: {old} {turns['other_ms'][0]:.4f}, kernel "
            f"{turns['package_ms'][0]:.4f}, {turns['package_ms'][1]:.4f}, "
            f"{old} {turns['other_ms'][1]:.4f} ms: "
            f"{turns['speedup']:.2f}x; {turns['identical_lanes']} of "
            f"{turns['lanes']} lanes bit-identical (3 outputs, 8 state "
            f"tensors)")
        if turns["identical_lanes"] != turns["lanes"]:
            raise AssertionError(f"cqpsk kernel differs from {old}'s")
    turns = res["cqpsk_track_turns"]
    res.update(cqpsk_floor(y_re, y_im, scale, lane_state, baud))
    log("split2 bench: " + json.dumps({
        "phys_sources": s, "halves": 2 * s, "slots": SLOTS, "block": BLOCK,
        "wire": "bf16", "window_step_ms": win_ms, **res}))
    log(f"split2 bench: step median {med:.3f} ms (min {mn:.3f}) = "
        f"{res['phys_msps_median']:.1f} physical MS/s; latency p50 "
        f"{res['latency_p50_ms']:.3f} / p95 {res['latency_p95_ms']:.3f} ms "
        f"vs {DEADLINE_MS:.0f} ms deadline; xlat_complex "
        f"{res['xlat_complex_ms']:.3f} ms (plain "
        f"{res['xlat_complex_plain_ms']:.3f}, split2 stage "
        f"{res['split2_step_ms']:.3f}); cqpsk_track "
        f"{res['cqpsk_track_ms']:.3f} ms (plain "
        f"{res['cqpsk_track_plain_ms']:.1f}, bound "
        f"{res['cqpsk_track_bound_ms']:.3f}, floor "
        f"{res['cqpsk_track_floor_ms']:.3f}, {turns['speedup']:.2f}x the "
        f"per-sample loop); xlat_bank "
        f"{res['bank_ms']:.3f} ms (bound {res['bank_bound_ms']:.3f}, "
        f"library {res['bank_library_ms']:.3f}); peak "
        f"{peak / 2 ** 30:.2f} GiB")
    return res, cbank_err, cq_err, bank_err


def voice_planes(s: int, n: int, c: int, dev, seed: int):
    """[S, N, C] float32 bank planes at 25 kS/s: even slots an FM tone
    (300–3000 Hz, 0.8 of a 2.5 kHz deviation) under -30 dB noise, odd
    slots complex noise. Returns (y_re, y_im, signal-lane mask [S, C])."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(device=dev, dtype=torch.float64)
    t = torch.arange(n, **f64)[None, :, None] / CHANNEL_FS
    freq = 300.0 + 2700.0 * torch.rand((s, 1, c), generator=g, **f64)
    ph0 = 2 * np.pi * torch.rand((s, 1, c), generator=g, **f64)
    audio = 0.8 * torch.sin(2 * np.pi * freq * t + ph0)
    phase = 2 * np.pi * 2500.0 / CHANNEL_FS * torch.cumsum(audio, 1) + ph0
    noise = torch.complex(torch.randn((s, n, c), generator=g, **f64),
                          torch.randn((s, n, c), generator=g, **f64))
    sig = (torch.arange(c, device=dev) % 2 == 0).expand(s, c)
    x = torch.where(sig[:, None, :],
                    torch.polar(torch.ones_like(phase), phase) + 0.03 * noise,
                    noise)
    return (x.real.float().contiguous(), x.imag.float().contiguous(), sig)


def check_voice(got, want, sig, what: str) -> float:
    """fm_voice kernel vs plain, (audio [S, C, N], power [S, C]): audio
    within VOICE_REL_TOL·max|audio| on every sample of the signal lanes
    and on VOICE_NOISE_SHARE of the noise lanes' samples, power within
    POWER_REL_TOL. Returns the signal lanes' max |err|."""
    err = (got[0] - want[0]).abs()
    tol = VOICE_REL_TOL * float(want[0][sig].abs().max())
    sig_err = float(err[sig].max())
    share = (float((err[~sig] <= tol).float().mean()) if bool((~sig).any())
             else 1.0)
    p_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    ok = (sig_err <= tol and share >= VOICE_NOISE_SHARE
          and p_err <= POWER_REL_TOL)
    log(f"voice kernel vs plain: {what}: signal lanes max_abs_err="
        f"{sig_err:.3e} (tol {tol:.3e}); noise lanes within tol "
        f"{share:.5f} (>= {VOICE_NOISE_SHARE}); power max rel err "
        f"{p_err:.3e} (<= {POWER_REL_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("voice kernel disagrees with plain")
    return sig_err


def check_voice_state(got, want, what: str) -> None:
    """The carried discriminator value ``x_last`` and last sample
    ``prev`` of the kernel and the plain version, bit for bit (the
    kernel's discriminator rounds as PyTorch's complex multiply)."""
    same_x = torch.equal(got[1].x_last, want[1].x_last)
    same_p = torch.equal(got[0].prev, want[0].prev)
    log(f"voice kernel vs plain: {what}: x_last identical {same_x}, prev "
        f"identical {same_p} {'ok' if same_x and same_p else 'FAIL'}")
    if not (same_x and same_p):
        raise AssertionError("voice kernel's carried state is not exact")


def phase_voice_kernel(dev) -> tuple[float, dict]:
    """fm_voice kernel vs plain: small and ragged shapes over two blocks
    (lane state carried, written in place by the kernel), then the bench
    shape (128 sources × 64 slots × 2500 samples) with both timed, and
    the kernel in turns with the one-thread-per-lane kernel it replaced
    (``tools/fm_voice_334afe8.cu``, built with the package's flags).
    Returns (max |err| on signal lanes, timings)."""
    from radiocapture_tpu_torch.ops import fm
    from radiocapture_tpu_torch.ops import fm_kernel as fk
    from radiocapture_tpu_torch.tools import track_turns
    gain = CHANNEL_FS / (2 * np.pi * VOICE_MAX_DEV)

    def fresh(s, c):
        return (fm.quad_demod_init((s, c), dev), fm.deemph_init((s, c), dev))

    worst = 0.0
    # N off the 256-sample time tile, within one, shorter than a 16-sample
    # chunk, a whole number of tiles; C on, off and under the 32-slot tile
    for s, n, c in ((1, 2500, SLOTS), (3, 1001, 40), (2, 37, 5), (2, 9, 33),
                    (1, 512, 32)):
        y_re, y_im, sig = voice_planes(s, 2 * n, c, dev, seed=n + c)
        st_k, st_p = fresh(s, c), fresh(s, c)
        for b in range(2):
            blk = [p[:, b * n:(b + 1) * n].contiguous() for p in (y_re, y_im)]
            ptrs = [t.data_ptr() for t in (st_k[0].prev, *st_k[1])]
            got = fk.voice_track(*blk, *st_k, gain, CHANNEL_FS)
            want = fk.voice_track_plain(*blk, *st_p, gain, CHANNEL_FS)
            if [t.data_ptr() for t in (got[0].prev, *got[1])] != ptrs:
                raise AssertionError("voice kernel did not update in place")
            st_k, st_p = got[:2], want[:2]
            what = f"S={s} N={n} C={c} block {b}"
            worst = max(worst, check_voice(got[2:], want[2:], sig, what))
            check_voice_state(got, want, what)
        ds = float((st_k[1].y_last - st_p[1].y_last)[sig].abs().max())
        if ds > VOICE_REL_TOL * float(want[2][sig].abs().max()):
            raise AssertionError(f"voice kernel state differs by {ds}")

    s, n = BENCH_SOURCES, BLOCK // 96
    y_re, y_im, sig = voice_planes(s, n, SLOTS, dev, seed=3)
    timed = fresh(s, SLOTS)
    res = {"fm_voice_ms": cuda_ms(
        lambda: fk.voice_track(y_re, y_im, *timed, gain, CHANNEL_FS), 10),
        "fm_voice_plain_ms": cuda_ms(lambda: fk.voice_track_plain(
            y_re, y_im, *timed, gain, CHANNEL_FS), 5)}
    got = fk.voice_track(y_re, y_im, *fresh(s, SLOTS), gain, CHANNEL_FS)
    want = fk.voice_track_plain(y_re, y_im, *fresh(s, SLOTS), gain,
                                CHANNEL_FS)
    what = f"bench shape S={s} N={n} C={SLOTS}"
    worst = max(worst, check_voice(got[2:], want[2:], sig, what))
    check_voice_state(got, want, what)
    res["fm_voice_bound_ms"], res["fm_voice_bound_by"] = bound(
        VOICE_OPS * y_re.numel(), F32_PEAK,
        tensor_bytes(y_re, y_im, fresh(s, SLOTS), got))
    # the same traffic (both planes read once, one plane written) with no
    # arithmetic to speak of: the bandwidth this card reaches in practice
    summed = torch.empty_like(y_re)
    res["fm_voice_traffic_ms"] = cuda_ms(
        lambda: torch.add(y_re, y_im, out=summed), 10)
    log(f"voice kernel: bench shape {s * SLOTS} lanes x {n} samples: "
        f"kernel {res['fm_voice_ms']:.4f} ms, plain "
        f"{res['fm_voice_plain_ms']:.3f} ms, bound "
        f"{res['fm_voice_bound_ms']:.4f} ms ({res['fm_voice_bound_by']}), "
        f"{res['fm_voice_bound_ms'] / res['fm_voice_ms']:.3f} of it; "
        f"torch.add of the two planes (same bytes) "
        f"{res['fm_voice_traffic_ms']:.4f} ms")
    turns = track_turns.voice_turns(track_turns.EARLIER_VOICE, y_re, y_im,
                                    gain, CHANNEL_FS)
    res["fm_voice_turns"] = turns
    log("voice kernel turns: " + json.dumps(turns))
    log(f"voice kernel turns: {Path(turns['other']).name} "
        f"{turns['other_ms'][0]:.4f}, kernel {turns['package_ms'][0]:.4f}, "
        f"{turns['package_ms'][1]:.4f}, {Path(turns['other']).name} "
        f"{turns['other_ms'][1]:.4f} ms: {turns['speedup']:.2f}x")
    return worst, res


def state_rows(rt, src: int) -> dict:
    """Copies of ``src``'s state rows in every group that holds it."""
    from radiocapture_tpu_torch.runtime import _tree_map
    rows = {}
    for gkey, g in rt.groups.items():
        if src in g["srcs"]:
            r = g["srcs"].index(src)
            rows[gkey] = _tree_map(lambda t: t[r].clone(), rt.pipe_state[gkey])
    return rows


def same_rows(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(same_rows(x, y) for x, y in zip(a, b))


def phase_runtime_decode(dev, frontend: str = "xlat") -> dict:
    """``SiteRuntime`` on the card: two 2.4 MS/s sources × 64 slots,
    100 ms blocks, a P25 C4FM system and an EDACS system on source 0
    (noise on source 1), with ``frontend_mode`` ``frontend``. The P25
    grant opens a ``c4fm`` recorder whose codewords must be a run of
    those sent; the EDACS grant opens an analog recorder whose 8 kHz WAV
    must peak at 1 kHz; in block RT_STARVE_BLOCK source 1 delivers
    nothing and its state rows must stay bit-identical. Returns the
    kernels' launch counts of the run."""
    import shutil
    import tempfile
    from radiocapture_tpu_torch.audio.wav import read_wav
    from radiocapture_tpu_torch.runtime import FileSource, SiteRuntime
    from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                                 SystemConfig)
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    cc, vc, sent = streams.p25_voice_call(RT_P25_VC, RT_SECONDS)
    ecc, evc = streams.edacs_analog_call(RT_SECONDS, RT_KEYUP_S, TONE_HZ)
    n = int(RT_SECONDS * SAMP_RATE)
    wide0 = M.multi_channel(SAMP_RATE, [
        (f - RT_CENTER, M.upsample_to(iq, CHANNEL_FS, SAMP_RATE))
        for f, iq in ((RT_P25_CC, cc), (RT_P25_VC, vc), (RT_EDACS_CC, ecc),
                      (RT_EDACS_VC, evc))], n, noise_floor_db=-60.0)
    wide1 = M.multi_channel(SAMP_RATE, [], n, noise_floor_db=-20.0,
                            rng=np.random.default_rng(31))
    what = "runtime decode" + ("" if frontend == "xlat" else f" {frontend}")
    audio_dir = tempfile.mkdtemp(prefix="rc_smoke_audio_")
    cfg = RcConfig(audio_dir=audio_dir)          # 64 slots, 100 ms blocks
    cfg.frontend_mode = frontend
    cfg.sources[0] = SourceConfig(type="file", center_freq=RT_CENTER,
                                  samp_rate=SAMP_RATE)
    cfg.sources[1] = SourceConfig(type="file",
                                  center_freq=RT_CENTER + SAMP_RATE,
                                  samp_rate=SAMP_RATE)
    cfg.systems[0] = SystemConfig(type="p25", id="P25",
                                  control_channels=[RT_P25_CC])
    cfg.systems[1] = SystemConfig(type="edacs", id="EDACS",
                                  channels={1: RT_EDACS_CC, 3: RT_EDACS_VC},
                                  control_channels=[RT_EDACS_CC])
    src1 = FileSource(wide1, loop=False)
    starve = {"on": False}
    rt = SiteRuntime(cfg, {0: FileSource(wide0, loop=False),
                           1: lambda k: None if starve["on"] else src1(k)},
                     dev, keep_wav=True)
    rt.use_stream_clock()
    completed = []
    rt.bus.subscribe("/queue/call_management/call_complete", completed.append)
    try:
        n_blocks = n // rt.block_len(0)
        reset_kernel_counts()
        t0 = time.perf_counter()
        for b in range(n_blocks):
            if b == RT_STARVE_BLOCK:
                before = {s: state_rows(rt, s) for s in (0, 1)}
                starve["on"] = True
            rt.step()
            if b == RT_STARVE_BLOCK:
                starve["on"] = False
                after = {s: state_rows(rt, s) for s in (0, 1)}
                frozen = {g: same_rows(before[1][g], after[1][g])
                          for g in before[1]}
                moved = {g: not same_rows(before[0][g], after[0][g])
                         for g in before[1]}
                log(f"{what}: block {b}, source 1 starved: its "
                    f"rows unchanged in groups {sorted(map(str, frozen))}: "
                    f"{frozen}; source 0 advanced: {moved}")
                if len(frozen) < 2 or not all(frozen.values()) \
                        or not all(moved.values()):
                    raise AssertionError("starved source's state advanced")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernel_counts()
        locked = {i.cfg.id: i.engine.is_locked for i in rt.instances}
        recs = {kind: rec for rec, _s, _c, _b, kind
                in rt.recorders.active.values()}
    finally:
        rt.close()
    deadline = time.time() + 5.0
    while len(completed) < 2 and time.time() < deadline:
        time.sleep(0.05)
    try:
        cdrs = {c["cdr"]["modulation_type"]: c["cdr"] for c in completed}
        if not all(locked.values()) or set(recs) != {"c4fm", "analog"} \
                or set(cdrs) != {"p25", "analog_edacs"}:
            raise AssertionError(f"locked {locked}, recorders {set(recs)}, "
                                 f"calls {set(cdrs)}")
        p25 = cdrs["p25"]
        frames = recs["c4fm"]._imbe_frames
        if (p25["system_group_local"], p25["system_user_local"]) != (500, 42) \
                or not streams.codewords_ok(frames, sent, 18):
            raise AssertionError(f"P25 call: CDR {p25}, {len(frames)} "
                                 "codewords not as sent")
        log(f"{what}: P25 C4FM grant -> call group "
            f"{p25['system_group_local']} user {p25['system_user_local']} on "
            f"{p25['frequency'] / 1e6:.4f} MHz, {len(frames)} IMBE codewords "
            f"recorded, a run of those sent ok")
        pcm, rate = read_wav(recs["analog"].filename)
        seg = pcm[len(pcm) // 4:]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        peak = float(np.argmax(spec) * rate / len(seg))
        ed = cdrs["analog_edacs"]
        if rate != 8000 or len(pcm) < 8000 or abs(peak - TONE_HZ) > 20.0 \
                or ed["system_group_local"] != 321:
            raise AssertionError(f"EDACS call: CDR {ed}, WAV {rate} Hz, "
                                 f"{len(pcm)} samples, peak {peak} Hz")
        log(f"{what}: EDACS grant -> analog call group "
            f"{ed['system_group_local']} on {ed['frequency'] / 1e6:.4f} MHz, "
            f"WAV {rate} Hz x {len(pcm)} samples, peak {peak:.1f} Hz ok")
    finally:
        shutil.rmtree(audio_dir, ignore_errors=True)
    log(f"{what}: 2 sources x {SLOTS} slots x {n_blocks} blocks, "
        f"groups {sorted(str(k) for k in rt.groups)} in {dt:.3f} s; "
        f"launches {launches}")
    need = {"xlat": ("bank_operands", "xlat_bank"),
            "pfb": ("pfb_bins", "pfb_fine")}[frontend] + ("fsk_track",
                                                            "fm_voice")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return launches


def phase_runtime_bench(dev, frontend: str = "xlat") -> dict:
    """``SiteRuntime.step`` at 128 sources × 64 slots, 2.4 MS/s, 100 ms
    blocks, one P25 C4FM system, ``frontend_mode`` ``frontend``: groups
    ``c4fm`` and ``analog`` of 128 sources each; providers cycle four
    float32 wire blocks. Reports step p50/p95 against the deadline, the
    device ms of each group's step, the host-side pieces (stacking,
    upload, each group's fetch), the busy share and host syncs per
    step."""
    from radiocapture_tpu_torch.device import wire_from_numpy
    from radiocapture_tpu_torch.runtime import SiteRuntime
    from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                                 SystemConfig)
    s = BENCH_SOURCES
    rng = np.random.default_rng(41)
    pool = [(0.1 * rng.standard_normal((BLOCK, 2))).astype(np.float32)
            for _ in range(4)]
    what = "runtime bench" + ("" if frontend == "xlat" else f" {frontend}")
    cfg = RcConfig()
    cfg.frontend_mode = frontend
    for i in range(s):
        cfg.sources[i] = SourceConfig(type="file",
                                      center_freq=RT_CENTER + i * SAMP_RATE,
                                      samp_rate=SAMP_RATE)
    cfg.systems[0] = SystemConfig(type="p25", id="P25",
                                  control_channels=[RT_P25_CC])
    ticks = [0] * s

    def provider(i):
        def pull(k):
            ticks[i] += 1
            return pool[(i + ticks[i]) % len(pool)][:k]
        return pull

    rt = SiteRuntime(cfg, {i: provider(i) for i in range(s)}, dev)
    try:
        sizes = {g["cls"]: len(g["srcs"]) for g in rt.groups.values()}
        if sizes != {"c4fm": s, "analog": s} or rt.block_len(0) != BLOCK:
            raise AssertionError(f"groups {sizes}, block {rt.block_len(0)}")
        for _ in range(3):
            rt.step()
        torch.cuda.synchronize()
        lat = []
        for _ in range(RT_BENCH_STEPS):
            t0 = time.perf_counter()
            rt.step()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        busy = profile_steps(rt.step, what.replace(" bench", ""))
        # the pieces of one step, each on its own, through the runtime's
        # own helpers (the stacking buffer is warm, as in a step)
        xs = [pool[i % len(pool)] for i in range(s)]
        key = (tuple(range(s)), np.dtype(np.float32))
        t0 = time.perf_counter()
        xb = rt._stack(key, xs)
        stack_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = wire_from_numpy(xb, dev)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        group_ms, fetch_ms = {}, {}
        for gkey, g in rt.groups.items():
            pipe, st, offs = g["pipe"], rt.pipe_state[gkey], rt._offsets(gkey)
            group_ms[g["cls"]] = cuda_ms(lambda: pipe.step(st, x, offs), 5)
            out = pipe.step(st, x, offs)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt._fetch(g["cls"], out)
            fetch_ms[g["cls"]] = (time.perf_counter() - t0) * 1e3
    finally:
        rt.close()
    lat.sort()
    res = {"frontend": frontend, "sources": s, "slots": SLOTS,
           "block": BLOCK, "wire": "float32",
           "steps": RT_BENCH_STEPS, "step_ms": lat,
           "step_p50_ms": lat[len(lat) // 2],
           "step_p95_ms": lat[int(len(lat) * 0.95)],
           "group_device_ms": group_ms, "stack_ms": stack_ms,
           "upload_ms": upload_ms, "fetch_ms": fetch_ms,
           "profile_busy_share": busy}
    log(f"{what}: " + json.dumps(res))
    log(f"{what}: SiteRuntime.step p50 {res['step_p50_ms']:.3f} / "
        f"p95 {res['step_p95_ms']:.3f} ms vs {DEADLINE_MS:.0f} ms deadline; "
        f"device: c4fm group {group_ms['c4fm']:.3f} ms, analog group "
        f"{group_ms['analog']:.3f} ms; host: stack {stack_ms:.3f} ms, "
        f"upload {upload_ms:.3f} ms, fetch c4fm {fetch_ms['c4fm']:.3f} ms "
        f"(analog, only while an analog call records: "
        f"{fetch_ms['analog']:.3f} ms); busy share {busy:.3f}")
    return res


def pfb_bins_check(pfb, state, x) -> dict:
    """``pfb bins:`` ``PfbChannelizer.bins`` (one ``pfb_bins`` launch)
    against ``rows``' time-major channels transposed (the ``pfb_rows``
    kernel, cuFFT, the rotation) within BINS_REL·max|bins| and the new
    histories bit-identical (fails otherwise), and the two in turns (rows,
    bins, bins, rows). ``rows``, the time-major entry point, runs once
    with the counts set to 0 before and read after: its ``pfb_rows``
    launches (the pfb step's bins run ``pfb_bins``)."""
    from radiocapture_tpu_torch.ops import pfb_kernel as pk
    reset_kernel_counts()
    sr, yr = pfb.rows(state, x)
    torch.cuda.synchronize()
    rows_launches = kernel_counts()
    sb, yb = pfb.bins(state, x)
    ref = yr.transpose(1, 2)
    scale = float(ref.abs().max())
    err = float((yb - ref).abs().max())
    same = torch.equal(torch.view_as_real(sb.history).view(torch.int32),
                       torch.view_as_real(sr.history).view(torch.int32))
    res = {"max_abs_err": err, "max_rel_err": err / scale,
           "history_identical": same, "values": yb.numel(),
           "contiguous": yb.is_contiguous(),
           "rows_launches": rows_launches,
           **turns(lambda: pfb.rows(state, x), lambda: pfb.bins(state, x),
                   10)}
    del yr, ref
    ok = (err <= pk.BINS_REL * scale and same and res["contiguous"]
          and rows_launches["pfb_rows"] == 1 and rows_launches["pfb_bins"] == 0)
    log(f"pfb bins: {tuple(yb.shape)} bin-major, within {err:.3e} = "
        f"{err / scale:.3e} of max|bins| (bound {pk.BINS_REL:g}) of rows' "
        f"(pfb_rows, ifft, rot) transposed, new history identical {same}; "
        f"rows ran pfb_rows {rows_launches['pfb_rows']} time(s); rows "
        f"{res['plain_turns_ms'][0]:.4f}, bins {res['kernel_turns_ms'][0]:.4f}"
        f", {res['kernel_turns_ms'][1]:.4f}, rows "
        f"{res['plain_turns_ms'][1]:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pfb bins: the bin-major bins disagree")
    return res


def fine_check(got, want, what: str, rel: float) -> float:
    """The fine stage's outputs against ``want`` within rel·max|want|;
    returns max |err| over max|want|."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    ok = err <= rel and bool(torch.isfinite(torch.view_as_real(got)).all())
    log(f"{what}: max |err| {err:.3e} of max|y| (bound {rel:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outside its bound")
    return err


def fine_rows(y_re: torch.Tensor, y_im: torch.Tensor) -> torch.Tensor:
    """``pfb_fine``'s planes [S, N, C] as its rows [S·C, N] complex64."""
    return torch.complex(y_re, y_im).transpose(1, 2).reshape(
        -1, y_re.shape[1])


def phase_pfb_fine(dev) -> tuple[dict, float]:
    """The pfb frontend's fine stage, ``pfb_fine`` (``csrc/pfb_fine.cu``:
    each row's bin mixed to its slot's offset, one real prototype filter,
    K2 = 467 taps, D = 16, the outputs stored as the trackers' [S, N, C]
    planes), each row reading its slot's bin in place through the row
    index: small and ragged cases (the index permuted and repeated, f at
    ±0.5 and 0, one to four sources of 1 to 16 slots) at one and three
    rows a block against ``pfb_fine_plain`` within ``FINE_REL`` and
    against the complex bank on the gathered rows' modulated taps (the
    form it replaced) within COMPLEX_REL_TOL, every plane element written;
    then at a bench-shape step (128 sources × 64 slots = 8192 rows over
    768 bin rows of 40000 samples, ``track_turns.fine_bench_operands``):
    the bins (``pfb_bins_check``), the kernel on all rows held to the
    complex bank on the gathered rows and on the first PFB_ROWS to the
    plain version, its ms, its bound (the filter's 4 FLOP a tap and the
    mixing's 8 a sample), the plain version's ms on PFB_ROWS rows, one
    grouped ``conv1d`` yardstick (groups = 8192, the modulated taps, no
    rotation) and the new fine history through the row index
    (``row_history``) against the gathered rows' (``pfb fine history:``,
    bit-identical). Returns (numbers, max |err| over max|y| against the
    plain version)."""
    from radiocapture_tpu_torch.ops import channelizer as chz
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops import pfb_kernel as pk
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    from radiocapture_tpu_torch.tools import track_turns
    bank = chz.PfbXlatBank(SLOTS, SAMP_RATE, 12500.0)
    k, d = bank.ntaps2, bank.decim2
    taps = bank.device_taps(dev)
    rng = np.random.default_rng(12)
    worst = 0.0
    for s, c, r, n, fine in ((3, 3, 2, 37, None), (5, 5, 4, 1001, None),
                             (3, 1, 2, 5, None),
                             (3, 3, 2, 300, [0.4999, -0.5, 0.5]),
                             (2, 1, 1, 300, [0.0, 1e-7]),
                             (PFB_ROWS, 16, 24, BLOCK // bank.decim, None)):
        x = torch.as_tensor(rng.standard_normal((r, n * d, 2)).astype(
            np.float32), device=dev)
        rows = torch.as_tensor(rng.integers(0, r, s), device=dev)
        hist = torch.as_tensor((rng.standard_normal((s, k - 1))
                                + 1j * rng.standard_normal((s, k - 1))
                                ).astype(np.complex64), device=dev)
        fine = torch.as_tensor(np.asarray(
            rng.uniform(-0.5, 0.5, s) if fine is None else fine,
            np.float32), device=dev)
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, s),
                                 dtype=torch.int64, device=dev)
        step = phase_step_u32(fine, d)
        ops = (x, rows, hist, taps, fine, phase0, step)
        want = pk.pfb_fine_plain(*ops, d)
        old = ck.bank_complex(x[rows], hist,
                              chz.modulated_taps(taps, fine[:, None]),
                              phase0[:, None], step[:, None], d)[:, 0]
        for rb in (1, 3):
            args, planes = pk.pfb_fine_args(*ops, d, c, rb=rb, out=tuple(
                torch.full((s // c, n, c), float("nan"), device=dev)
                for _ in range(2)))
            kernels_check(args)
            got = fine_rows(*planes)
            what = (f"pfb fine kernel: S'={s} (C={c}) over {r} rows N={n} "
                    f"K={k} D={d} rb={rb}")
            worst = max(worst, fine_check(got, want, what + " vs plain",
                                          pk.FINE_REL))
            fine_check(got, old, what + " vs the modulated taps",
                       COMPLEX_REL_TOL)

    xb, rows, hist, taps, fine, phase0, step, d = \
        track_turns.fine_bench_operands(dev)
    nrows, n = rows.numel(), xb.shape[1] // d
    rb = pk.fine_plan(nrows, n, k, torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    res = {"rb": rb}
    ops = (xb, rows, hist, taps, fine, phase0, step)
    res["pfb_fine_ms"] = cuda_ms(lambda: pk.pfb_fine(*ops, d, SLOTS), 10)
    res["pfb_fine_ms_rb1"] = cuda_ms(lambda: kernels_check(
        pk.pfb_fine_args(*ops, d, SLOTS, rb=1)[0]), 10)
    planes = pk.pfb_fine(*ops, d, SLOTS)
    y = fine_rows(*planes)
    grev = chz.modulated_taps(taps, fine[:, None])
    xg = xb[rows]
    old = ck.bank_complex(xg, hist, grev, phase0[:, None], step[:, None],
                          d)[:, 0]
    fine_check(y, old, f"pfb fine kernel, bench operands, {nrows} rows, vs "
               f"the modulated taps", COMPLEX_REL_TOL)
    sub = slice(0, PFB_ROWS)
    sub_ops = (xb, rows[sub], hist[sub], taps, fine[sub], phase0[sub],
               step[sub])
    res["pfb_fine_plain_ms_rows"] = cuda_ms(
        lambda: pk.pfb_fine_plain(*sub_ops, d), 3)
    worst = max(worst, fine_check(
        y[sub], pk.pfb_fine_plain(*sub_ops, d),
        f"pfb fine kernel, bench operands, rows 0-{PFB_ROWS - 1} vs plain",
        pk.FINE_REL))
    # the bound: the filter's 2 FMAs a tap and part, the mixing's complex
    # multiply (6 FLOP) and phasor product (6) a staged sample
    flops = 4.0 * nrows * n * k + 12.0 * nrows * (n * d + k - 1)
    res["pfb_fine_flop"] = flops
    res["pfb_fine_bytes"] = tensor_bytes(xb, rows, hist, taps, fine, phase0,
                                         step, planes)
    res["pfb_fine_bound_ms"], res["pfb_fine_bound_by"] = bound(
        flops, F32_PEAK, res["pfb_fine_bytes"])
    # the yardstick: the modulated taps' correlation, re/im the two
    # channels of each row's group, no rotation, so |y| must match
    z = torch.view_as_real(ck.complex_z(xg, hist))          # [S', L, 2]
    inp = z.permute(0, 2, 1).reshape(1, 2 * nrows, -1).contiguous()
    del z
    w = torch.stack([torch.stack([grev.real, -grev.imag], 1),
                     torch.stack([grev.imag, grev.real], 1)], 1).reshape(
        2 * nrows, 2, k)
    conv = torch.nn.functional.conv1d
    res["pfb_fine_library_ms"] = cuda_ms(
        lambda: conv(inp, w, stride=d, groups=nrows), 3)
    out = conv(inp, w, stride=d, groups=nrows)[0].view(nrows, 2, -1)[..., :n]
    del inp
    mag_err = float((torch.hypot(out[:, 0], out[:, 1]) - y.abs()).abs().max())
    scale = float(y.abs().max())
    if mag_err > 10 * COMPLEX_REL_TOL * scale:     # cuDNN picks its algorithm
        raise AssertionError(f"conv1d yardstick computes another function: "
                             f"|y| differs by {mag_err}")
    del out, y, old, planes
    log(f"pfb fine bank: {nrows} rows (S={BENCH_SOURCES} x C={SLOTS}) x "
        f"N={n}, K={k}, D={d}, bins read in place ({xb.shape[0]} bin rows), "
        f"{rb} rows a block: kernel {res['pfb_fine_ms']:.4f} ms (one row a "
        f"block {res['pfb_fine_ms_rb1']:.4f}), bound "
        f"{res['pfb_fine_bound_ms']:.4f} ms "
        f"({res['pfb_fine_bound_by']}, {flops:.4g} FLOP, "
        f"{res['pfb_fine_bytes'] / 1e9:.3f} GB), share of bound "
        f"{res['pfb_fine_bound_ms'] / res['pfb_fine_ms']:.3f}; library "
        f"(grouped conv1d, groups={nrows}, modulated taps, no rotation) "
        f"{res['pfb_fine_library_ms']:.4f} ms, |y| within {mag_err:.3e}; "
        f"plain on {PFB_ROWS} rows {res['pfb_fine_plain_ms_rows']:.3f} ms")
    hi = chz.row_history(hist, xb, rows)
    hg = chz.complex_history(hist, xg)
    del xg
    res["identical_history"] = track_turns.identical_outputs(hi, hg)
    res["history"] = hi.numel()
    ok = res["identical_history"] == res["history"]
    log(f"pfb fine history: {nrows} rows through the row index against the "
        f"gathered rows: bit-identical {res['identical_history']} of "
        f"{res['history']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pfb fine history: row_history differs from "
                             "the gathered rows'")
    res["pfb_bins"] = pfb_bins_check_bench(dev)
    return res, worst


def kernels_check(args) -> None:
    """One launch of ``pfb_fine_launch`` with ``args`` (``pfb_fine_args``'),
    raising on a CUDA error."""
    from radiocapture_tpu_torch import kernels
    kernels.check(kernels.load().pfb_fine_launch(*args), "pfb_fine")


def pfb_bins_check_bench(dev) -> dict:
    """``pfb_bins_check`` on a bench-shape pfb state (128 sources, two
    steps of a random-normal bf16 block), as the fine stage reads them."""
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    bank = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE, frontend="pfb").bank
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((BENCH_SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(BENCH_SOURCES, dev)
    state = bank.init(BENCH_SOURCES, dev)
    for _ in range(2):
        state, _ = bank(state, x, offs)
    return pfb_bins_check(bank.pfb, state.pfb, x)


def pfb_rows_case(pfb, hist, x, what: str, timed: bool = False) -> dict:
    """``pfb rows kernel:`` one case: ``pfb_rows`` (``csrc/pfb_rows.cu``)
    against ``pfb_rows_plain`` on the card, v and the new history bit for
    bit (fails otherwise). With ``timed``: eager, kernel, kernel, eager
    ms, the bytes bound and the kernel's share of it, and the library
    yardstick: one grouped ``conv1d`` (groups = M, reversed taps) over the
    branch-major float32 rows of history ++ block, prepared outside the
    timed region, its outputs within PFB_CONV_REL·max|v| of the kernel's."""
    from radiocapture_tpu_torch.ops import pfb_kernel as pk
    hp2 = pfb.device_hp2(x.device)
    m, p = hp2.shape
    s, t = x.shape[:2]
    n = t // m
    v, nh = pk.pfb_rows(hist, x, hp2)
    pv, pnh = pk.pfb_rows_plain(hist, x, hp2)
    same = int((torch.view_as_real(v).view(torch.int32)
                == torch.view_as_real(pv).view(torch.int32)).all(-1).sum())
    h_same = torch.equal(torch.view_as_real(nh).view(torch.int32),
                         torch.view_as_real(pnh).view(torch.int32))
    res = {"identical": same, "outputs": v.numel(),
           "history_identical": h_same,
           "max_abs_err": float((v - pv).abs().max()) if v.numel() else 0.0}
    wire = str(x.dtype).split(".")[-1]
    line = (f"pfb rows kernel: {what} S={s} T={t} {wire} M={m} P={p}: v "
            f"{same} of {v.numel()} outputs bit-identical, new history "
            f"identical {h_same}")
    ok = same == v.numel() and h_same
    if timed:
        res.update(turns(lambda: pk.pfb_rows_plain(hist, x, hp2),
                         lambda: pk.pfb_rows(hist, x, hp2), 20))
        res["ms"] = float(np.mean(res["kernel_turns_ms"]))
        res["plain_ms"] = float(np.mean(res["plain_turns_ms"]))
        nbytes = tensor_bytes(hist, x, hp2, v, nh)
        res["bound_ms"], res["bound_by"] = bound(
            2.0 * 2 * s * n * m * p, F32_PEAK, nbytes)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        # the yardstick: channel (s, re/im, m') is row m' of zr over time;
        # conv1d correlates, so tap q sits at P-1-q
        z = torch.view_as_real(torch.cat(
            [hist, torch.view_as_complex(x.float().contiguous())], dim=1))
        inp = z.view(s, n + p - 1, m, 2).permute(0, 3, 2, 1).reshape(
            s * 2, m, n + p - 1).contiguous()
        del z
        w = hp2.flip(-1)[:, None, :].contiguous()
        conv = torch.nn.functional.conv1d
        res["library_ms"] = cuda_ms(lambda: conv(inp, w, groups=m), 10)
        out = conv(inp, w, groups=m).view(s, 2, m, n)
        want = torch.view_as_real(v.flip(-1)).permute(0, 3, 2, 1)
        lib_err = float((out - want).abs().max())
        scale = float(v.abs().max())
        del inp, out
        ok = ok and lib_err <= PFB_CONV_REL * scale
        line += (f"; eager {res['plain_turns_ms'][0]:.4f}, kernel "
                 f"{res['kernel_turns_ms'][0]:.4f}, "
                 f"{res['kernel_turns_ms'][1]:.4f}, eager "
                 f"{res['plain_turns_ms'][1]:.4f} ms: {res['speedup']:.2f}x; "
                 f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
                 f"{nbytes} B), share {res['share_of_bound']:.3f}; library "
                 f"(grouped conv1d, groups={m}) {res['library_ms']:.4f} ms, "
                 f"within {lib_err:.3e} (tol {PFB_CONV_REL * scale:.3e})")
    log(f"{line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"pfb rows kernel: {what} disagrees")
    return res


def phase_pfb_rows(dev) -> dict:
    """``pfb rows kernel:`` the pfb frontend's combiner at the shapes the
    main path and the tests give it: the bench shape (128 sources × 240000
    bf16 samples, M = 6, P = 24, a random mid-stream history) and the
    runtime's float32 wire at the same shape, timed; complex64 blocks at
    the CPU tests' M = 8 and M = 16 banks; and a 60-sample block (n = 10 <
    P-1) after the bench block, from the kernel's own new history."""
    from radiocapture_tpu_torch.ops.channelizer import PfbChannelizer
    pfb = PfbChannelizer.for_rates(SAMP_RATE, 6, atten_db=80.0)
    gen = torch.Generator(device=dev).manual_seed(8)

    def cnormal(*shape):
        return torch.view_as_complex(torch.randn(shape + (2,),
                                                 generator=gen, device=dev))

    s = BENCH_SOURCES
    hist = cnormal(s, (pfb.p - 1) * pfb.num_channels)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    res = {"bf16": pfb_rows_case(pfb, hist, x, "bench", True),
           "f32": pfb_rows_case(pfb, hist, x.float(), "runtime float32",
                                True)}
    for fs, m in ((800e3, 8), (1.6e6, 16)):
        pm = PfbChannelizer.for_rates(fs, m)
        res[f"m{m}"] = pfb_rows_case(pm, cnormal(4, (pm.p - 1) * m),
                                     cnormal(4, m * 5000),
                                     f"complex64 ({fs / 1e6:g} MS/s bank)")
    after, _ = pfb.rows(pfb.init(s, dev)._replace(history=hist), x)
    res["short"] = pfb_rows_case(pfb, after.history, x[:, :60].contiguous(),
                                 "short block after the bench block")
    res["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return res


def bins_chain(pfb, state, x):
    """What ``PfbChannelizer.bins`` ran on the card before ``pfb_bins``
    (commit 2cf31c4): the ``pfb_rows`` kernel, cuFFT's inverse FFT, the
    rotation multiply writing the bins bin-major."""
    st, f, rot = pfb._idft(state, x)
    s, n, m = f.shape
    y = torch.empty((s, m, n), dtype=torch.complex64, device=f.device)
    torch.mul(f.transpose(1, 2), rot[:, None], out=y)
    return st, y


def pfb_bins_case(pfb, hist, x, what: str) -> dict:
    """``pfb bins kernel:`` one case: ``pfb_bins`` against
    ``pfb_bins_plain`` on the card, max |err| within BINS_REL·max|bins|
    and the new history bit-identical (fails otherwise); the chain it
    replaced (``bins_chain``) and the kernel in turns (chain, kernel,
    kernel, chain), the plain version's ms, the bound (the block, history,
    taps and table read once, the bins and history written once; the
    taps' float32 FLOP and an FFT's for the IDFT), and the library
    yardstick: one
    ``torch.fft.ifft`` of the same [S, T/M, M] rows, made outside the
    timed region. Then the kernel's plan (the IDFT's factors and FLOP a
    row) and the kernel in turns with commit ef6af1a's, the direct
    [M, M] table (``tools/pfb_rows_ef6af1a.cu``; its bins within
    BINS_REL·max|bins| of the package's and its new history bit-identical,
    or the case fails)."""
    from radiocapture_tpu_torch.ops import pfb_kernel as pk
    from radiocapture_tpu_torch.ops.channelizer import PfbState
    from radiocapture_tpu_torch.tools import track_turns
    hp2 = pfb.device_hp2(x.device)
    m, p = hp2.shape
    s, t = x.shape[:2]
    n = t // m
    y, nh = pk.pfb_bins(hist, x, hp2)
    py, pnh = pk.pfb_bins_plain(hist, x, hp2)
    scale = float(py.abs().max())
    err = float((y - py).abs().max())
    same = torch.equal(torch.view_as_real(nh).view(torch.int32),
                       torch.view_as_real(pnh).view(torch.int32))
    del py, pnh
    state = PfbState(history=hist)
    res = {"M": m, "P": p, "S": s, "T": t,
           "wire": str(x.dtype).split(".")[-1], "max_abs_err": err,
           "max_rel_err": err / scale, "bound_rel": pk.BINS_REL,
           "history_identical": same,
           **turns(lambda: bins_chain(pfb, state, x),
                   lambda: pk.pfb_bins(hist, x, hp2), 10)}
    res["ms"] = float(np.mean(res["kernel_turns_ms"]))
    res["chain_ms"] = float(np.mean(res["plain_turns_ms"]))
    res["plain_ms"] = cuda_ms(lambda: pk.pfb_bins_plain(hist, x, hp2), 3)
    k, wb, slabs, m1, m2, shared = pk.bins_plan(
        m, p, x.dtype == torch.bfloat16)
    nbytes = tensor_bytes(hist, x, hp2, pk.device_table(m, m1, m2, x.device),
                          y, nh)
    # the IDFT at an FFT's 5·M·log2 M FLOP a row, the least the function
    # needs; the kernel does 8·M·(M1 + M2), or 8·M² on the direct table
    flops = 4.0 * s * n * m * p + 5.0 * s * n * m * math.log2(m)
    res["bound_ms"], res["bound_by"] = bound(flops, F32_PEAK, nbytes)
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    v = pk.pfb_rows(hist, x, hp2)[0]
    res["library_ms"] = cuda_ms(
        lambda: torch.fft.ifft(v, dim=-1, norm="forward"), 10)
    del v, y, nh
    res["plan"] = {"k": k, "wb": wb, "slabs": slabs, "m1": m1, "m2": m2,
                   "shared": shared}
    res["idft_flop_per_row"] = 8 * m * (m1 + m2 if m1 > 1 else m)
    old = track_turns.bins_turns(track_turns.EARLIER_BINS, hist, x, hp2,
                                 iters=10)
    res["ef6af1a_turns"] = old
    res["ef6af1a_ms"] = float(np.mean(old["other_ms"]))
    ok = (err <= pk.BINS_REL * scale and same
          and old["max_rel_diff"] <= pk.BINS_REL and old["history_identical"])
    log(f"pfb bins turns: {what} M={m}: plan "
        f"{'direct [M, M] table' if m1 == 1 else f'{m1} x {m2}'}, IDFT "
        f"{res['idft_flop_per_row']} FLOP a row (direct {8 * m * m}), k={k} "
        f"wb={wb} slabs={slabs} shared {shared} B; ef6af1a "
        f"{old['other_ms'][0]:.4f}, kernel {old['package_ms'][0]:.4f}, "
        f"{old['package_ms'][1]:.4f}, ef6af1a {old['other_ms'][1]:.4f} ms: "
        f"{old['speedup']:.2f}x, bins within {old['max_rel_diff']:.3e} of "
        f"max|bins|, history identical {old['history_identical']}")
    log(f"pfb bins kernel: {what} S={s} T={t} {res['wire']} M={m} P={p}: "
        f"max |err| {err:.3e} = {err / scale:.3e} of max|bins| (bound "
        f"{pk.BINS_REL:g}), new history identical {same}; chain "
        f"{res['plain_turns_ms'][0]:.4f}, kernel "
        f"{res['kernel_turns_ms'][0]:.4f}, {res['kernel_turns_ms'][1]:.4f}, "
        f"chain {res['plain_turns_ms'][1]:.4f} ms: {res['speedup']:.2f}x; "
        f"plain {res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {nbytes} B, {flops:.4g} FLOP), share "
        f"{res['share_of_bound']:.3f}; library (torch.fft.ifft of the rows) "
        f"{res['library_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"pfb bins kernel: {what} disagrees")
    return res


def phase_pfb_bins(dev) -> dict:
    """``pfb bins kernel:`` the pfb step's coarse PFB in one kernel at the
    bench shape (128 sources × 240000 bf16 samples, M = 6, P = 24, a
    random mid-stream history) and on the runtime's float32 wire, then
    the pfb mode's 80 dB banks at M = 8, 16, 20, 25, 50 and 100
    (``PFB_BINS_CASES``: 3.2 to 40 MS/s, 16 sources × 100 ms), and a
    60-sample block after the bench block, from the kernel's own new
    history."""
    from radiocapture_tpu_torch.ops.channelizer import PfbChannelizer
    gen = torch.Generator(device=dev).manual_seed(9)

    def cnormal(*shape):
        return torch.view_as_complex(torch.randn(shape + (2,),
                                                 generator=gen, device=dev))

    pfb = PfbChannelizer.for_rates(SAMP_RATE, 6, atten_db=80.0)
    s = BENCH_SOURCES
    hist = cnormal(s, (pfb.p - 1) * pfb.num_channels)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    res = {"bf16": pfb_bins_case(pfb, hist, x, "bench"),
           "f32": pfb_bins_case(pfb, hist, x.float(), "runtime float32")}
    for m, wire in PFB_BINS_CASES:
        pm = PfbChannelizer.for_rates(m * BIN_RATE, m, atten_db=80.0)
        xm = torch.randn((PFB_BINS_SOURCES, int(m * BIN_RATE * 0.1), 2),
                         generator=gen, device=dev)
        xm = (torch.view_as_complex(xm) if wire == "complex64" else
              xm.to(getattr(torch, wire)))
        res[f"m{m}"] = pfb_bins_case(
            pm, cnormal(PFB_BINS_SOURCES, (pm.p - 1) * m), xm,
            f"{m * BIN_RATE / 1e6:g} MS/s bank")
        del xm
    after, _ = pfb.bins(pfb.init(s, dev)._replace(history=hist), x)
    res["short"] = pfb_bins_case(pfb, after.history, x[:, :60].contiguous(),
                                 "short block after the bench block")
    res["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    res["max_rel_err"] = max(r["max_rel_err"] for r in res.values()
                             if isinstance(r, dict))
    return res


def phase_decode_pfb(dev) -> tuple[dict, dict]:
    """``decode pfb:`` the grant through the pfb step as it runs
    (``pfb_fine``), then ``decode pfb modulated:`` the same stream with
    the fine stage swapped for the form it replaced (the complex bank on
    the gathered rows' modulated taps): the fixture slots' dibits and
    valid flags must be identical. Returns both runs' launch counts."""
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    from radiocapture_tpu_torch.ops import channelizer as chz
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    got, old = {}, {}
    launches = phase_decode(
        dev, ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE, frontend="pfb"),
        "decode pfb", ("pfb_bins", "pfb_fine", "fsk_track"), keep=got)

    def modulated(xb, rows, hist, taps, fine, phase0, step, d, c):
        y = ck.bank_complex(xb[rows], hist,
                            chz.modulated_taps(taps, fine[:, None]),
                            phase0[:, None], step[:, None], d)
        return chz.planes(y.view(-1, c, y.shape[-1]))

    mixer, chz.pfb_fine = chz.pfb_fine, modulated
    try:
        modulated_launches = phase_decode(
            dev, ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE, frontend="pfb"),
            "decode pfb modulated", ("pfb_bins", "xlat_complex",
                                     "fsk_track"), keep=old)
    finally:
        chz.pfb_fine = mixer
    for key, (dib, val) in got.items():
        same = (np.array_equal(dib[val.astype(bool)],
                               old[key][0][old[key][1].astype(bool)])
                and np.array_equal(val, old[key][1]))
        log(f"decode pfb: source {key[0]} slot {key[1]}: dibits and valid "
            f"flags against the modulated taps': {int(val.sum())} valid "
            f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("decode pfb: the mixer's dibits differ")
    return launches, modulated_launches


def pfb_launches_match(what: str, launches: dict) -> None:
    """The pfb path's coarse PFB and fine stage ran once a pipeline step:
    as many ``pfb_bins`` launches as ``pfb_fine`` ones, and no
    ``pfb_rows`` or ``xlat_complex``."""
    ok = (launches["pfb_bins"] == launches["pfb_fine"] > 0
          and launches["pfb_rows"] == launches["xlat_complex"] == 0)
    log(f"{what}: pfb_bins {launches['pfb_bins']} launches, pfb_fine "
        f"{launches['pfb_fine']}, xlat_complex {launches['xlat_complex']}, "
        f"pfb_rows {launches['pfb_rows']}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: pfb_bins not once a step")


def phase_frontend_bench(dev, frontend: str,
                         samp_rate: float = SAMP_RATE) -> dict:
    """``ControlPipeline.p25_c4fm(64, samp_rate, frontend=...)`` at 128
    sources, bf16 wire blocks of ``frontend_block`` samples (fft: 390336,
    162.6 ms): step ms by CUDA events, MS/s, latency p50/p95 against the
    block's own duration, peak memory and the profile; for pfb also
    ``pfb_bins``' ms a step in the profile and its share of the step."""
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    s = BENCH_SOURCES
    pipe = ControlPipeline.p25_c4fm(SLOTS, samp_rate, frontend=frontend)
    blk = frontend_block(pipe, samp_rate)
    block_ms = blk / samp_rate * 1e3
    what = (frontend if samp_rate == SAMP_RATE
            else f"{frontend} {samp_rate / 1e6:g} MS/s")
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((s, blk, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(s, dev, samp_rate)
    box = [pipe.init(s, dev)]

    def one_step():
        box[0], out = pipe.step(box[0], x, offs)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    win_ms = [cuda_ms(one_step, 3) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    step_kernels = []
    busy = profile_steps(one_step, f"c4fm {what}",
                         *((PFB_GLUE, pipe.bank.pfb.p - 1)
                           if frontend == "pfb" else ()),
                         kernels=step_kernels)
    med = float(np.median(win_ms))
    res = {"frontend": frontend, "samp_rate": samp_rate, "sources": s,
           "slots": SLOTS, "block": blk,
           "block_ms": block_ms, "window_step_ms": win_ms,
           "step_ms_median": med, "msps_median": s * blk / med / 1e3,
           "latency_p50_ms": lat[len(lat) // 2],
           "latency_p95_ms": lat[int(len(lat) * 0.95)],
           "peak_mem_bytes": peak, "profile_busy_share": busy}
    if frontend == "pfb":
        bins_ms = sum(ms for k, _, ms in step_kernels if "pfb_bins" in k)
        res.update(M=pipe.bank.m, pfb_bins_ms=bins_ms,
                   pfb_bins_share=bins_ms / med)
        log(f"bench {what}: pfb_bins (M={pipe.bank.m}) {bins_ms:.4f} ms a "
            f"step in the profile, {bins_ms / med:.3f} of the step")
    if frontend == "pfb" and samp_rate == SAMP_RATE:
        res["planes_copies"] = planes_copies(pipe.bank, box[0].bank, x, offs,
                                             step_kernels)
    elif frontend == "pfb":
        from radiocapture_tpu_torch.tools import track_turns
        t = track_turns.bins_step_turns(track_turns.EARLIER_BINS, samp_rate,
                                        s)
        res["ef6af1a_step_turns"] = t
        log(f"bench {what}: the step with ef6af1a's pfb_bins (the direct "
            f"table) in turns: {t['other_step_ms'][0]:.3f}, this one "
            f"{t['package_step_ms'][0]:.3f}, {t['package_step_ms'][1]:.3f}, "
            f"ef6af1a {t['other_step_ms'][1]:.3f} ms: {t['speedup']:.3f}x")
    log(f"bench {what}: " + json.dumps(res))
    log(f"bench {what}: {type(pipe.bank).__name__} step median "
        f"{med:.3f} ms per {block_ms:.1f} ms block ({med / block_ms:.4f} of "
        f"it) = {res['msps_median']:.1f} MS/s; latency p50 "
        f"{res['latency_p50_ms']:.3f} / p95 {res['latency_p95_ms']:.3f} ms; "
        f"peak {peak / 2 ** 30:.2f} GiB")
    return res


def planes_copies(bank, state, x, offs, step_kernels) -> dict:
    """The pfb step runs none of the kernels of ``ops/channelizer.py::
    planes`` (two ``.contiguous()`` copies of [S, C, N] channels
    transposed, which ``PfbXlatBank.call_planes`` ran once a step before
    ``pfb_fine`` wrote the planes itself): ``planes()`` of the bank's
    channels profiled alone, each device kernel's full name, launches a
    call and ms, and what the step's profile (``step_kernels``) ran of
    the same kernels, which must be nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from radiocapture_tpu_torch.ops.channelizer import planes
    _, y = bank(state, x, offs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            planes(y)
        torch.cuda.synchronize()
    in_step = {k: (n, ms) for k, n, ms in step_kernels}
    res = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Memcpy"):
            continue
        n, ms = in_step.get(e.key, (0.0, 0.0))
        res.append({"kernel": e.key, "launches": e.count / PROFILE_STEPS,
                    "ms": e.self_device_time_total / 1e3 / PROFILE_STEPS,
                    "step_launches": n, "step_ms": ms})
        log(f"profile: c4fm pfb: planes() of [S, C, N] channels launches "
            f"{res[-1]['launches']:.1f} x {e.key} ({res[-1]['ms']:.3f} ms a "
            f"call); the step runs it {n:.1f} times, {ms:.3f} ms "
            f"{'ok' if n == 0 else 'FAIL'}")
    if not res or any(r["step_launches"] for r in res):
        raise AssertionError("profile: c4fm pfb: the step copies the "
                             "channels into planes")
    return {"kernels": res}


def phase_fsk4_block(dev, pipe) -> dict:
    """``ControlPipeline.fsk4_block = 10`` at the C4FM bench shape: the
    step with ``fsk4_demod_block`` (plain torch on the card: ~25 eager
    ops per 10-sample chunk, 125 chunks per block) against the same step
    on the exact tracker kernel, host clock with a sync per step; then
    the decode phase's P25 grants through the block tracker."""
    s = BENCH_SOURCES
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(s, dev)
    res = {}
    for blk in (10, 0):
        pipe.fsk4_block = blk
        st = pipe.init(s, dev)
        st, out = pipe.step(st, x, offs)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            st, out = pipe.step(st, x, offs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(out[0]).all()):
            raise AssertionError("non-finite symbols")
        res[f"step_ms_block{blk}"] = float(np.median(times))
    # the block tracker's output: the decode phase's P25 grants, with the
    # tracker kernel launched no time
    pipe.fsk4_block = 10
    launches = phase_decode(dev, pipe, "decode fsk4 block",
                            ("bank_operands", "xlat_bank"))
    if launches["fsk_track"]:
        raise AssertionError(f"fsk4_block ran the tracker kernel: {launches}")
    pipe.fsk4_block = 0
    log(f"fsk4 block: C4FM bench shape S={s} C={SLOTS}: step with "
        f"fsk4_block=10 (plain torch) {res['step_ms_block10']:.3f} ms "
        f"against {res['step_ms_block0']:.3f} ms on the fsk_track kernel "
        f"(median of 3, host clock)")
    return res


def spectrum_close(got, want, what: str) -> float:
    """Spectrum ``got`` against ``want`` per bin within
    ``streams.spectrum_tolerance`` (two float32 FFTs differ by a few ulps
    of the largest bin). Returns max |err|."""
    from radiocapture_tpu_torch.testing import streams
    tol = streams.spectrum_tolerance(want)
    err = np.abs(got - want)
    strong = want.max() - want < 6.0
    ok = bool(np.all(err <= tol))
    log(f"decode scan: {what} card vs CPU spectrum max_abs_err "
        f"{float(err.max()):.3e} (within 6 decades of the peak "
        f"{float(err[strong].max()):.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's spectrum disagrees with the CPU's")
    return float(err.max())


def phase_decode_scan(dev) -> dict:
    """The scan slice's path on the card: ``SpectrumScanner`` →
    ``find_channels`` on ``tests/test_scan.py``'s two carriers (both
    found, the same peaks as the CPU port's), ``trial_p25_lock`` with
    three candidates on its site capture (only the true control channel
    locks, with its System ID, Site ID, Control Channel and offset; the
    CPU port decides alike), and the scan CLI's fft mode on a written
    capture (a locked summary line). Fails unless ``xlat_bank`` and
    ``fsk_track`` ran. Returns the kernels' launch counts."""
    import tempfile
    from radiocapture_tpu_torch.scan import (SpectrumScanner, find_channels,
                                             trial_p25_lock)
    from radiocapture_tpu_torch.scan.__main__ import main as scan_main
    from radiocapture_tpu_torch.testing import streams
    wide = streams.two_carriers(SAMP_RATE)
    x = np.stack([wide.real, wide.imag], -1)
    site = streams.site_capture(SCAN_CC, SCAN_CENTER)
    cands = [SCAN_CC + 200.0, SCAN_CENTER - 300e3, SCAN_CENTER + 600e3]
    cli_cc = SCAN_CC - 100e3
    ch = streams.site_capture(cli_cc, SCAN_CENTER, n_frames=30)
    cli = streams.site_capture(cli_cc, SCAN_CENTER, n_frames=30,
                               n=len(ch) // 16384 * 16384,
                               rng=np.random.default_rng(3))
    sc = SpectrumScanner(16384)
    want_spec = sc.spectrum_db(sc.step(sc.init("cpu"), x))
    want_trial = trial_p25_lock(site, SAMP_RATE, SCAN_CENTER, cands,
                                device="cpu")
    reset_kernel_counts()
    spec = sc.spectrum_db(sc.step(sc.init(dev), x))
    results = trial_p25_lock(site, SAMP_RATE, SCAN_CENTER, cands,
                             device=dev)
    with tempfile.TemporaryDirectory(prefix="rc_smoke_scan_") as tmp:
        path, out = Path(tmp) / "cap.dat", Path(tmp) / "fft.scan.output"
        cli.astype(np.complex64).tofile(path)
        scan_main(["fft", str(path), "-r", str(SAMP_RATE), "-f",
                   str(SCAN_CENTER), "-o", str(out)], device=dev)
        lines = out.read_text().splitlines()
    torch.cuda.synchronize()
    launches = kernel_counts()
    err = spectrum_close(spec, want_spec, "two carriers")
    peaks = [p.frequency for p in find_channels(spec, SAMP_RATE,
                                                SCAN_CENTER)]
    want_peaks = [p.frequency for p in find_channels(want_spec, SAMP_RATE,
                                                     SCAN_CENTER)]
    found = all(any(abs(f - (SCAN_CENTER + off)) < 6e3 for f in peaks)
                for off in (-400e3, 250e3))
    if peaks != want_peaks or not found:
        raise AssertionError(f"peaks {peaks}, CPU {want_peaks}")
    log(f"decode scan: spectrum peaks {[int(f) for f in peaks]} "
        f"(the CPU port's) ok")
    hit = results[0]
    truth = (hit.locked and not results[1].locked and not results[2].locked
             and hit.site_detail.get("System ID") == hex(0x2C1)
             and hit.site_detail.get("Site ID") == 7
             and hit.site_detail.get("Control Channel") == int(SCAN_CC)
             and abs(hit.offset_hz - 200.0) < OFFSET_TOL_HZ)
    if not truth or not streams.same_trials(results, want_trial,
                                            OFFSET_TOL_HZ):
        raise AssertionError(f"trial lock {results} against CPU "
                             f"{want_trial}")
    log(f"decode scan: trial_p25_lock C=3: {hit.summary_line(0)}; only "
        f"the control channel locked, offset {hit.offset_hz:.1f} Hz, as "
        f"the CPU port decided ok")
    locked = [ln for ln in lines
              if not ln.startswith("#") and "None None" not in ln]
    if not any(str(int(cli_cc)) in ln for ln in locked):
        raise AssertionError(f"scan CLI: no locked line in {lines}")
    log(f"decode scan: scan CLI fft: {len(lines)} lines, locked: "
        f"{locked}; launches {launches}")
    if min(launches[k] for k in ("bank_operands", "xlat_bank",
                                 "fsk_track")) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return {"launches": launches, "spectrum_max_abs_err": err}


def phase_decode_scanner(dev) -> dict:
    """``ScanningReceiver`` on the card, SCAN_CHANNELS channels (an FM
    carrier on the first): new call, activity, timeout after the hang
    time, the same events and CDRs as the CPU port's. Fails unless
    ``xlat_bank`` and ``fm_voice`` ran. Returns the launch counts."""
    from radiocapture_tpu_torch.scan import ScanChannel, ScanningReceiver
    from radiocapture_tpu_torch.testing import streams
    freqs = [SCAN_CENTER + 100e3] + [
        SCAN_CENTER - 600e3 + k * 12.5e3 for k in range(SCAN_CHANNELS - 1)]
    want, _ = streams.squelch_cycle(ScanningReceiver, ScanChannel, freqs,
                                    SCAN_CENTER, device="cpu")
    reset_kernel_counts()
    got, opened = streams.squelch_cycle(ScanningReceiver, ScanChannel,
                                        freqs, SCAN_CENTER, device=dev)
    torch.cuda.synchronize()
    launches = kernel_counts()
    kinds = [k for k, _ in got]
    if (got != want or kinds[0] != "new" or kinds[-1] != "to"
            or "act" not in kinds or len(opened) != 1
            or opened[0]["system_group_local"] != freqs[0]):
        raise AssertionError(f"scanner events {got}, CPU {want}")
    log(f"decode scanner: {SCAN_CHANNELS} channels, events {kinds} (the "
        f"CPU port's), CDR group {opened[0]['system_group_local']:.0f} ok; "
        f"launches {launches}")
    if min(launches[k] for k in ("bank_operands", "xlat_bank",
                                 "fm_voice")) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return {"launches": launches}


def phase_decode_file_to_wav(dev) -> dict:
    """``file_to_wav`` on the card: the analog chain on
    ``tests/test_file_to_wav.py``'s 700 Hz tone at −300 kHz (the WAV
    peaks at the tone; its PCM within WAV_REL_TOL of full scale of the CPU
    port's) and ``decode_p25`` on its LDU1 capture (the CPU port's
    frames/ldu/imbe/errors). Fails unless ``xlat_bank``, ``fm_voice`` and
    ``fsk_track`` ran. Returns the launch counts, the PCM error and
    whether the vocoder gave PCM."""
    import tempfile
    from radiocapture_tpu_torch.audio.wav import read_wav
    from radiocapture_tpu_torch.testing import streams
    from radiocapture_tpu_torch.tools.file_to_wav import (decode_p25,
                                                          file_to_wav)
    analog = streams.tone_capture(-300e3)
    ldu = streams.ldu_capture(100e3)
    with tempfile.TemporaryDirectory(prefix="rc_smoke_wav_") as tmp:
        inp = Path(tmp) / "cap.dat"
        analog.tofile(inp)
        want_stats = file_to_wav(str(inp), str(Path(tmp) / "cpu.wav"),
                                 SAMP_RATE, -300e3, "analog", device="cpu")
        want_pcm, _ = read_wav(str(Path(tmp) / "cpu.wav"))
        _, want_p25 = decode_p25(ldu, SAMP_RATE, 100e3, device="cpu")
        reset_kernel_counts()
        stats = file_to_wav(str(inp), str(Path(tmp) / "card.wav"),
                            SAMP_RATE, -300e3, "analog", device=dev)
        pcm_audio, p25 = decode_p25(ldu, SAMP_RATE, 100e3, device=dev)
        torch.cuda.synchronize()
        launches = kernel_counts()
        pcm, rate = read_wav(str(Path(tmp) / "card.wav"))
    peak = streams.tone_peak_hz(pcm)
    err = float(np.abs(pcm.astype(np.int64) - want_pcm.astype(np.int64)
                       ).max()) / 32768.0
    if (stats != want_stats or rate != 8000 or abs(peak - 700.0) >= 15.0
            or err > WAV_REL_TOL):
        raise AssertionError(f"analog WAV: stats {stats} (CPU {want_stats})"
                             f", peak {peak} Hz, max |err| {err}")
    log(f"decode file_to_wav: analog {len(pcm)} samples at {rate} Hz, peak "
        f"{peak:.1f} Hz; PCM max |card - CPU| {err:.3e} of full scale "
        f"(<= {WAV_REL_TOL}) ok")
    if p25 != want_p25 or p25["imbe"] < 9:
        raise AssertionError(f"decode_p25 {p25}, CPU {want_p25}")
    log(f"decode file_to_wav: p25 {p25} (the CPU port's); vocoder PCM "
        f"{'produced, ' + str(len(pcm_audio)) + ' samples' if len(pcm_audio) else 'not produced (no vocoder): frame stats only'}"
        f"; launches {launches}")
    if min(launches[k] for k in ("bank_operands", "xlat_bank", "fm_voice",
                                 "fsk_track")) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return {"launches": launches, "wav_max_abs_err": err,
            "p25_pcm": bool(len(pcm_audio)), "p25_stats": p25}


def scan_bench_capture(seconds: float) -> np.ndarray:
    """One 2.4 MS/s source of ``seconds``: the P25 site's control channel
    at SCAN_CC, an analog FM tone at SCAN_ANALOG and a P25 LDU1 voice
    channel at SCAN_VOICE over a −55 dB floor."""
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    n = int(seconds * SAMP_RATE)
    n_site = int(seconds / 0.07) + 1          # ~75 ms a TSDU frame
    n_ldu = int(seconds / 0.17) + 1           # 180 ms an LDU1
    chans = [
        (SCAN_CC, M.c4fm_modulate(streams.p25_site_control(n_site, SCAN_CC),
                                  fs=25000.0)),
        (SCAN_ANALOG, streams.fm_tone(seconds)),
        (SCAN_VOICE, M.c4fm_modulate(streams.p25_ldu_voice(n_ldu),
                                     fs=25000.0))]
    return M.multi_channel(
        SAMP_RATE, [(f - SCAN_CENTER, M.upsample_to(iq, 25000.0,
                                                    SAMP_RATE)[:n])
                    for f, iq in chans], n, noise_floor_db=-55.0,
        rng=np.random.default_rng(51))


def timed(fn):
    """(fn()'s result, host seconds to its end on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_bench_scan(dev) -> dict:
    """The scan slice at the sizes users run, on one 2.4 MS/s source: the
    spectrum over SCAN_BENCH_S s in ``run_fft_scan``'s 8-frame blocks of
    16384; ``trial_p25_lock`` at TRIAL_SLOTS candidates over SCAN_TRIAL_S
    s (host ms per decim·512 block, split into upload, step, fetch and
    the engines' feed, and the step's device ms); ``run_band_scan`` over
    the capture's whole 12.5 kHz raster (192 candidates, BAND_PASS a
    pass) over SCAN_TRIAL_S s; ``run_fft_scan`` and both ``file_to_wav``
    chains over SCAN_BENCH_S s. Device ms by CUDA events on a block
    already on the card; host ms by the host clock with a sync."""
    from radiocapture_tpu_torch.demod.engines import P25ControlEngine
    from radiocapture_tpu_torch.device import wire_from_numpy
    from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                          ControlPipeline)
    from radiocapture_tpu_torch.scan import SpectrumScanner, trial_p25_lock
    from radiocapture_tpu_torch.scan.__main__ import (run_band_scan,
                                                      run_fft_scan)
    from radiocapture_tpu_torch.testing import streams
    from radiocapture_tpu_torch.tools.file_to_wav import (decode_analog,
                                                          decode_p25)
    t0 = time.perf_counter()
    iq = scan_bench_capture(SCAN_BENCH_S)
    iq2 = iq[:int(SCAN_TRIAL_S * SAMP_RATE)]
    log(f"bench scan: {SCAN_BENCH_S:.0f} s capture built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"card": smi_line()}
    reset_kernel_counts()

    # the spectrum, as run_fft_scan steps it
    sc = SpectrumScanner()
    blk = sc.fft_len * 8
    n_blk = len(iq) // blk

    def spectrum():
        st = sc.init(dev)
        for i in range(n_blk):
            st = sc.step(st, np.stack([iq[i * blk:(i + 1) * blk].real,
                                       iq[i * blk:(i + 1) * blk].imag], -1))
        return st
    spectrum()
    st, host_s = timed(spectrum)
    xb = torch.view_as_complex(torch.as_tensor(np.stack(
        [iq[:blk].real, iq[:blk].imag], -1), device=dev))
    dev_ms = cuda_ms(lambda: sc.step(st, xb), 50)
    res.update(spectrum_blocks=n_blk, spectrum_host_ms_per_block=(
        host_s * 1e3 / n_blk), spectrum_device_ms_per_block=dev_ms,
        spectrum_msps=n_blk * blk / host_s / 1e6,
        spectrum_device_msps=blk / dev_ms / 1e3,
        spectrum_busy_share=profile_steps(lambda: sc.step(st, xb),
                                          "scan spectrum"))
    log(f"bench scan: spectrum {n_blk} blocks of 8 x {sc.fft_len}: host "
        f"{res['spectrum_host_ms_per_block']:.3f} ms/block "
        f"({res['spectrum_msps']:.1f} MS/s), device {dev_ms:.4f} ms/block "
        f"({res['spectrum_device_msps']:.1f} MS/s)")

    # the trial bank at TRIAL_SLOTS candidates
    cands = [SCAN_CC + (k - 40) * 12.5e3 for k in range(TRIAL_SLOTS)]
    pipe = ControlPipeline.p25_c4fm(TRIAL_SLOTS, SAMP_RATE)
    tblk = pipe.decim * 512
    t_blocks = len(iq2) // tblk
    results, host_s = timed(lambda: trial_p25_lock(
        iq2, SAMP_RATE, SCAN_CENTER, cands, device=dev))
    if not any(r.locked and r.frequency == SCAN_CC for r in results):
        raise AssertionError("bench trial: the control channel did not lock")
    x2 = np.stack([iq2.real, iq2.imag], -1).astype(np.float32)
    offs = torch.as_tensor(pipe.offsets_for(np.asarray(cands),
                                            SCAN_CENTER)[None], device=dev)
    state = pipe.init(1, dev)
    engines = [P25ControlEngine() for _ in cands]
    part = dict.fromkeys(("upload", "step", "fetch", "feed"), 0.0)
    for b in range(t_blocks):
        t = [time.perf_counter()]
        xb = wire_from_numpy(x2[None, b * tblk:(b + 1) * tblk], dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        state, (_s, valid, dib) = pipe.step(state, xb, offs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        valid = valid[0].cpu().numpy().astype(bool)
        dib = dib[0].cpu().numpy()
        t.append(time.perf_counter())
        for s, eng in enumerate(engines):
            eng.feed_dibits(dib[s][valid[s]])
        t.append(time.perf_counter())
        for k, a, z in zip(part, t, t[1:]):
            part[k] += (z - a) * 1e3 / t_blocks
    step_ms = cuda_ms(lambda: pipe.step(state, xb, offs), 20)
    res.update(trial_slots=TRIAL_SLOTS, trial_blocks=t_blocks,
               trial_block_samples=tblk,
               trial_host_ms_per_block=host_s * 1e3 / t_blocks,
               trial_device_ms_per_block=step_ms,
               trial_busy_share=profile_steps(
                   lambda: pipe.step(state, xb, offs), "scan trial step"),
               trial_parts_ms_per_block=part,
               trial_locked=[r.frequency for r in results if r.locked])
    log(f"bench scan: trial_p25_lock {TRIAL_SLOTS} slots, {t_blocks} blocks "
        f"of {tblk}: host {res['trial_host_ms_per_block']:.3f} ms/block "
        f"(upload {part['upload']:.3f}, step+sync {part['step']:.3f}, fetch "
        f"{part['fetch']:.3f}, engines {part['feed']:.3f}), device step "
        f"{step_ms:.4f} ms/block; locked {res['trial_locked']}")

    # the band scan over the capture's whole raster
    lo = SCAN_CENTER - SAMP_RATE / 2
    ranges = [(lo, lo + SAMP_RATE - 12.5e3)]
    band, host_s = timed(lambda: run_band_scan(
        iq2, SAMP_RATE, SCAN_CENTER, ranges, 12.5e3, batch=BAND_PASS,
        device=dev))
    if len(band) != 192 or not any(r.locked and r.frequency == SCAN_CC
                                   for r in band):
        raise AssertionError(f"band scan: {len(band)} results, "
                             "the control channel not locked")
    res.update(band_candidates=len(band), band_pass_slots=BAND_PASS,
               band_s_per_s=host_s / SCAN_TRIAL_S,
               band_locked=[r.frequency for r in band if r.locked])
    log(f"bench scan: run_band_scan {len(band)} candidates in passes of "
        f"{BAND_PASS} over {SCAN_TRIAL_S:.0f} s: {host_s:.3f} s = "
        f"{res['band_s_per_s']:.3f} s per s of capture; "
        f"locked {res['band_locked']}")

    # the fft scan CLI's path over the whole capture
    fft_res, host_s = timed(lambda: run_fft_scan(iq, SAMP_RATE, SCAN_CENTER,
                                                 device=dev))
    if not any(r.locked for r in fft_res):
        raise AssertionError("run_fft_scan: nothing locked")
    res.update(fft_scan_candidates=len(fft_res),
               fft_scan_s_per_s=host_s / SCAN_BENCH_S,
               fft_scan_locked=sum(r.locked for r in fft_res))
    log(f"bench scan: run_fft_scan over {SCAN_BENCH_S:.0f} s: {host_s:.3f} s "
        f"= {res['fft_scan_s_per_s']:.4f} s per s of capture; "
        f"{len(fft_res)} peaks trialled, {res['fft_scan_locked']} locked")

    # both file_to_wav chains over the whole capture
    audio, host_s = timed(lambda: decode_analog(
        iq, SAMP_RATE, SCAN_ANALOG - SCAN_CENTER, device=dev))
    peak = streams.tone_peak_hz(audio)
    if abs(peak - 700.0) >= 15.0:
        raise AssertionError(f"bench analog: tone at {peak} Hz")
    vp = AnalogVoicePipeline(1, SAMP_RATE)
    head = iq[:vp.decim * 1024]
    vx = wire_from_numpy(np.stack([head.real, head.imag], -1)[None]
                         .astype(np.float32), dev)
    voffs = torch.zeros((1, 1), device=dev)
    vst = vp.init(1, dev)
    res.update(analog_x_realtime=SCAN_BENCH_S / host_s,
               analog_device_ms_per_block=cuda_ms(
                   lambda: vp.step(vst, vx, voffs), 20))
    (pcm, p25), host_s = timed(lambda: decode_p25(
        iq, SAMP_RATE, SCAN_VOICE - SCAN_CENTER, device=dev))
    # an LDU1 is 180 ms of 9 codewords; the first frames go to sync
    if p25["imbe"] < 9 * int(0.8 * SCAN_BENCH_S / 0.18):
        raise AssertionError(f"bench p25: {p25}")
    cp = ControlPipeline.p25_c4fm(1, SAMP_RATE)
    cst = cp.init(1, dev)
    res.update(p25_x_realtime=SCAN_BENCH_S / host_s, p25_stats=p25,
               p25_pcm=bool(len(pcm)),
               p25_device_ms_per_block=cuda_ms(
                   lambda: cp.step(cst, vx, voffs), 20))
    log(f"bench scan: file_to_wav over {SCAN_BENCH_S:.0f} s: analog "
        f"{res['analog_x_realtime']:.1f}x real time (device "
        f"{res['analog_device_ms_per_block']:.4f} ms per {vp.decim * 1024}"
        f"-sample block), p25 {res['p25_x_realtime']:.1f}x real time "
        f"(device {res['p25_device_ms_per_block']:.4f} ms per block; "
        f"{p25})")
    res["launches"] = kernel_counts()
    return res


# ---------------------------------------------------------------- live
class LiveFeeder:
    """A driver host's send loop: broadcasts ``iq`` (looped from its
    start) through an ``RcIqServer``, one block of ``n`` samples per
    block's duration on an absolute schedule, once a client is connected.
    ``skip(k)`` leaves the next ``k`` blocks out, as a radio that stops
    sending; their samples are lost, as in a real outage."""

    def __init__(self, srv, iq, n: int, rate: float):
        import threading
        self.srv, self.iq, self.n, self.block_s = srv, iq, n, n / rate
        self.skipped = 0
        self.resumed_at = None
        self._skip = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="live-feeder")
        self._thread.start()

    def skip(self, k: int) -> None:
        with self._lock:
            self._skip = k

    def _run(self) -> None:
        deadline = time.time() + LIVE_WAIT_S
        while self.srv.clients == 0 and not self._stop.is_set():
            if time.time() > deadline:
                return
            time.sleep(0.005)
        t0, k, pos = time.perf_counter(), 0, 0
        while not self._stop.is_set():
            blk = np.take(self.iq, np.arange(pos, pos + self.n), mode="wrap")
            pos = (pos + self.n) % len(self.iq)
            with self._lock:
                skip = self._skip > 0
                self._skip -= skip
                if not skip and self.skipped and self.resumed_at is None:
                    self.resumed_at = time.perf_counter()
            if skip:
                self.skipped += 1
            else:
                self.srv.broadcast(blk)
            k += 1
            self._stop.wait(max(0.0, t0 + k * self.block_s
                                - time.perf_counter()))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(LIVE_WAIT_S)
        if self._thread.is_alive():
            raise AssertionError("the live feeder did not stop")


class UploadLog:
    """Wraps the runtime's ``wire_from_numpy`` while a phase runs: the
    dtype of every upload and the host time of the copy calls."""

    def __init__(self):
        from radiocapture_tpu_torch import runtime as rtm
        self.rtm, self.orig = rtm, rtm.wire_from_numpy
        self.dtypes, self.s, self.calls = set(), 0.0, 0

    def __enter__(self):
        def upload(a, device):
            t0 = time.perf_counter()
            x = self.orig(a, device)
            self.s += time.perf_counter() - t0
            self.calls += 1
            self.dtypes.add(str(x.dtype))
            return x
        self.rtm.wire_from_numpy = upload
        return self

    def __exit__(self, *exc):
        self.rtm.wire_from_numpy = self.orig


def live_config(kind: str, args: str, modulation: str = "C4FM",
                cc: float = RT_P25_CC):
    """A one-source live deployment: 64 slots, 100 ms blocks, bf16 wire
    where lossless, one P25 system on ``cc``."""
    import tempfile
    from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                                 SystemConfig)
    cfg = RcConfig(audio_dir=tempfile.mkdtemp(prefix="rc_smoke_live_"))
    cfg.ingest_bf16 = True
    cfg.sources[0] = SourceConfig(type=kind, args=args,
                                  center_freq=RT_CENTER, samp_rate=SAMP_RATE)
    cfg.systems[0] = SystemConfig(type="p25", id="Live",
                                  modulation=modulation,
                                  control_channels=[cc])
    return cfg


def grants_of(msgs: list, group: int) -> list:
    return [m for m in list(msgs) if m.get("name") == "GRP_V_CH_GRANT"
            and m.get("crc") == 0 and m.get("Group Address") == group]


def live_run(dev, cfg, what: str, need: tuple, run) -> dict:
    """``providers_from_config(cfg)`` into ``SiteRuntime(cfg, ..., dev)``
    with the kernel counts at 0; ``run(rt, msgs)`` drives it. Returns the
    runtime's facts: control messages (with arrival times), the upload
    dtypes, the launches, the paced provider's and the ring's counts."""
    import shutil
    from radiocapture_tpu_torch.runtime import (PacedProvider, SiteRuntime,
                                                providers_from_config)
    providers, live = providers_from_config(cfg)
    rt = None
    try:
        if len(live) != 1 or not isinstance(providers[0], PacedProvider):
            raise AssertionError(f"{what}: live {live}, {providers}")
        msgs, times = [], []

        def on_msg(m):
            times.append(time.perf_counter())
            msgs.append(m)
        with UploadLog() as up:
            rt = SiteRuntime(cfg, providers, dev)
            rt.bus.subscribe("/topic/raw_control/*", on_msg)
            reset_kernel_counts()
            t0 = time.perf_counter()
            extra = run(rt, msgs) or {}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
        paced = providers[0]
        res = {"blocks": rt.blocks, "wall_s": wall,
               "pop_ms": paced.pop_s * 1e3 / max(paced.blocks, 1),
               "zero_filled": paced.zero_filled,
               "dropped": live[0].ring.dropped,
               "bytes_in": live[0].bytes_in, "uploads": sorted(up.dtypes),
               "launches": launches, "msgs": msgs, "times": times, **extra}
    finally:
        if rt is not None:
            rt.close()
            shutil.rmtree(cfg.audio_dir, ignore_errors=True)
        for s in live:
            s.stop()
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"{what}: a kernel of the path never ran: "
                             f"{launches}")
    log(f"{what}: {res['blocks']} blocks in {wall:.3f} s, "
        f"{res['bytes_in']} bytes in, ring pop {res['pop_ms']:.3f} ms a "
        f"block, zero-filled {res['zero_filled']}, "
        f"dropped {res['dropped']}, uploads {res['uploads']}, "
        f"launches {launches}")
    return res


def phase_live_rtl_tcp(dev) -> dict:
    """A fake rtl_tcp daemon streams the cu8 P25 control capture of the
    JAX package's ``tests/test_rtl_tcp.py`` in real time; the port's
    ``providers_from_config`` (``ingest_bf16``) feeds ``SiteRuntime`` on
    the card through ``rt.run(duration_s=...)``. The grant (Group
    Address 900, CRC clean) decodes, the groups upload bfloat16, no block
    is zero-filled and the ring drops nothing."""
    from radiocapture_tpu_torch.frontend.rtl_tcp import FakeRtlTcpServer
    from radiocapture_tpu_torch.testing import streams
    srv = FakeRtlTcpServer(streams.live_control("C4FM", group=900),
                           samp_rate=SAMP_RATE, realtime=True)
    try:
        res = live_run(
            dev, live_config("rtlsdr", f"rtl_tcp={srv.host}:{srv.port}"),
            "decode live rtl_tcp",
            ("bank_operands", "xlat_bank", "fsk_track", "fm_voice"),
            lambda rt, msgs: rt.run(duration_s=LIVE_DECODE_S))
    finally:
        srv.close()
    hits = grants_of(res["msgs"], 900)
    if not hits or res["uploads"] != ["torch.bfloat16"] \
            or res["zero_filled"] or res["dropped"]:
        raise AssertionError(f"decode live rtl_tcp: {len(hits)} grants of "
                             f"{len(res['msgs'])} messages, {res}")
    log(f"decode live rtl_tcp: {len(hits)} GRP_V_CH_GRANT (Group Address "
        f"900, crc 0) from {len(res['msgs'])} control messages over "
        f"{res['blocks']} real-time blocks; bf16 upload, 0 zero-filled, "
        f"0 dropped ok; launches xlat_bank {res['launches']['xlat_bank']} "
        f"fsk_track {res['launches']['fsk_track']} fm_voice "
        f"{res['launches']['fm_voice']}")
    return res


def phase_live_split2(dev) -> dict:
    """A driver host (``RcIqServer``) streams cs16 at 2.4 MS/s in real
    time: the P25 CQPSK (LSM) control fixture 75 kHz below split2's lower
    half's centre. A ``usrp`` source with ``receiver_split2`` splits it on
    the card (complex bank) into two 1.2 MS/s halves and the runtime's
    CQPSK group decodes the grant (Group Address 902); the upload is
    float32 (cs16 is not lossless in bf16)."""
    from radiocapture_tpu_torch.frontend.pipeline import SpectrumSplit2
    from radiocapture_tpu_torch.frontend.rciq import RcIqServer
    from radiocapture_tpu_torch.testing import streams
    cc = SpectrumSplit2(SAMP_RATE).half_center(RT_CENTER, 0) - 75e3
    iq = streams.live_control("CQPSK", group=902, center=RT_CENTER,
                              cc_freq=cc)
    srv = RcIqServer(SAMP_RATE, RT_CENTER, fmt="cs16")
    feeder = LiveFeeder(srv, iq, BLOCK, SAMP_RATE)
    cfg = live_config("usrp", f"rciq={srv.host}:{srv.port}",
                      modulation="CQPSK", cc=cc)
    cfg.receiver_split2 = True
    try:
        res = live_run(dev, cfg, "decode live rciq split2",
                       ("xlat_complex", "bank_operands", "xlat_bank",
                        "agc", "cqpsk_track"),
                       lambda rt, msgs: rt.run(duration_s=LIVE_DECODE_S))
    finally:
        feeder.stop()
        srv.close()
    hits = grants_of(res["msgs"], 902)
    if not hits or res["uploads"] != ["torch.float32"] \
            or res["zero_filled"] or res["dropped"]:
        raise AssertionError(f"decode live rciq split2: {len(hits)} grants "
                             f"of {len(res['msgs'])} messages, {res}")
    log(f"decode live rciq split2: {len(hits)} GRP_V_CH_GRANT (Group "
        f"Address 902, crc 0) on the CQPSK group of split2 half 0 "
        f"({cc / 1e6:.4f} MHz) over {res['blocks']} half-rate blocks; "
        f"float32 upload, 0 zero-filled, 0 dropped ok; launches "
        f"xlat_complex {res['launches']['xlat_complex']} cqpsk_track "
        f"{res['launches']['cqpsk_track']}")
    return res


def phase_live_dropout(dev) -> dict:
    """A ``usrp`` source fed by a driver host that stops sending for
    LIVE_GAP blocks once the runtime has decoded the grant (Group Address
    903). The runtime zero-fills exactly those blocks, one block's
    duration apart (the paced provider's stream cadence), and decodes the
    grant again once the stream resumes."""
    from radiocapture_tpu_torch.frontend.rciq import RcIqServer
    from radiocapture_tpu_torch.testing import streams
    srv = RcIqServer(SAMP_RATE, RT_CENTER, fmt="cs16")
    feeder = LiveFeeder(srv, streams.live_control("C4FM", group=903),
                        BLOCK, SAMP_RATE)
    block_s = feeder.block_s

    def run(rt, msgs):
        paced = rt.providers[0]
        fills, deadline = [], time.perf_counter() + LIVE_WAIT_S
        while not grants_of(msgs, 903):
            if time.perf_counter() > deadline:
                raise AssertionError("decode live dropout: no grant before "
                                     "the gap")
            rt.step()
        feeder.skip(LIVE_GAP)
        after = None
        while after is None or rt.blocks < after + LIVE_AFTER_BLOCKS:
            if time.perf_counter() > deadline + LIVE_WAIT_S:
                raise AssertionError("decode live dropout: stream did not "
                                     "resume")
            z, t0 = paced.zero_filled, time.perf_counter()
            rt.step()
            if paced.zero_filled > z:
                fills.append((rt.blocks, t0 + paced.last_wait_s,
                              paced.last_wait_s))
            elif fills and after is None:
                after = rt.blocks
        return {"fills": fills, "resume_block": after}

    try:
        res = live_run(dev, live_config("usrp",
                                        f"rciq={srv.host}:{srv.port}"),
                       "decode live dropout",
                       ("bank_operands", "xlat_bank", "fsk_track"),
                       run)
    finally:
        feeder.stop()
        srv.close()
    fills = res["fills"]
    gaps = [b[1] - a[1] for a, b in zip(fills, fills[1:])]
    blocks = [f[0] for f in fills]
    after = [t for t, m in zip(res["times"], res["msgs"])
             if feeder.resumed_at is not None and t > feeder.resumed_at
             and grants_of([m], 903)]
    ok = (len(fills) == LIVE_GAP == feeder.skipped
          and blocks == list(range(blocks[0], blocks[0] + LIVE_GAP))
          and all(abs(g - block_s) <= LIVE_CADENCE_TOL_S for g in gaps)
          and fills[0][2] <= 1.5 * block_s + LIVE_CADENCE_TOL_S
          and res["zero_filled"] == LIVE_GAP and not res["dropped"]
          and len(after) > 0)
    log(f"decode live dropout: the driver host skipped {feeder.skipped} "
        f"blocks; zero-filled blocks {blocks} after waits "
        f"{[round(f[2] * 1e3, 3) for f in fills]} ms, "
        f"{[round(g * 1e3, 3) for g in gaps]} ms apart (block "
        f"{block_s * 1e3:.0f} ms); {len(after)} grants after the stream "
        f"resumed (block {res['resume_block']}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode live dropout: {res}")
    return res


def _live_senders(n: int, conn) -> None:
    """A child process of ``bench live``: ``n`` real-time fake rtl_tcp
    daemons streaming the cu8 control capture; sends their ports, then
    serves until told to stop."""
    from radiocapture_tpu_torch.frontend.rtl_tcp import FakeRtlTcpServer
    from radiocapture_tpu_torch.testing import streams
    iq = streams.live_control("C4FM")
    srvs = [FakeRtlTcpServer(iq, samp_rate=SAMP_RATE, realtime=True)
            for _ in range(n)]
    try:
        conn.send([s.port for s in srvs])
        conn.recv()
    finally:
        for s in srvs:
            s.close()


def live_bench_at(dev, ports: list) -> dict:
    """``SiteRuntime`` at len(ports) real-time rtl_tcp sources × 64
    slots (bf16 wire): warm-up steps, then LIVE_BENCH_S of steps. Per
    step: wall time, and its work (wall less the paced waits); per block:
    the ring pops, the stack and the upload; bytes in per second,
    zero-filled blocks, ring drops, and the profiler's busy share."""
    import shutil
    import tempfile
    from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                                 SystemConfig)
    from radiocapture_tpu_torch.runtime import (SiteRuntime,
                                                providers_from_config)
    s = len(ports)
    what = f"bench live: S={s}"
    cfg = RcConfig(audio_dir=tempfile.mkdtemp(prefix="rc_smoke_bench_"))
    cfg.ingest_bf16 = True
    for i, port in enumerate(ports):
        cfg.sources[i] = SourceConfig(type="rtlsdr",
                                      args=f"rtl_tcp=127.0.0.1:{port}",
                                      center_freq=RT_CENTER + i * SAMP_RATE,
                                      samp_rate=SAMP_RATE)
    cfg.systems[0] = SystemConfig(type="p25", id="P25",
                                  control_channels=[RT_P25_CC])
    providers, live = providers_from_config(cfg)
    rt = None
    try:
        with UploadLog() as up:
            rt = SiteRuntime(cfg, providers, dev)
            stack = rt._stack
            stack_s = [0.0]

            def timed_stack(key, xs):
                t0 = time.perf_counter()
                out = stack(key, xs)
                stack_s[0] += time.perf_counter() - t0
                return out
            rt._stack = timed_stack
            for _ in range(LIVE_WARM_STEPS):
                rt.step()
            paced = list(providers.values())

            def totals():
                return (sum(p.wait_s for p in paced),
                        sum(p.pop_s for p in paced),
                        sum(p.zero_filled for p in paced),
                        sum(x.bytes_in for x in live),
                        sum(x.ring.dropped for x in live))
            w0, p0, z0, b0, d0 = totals()
            stack_s[0], up.s, up.calls = 0.0, 0.0, 0
            wall, work = [], []
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < LIVE_BENCH_S:
                w = sum(p.wait_s for p in paced)
                t0 = time.perf_counter()
                rt.step()
                dt = time.perf_counter() - t0
                wall.append(dt * 1e3)
                work.append((dt - (sum(p.wait_s for p in paced) - w)) * 1e3)
            elapsed = time.perf_counter() - t_start
            w1, p1, z1, b1, d1 = totals()
            n = len(wall)
            busy = profile_steps(rt.step, f"live S={s}")
    finally:
        if rt is not None:
            rt.close()
        for x in live:
            x.stop()
        shutil.rmtree(cfg.audio_dir, ignore_errors=True)
    wall.sort()
    work.sort()
    res = {"sources": s, "slots": SLOTS, "block_ms": BLOCK / SAMP_RATE * 1e3,
           "wire": "bfloat16", "steps": n, "seconds": elapsed,
           "step_wall_p50_ms": wall[n // 2],
           "step_wall_p95_ms": wall[int(n * 0.95)],
           "step_work_p50_ms": work[n // 2],
           "step_work_p95_ms": work[int(n * 0.95)],
           "wait_ms_per_block": (w1 - w0) * 1e3 / n,
           "pop_ms_per_block": (p1 - p0) * 1e3 / n,
           "stack_ms_per_block": stack_s[0] * 1e3 / n,
           "upload_ms_per_block": up.s * 1e3 / n,
           "bytes_in_per_s": (b1 - b0) / elapsed,
           "wire_bytes_per_s": 2 * SAMP_RATE * s,
           "zero_filled": z1 - z0, "dropped": d1 - d0,
           "dropped_total": d1, "profile_busy_share": busy}
    res["real_time"] = res["step_work_p95_ms"] <= res["block_ms"] \
        and res["dropped_total"] == 0
    log(f"{what}: " + json.dumps(res))
    log(f"{what}: step work p50 {res['step_work_p50_ms']:.3f} / p95 "
        f"{res['step_work_p95_ms']:.3f} ms (wall p95 "
        f"{res['step_wall_p95_ms']:.3f}) vs {res['block_ms']:.0f} ms block; "
        f"per block: ring pops {res['pop_ms_per_block']:.3f} ms, stack "
        f"{res['stack_ms_per_block']:.3f} ms, upload "
        f"{res['upload_ms_per_block']:.3f} ms; "
        f"{res['bytes_in_per_s'] / 1e6:.3f} MB/s in of "
        f"{res['wire_bytes_per_s'] / 1e6:.3f}; zero-filled "
        f"{res['zero_filled']}, dropped {res['dropped_total']}; busy share "
        f"{busy:.3f}; {'real time' if res['real_time'] else 'NOT real time'}")
    return res


def phase_live_bench(dev) -> list:
    """Real-time rtl_tcp senders in child processes (LIVE_SENDERS_PER_PROC
    each, so that no sender falls behind for its process's GIL) feed one
    ``SiteRuntime`` at S = LIVE_BENCH_SOURCES in turn, stopping after the
    first S that is not real time (step work p95 over the block, or a
    ring dropped samples)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    n = max(LIVE_BENCH_SOURCES)
    kids = []
    out = []
    try:
        for _ in range(-(-n // LIVE_SENDERS_PER_PROC)):
            here, there = ctx.Pipe()
            child = ctx.Process(target=_live_senders,
                                args=(LIVE_SENDERS_PER_PROC, there),
                                daemon=True)
            child.start()
            kids.append((child, here))
        ports = []
        for child, here in kids:
            if not here.poll(LIVE_SPAWN_S):
                raise AssertionError("bench live: the senders did not start")
            ports += here.recv()
        for s in LIVE_BENCH_SOURCES:
            out.append(live_bench_at(dev, ports[:s]))
            if not out[-1]["real_time"]:
                break
    finally:
        for child, here in kids:
            try:
                here.send("stop")
            except OSError:
                pass                   # the child has gone already
        for child, _ in kids:
            child.join(LIVE_WAIT_S)
            if child.is_alive():
                child.terminate()
                child.join(LIVE_WAIT_S)
    log(f"bench live: real time up to S="
        f"{max([r['sources'] for r in out if r['real_time']], default=0)} "
        f"of {[r['sources'] for r in out]}")
    return out


def phase_soak() -> dict:
    """``python -m radiocapture_tpu_torch.tools.soak --target 256`` on the
    card: two runtimes on one broker, every drain invariant at zero."""
    import shutil
    import tempfile
    audio = tempfile.mkdtemp(prefix="rc_smoke_soak_")
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, "-m", "radiocapture_tpu_torch.tools.soak",
             "--target", str(SOAK_TARGET), "--audio-dir", audio],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=SOAK_TIMEOUT_S)
    finally:
        shutil.rmtree(audio, ignore_errors=True)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"soak: exit {p.returncode}: {p.stderr[-3000:]}")
    res = json.loads(p.stdout.strip().splitlines()[-1])
    drains = ("grants_denied", "stuck_calls_after_drain",
              "leaked_slots_after_drain", "recorder_backlog_after_drain")
    ok = all(res[k] == 0 for k in drains) \
        and res["peak_concurrency"] >= SOAK_TARGET
    log("soak: " + json.dumps(res))
    log(f"soak: target {SOAK_TARGET}, peak {res['peak_concurrency']} "
        f"concurrent calls over {res['runtimes']} runtimes, "
        f"{res['calls_opened']} opened; open latency p50 "
        f"{res['open_latency_p50_s']} / p95 {res['open_latency_p95_s']} s "
        f"(warm p95 {res['warm_latency_p95_s']}, cold p95 "
        f"{res['cold_latency_p95_s']}; {res['warm_opens']} warm, "
        f"{res['cold_opens']} cold), wall {res['wall_seconds']} s "
        f"({wall:.1f} s with start-up); "
        + ", ".join(f"{k} {res[k]}" for k in drains)
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("soak: a drain invariant is not zero")
    return {**res, "command_s": wall}


def phase_longevity(dev) -> dict:
    """``tools/longevity.py`` on the card for LONGEVITY_S: call churn on
    one soak site; from cycle LONGEVITY_FLAT_FROM on, every sample of
    ``torch.cuda.memory_allocated`` must be the same."""
    import contextlib
    import io
    from radiocapture_tpu_torch.tools import longevity
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = longevity.main(LONGEVITY_S, device=dev)
    for line in buf.getvalue().splitlines():
        log(f"longevity: {line}")
    late = [x["cuda_allocated"] for x in res["samples"]
            if x["cycle"] >= LONGEVITY_FLAT_FROM]
    flat = len(late) >= 2 and max(late) == min(late)
    log(f"longevity: {res['cycles']} cycles, {res['blocks']} blocks in "
        f"{LONGEVITY_S:.0f} s; rss {res['rss_mb_start']} -> "
        f"{res['rss_mb_end']} MB, threads {res['threads_start']} -> "
        f"{res['threads_end']}; memory_allocated from cycle "
        f"{LONGEVITY_FLAT_FROM}: {late} {'flat ok' if flat else 'FAIL'}")
    if not flat or res["active_end"]:
        raise AssertionError(f"longevity: memory_allocated {late}, "
                             f"{res['active_end']} calls open at the end")
    return {k: v for k, v in res.items() if k != "samples"} | {
        "cuda_allocated": late,
        "cuda_max_allocated": res["samples"][-1]["cuda_max_allocated"]}


def phase_mesh_stream_tracker(dev, pipe) -> tuple[dict, float]:
    """``track_stream`` (``fsk_track_stream_launch``) against its plain
    version (``fsk4_demod`` and the slicer): a P25 fixture's pre-scan
    stream (compacted dibits identical, the grants decoded), noise at
    MESH_SMALL's ragged shapes, then the bench shape (128 sources × 64
    slots × 1250 track-rate samples: the pre-scan stream of the C4FM
    bench planes), with its ms beside the plain version's, the bytes
    bound and the chain's floor. Then ``fsk_track`` in turns with the
    kernel of commit 3e03d30 (``tools/fsk_track_3e03d30.cu``, the file
    before the stream entry): every lane's outputs and state must be
    bit-identical. Returns (numbers, max |err|)."""
    from radiocapture_tpu_torch.demod import fsk4 as K
    from radiocapture_tpu_torch.demod import track_kernel as tk
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops import fm
    from radiocapture_tpu_torch.testing import modulators as M
    from radiocapture_tpu_torch.testing import streams
    from radiocapture_tpu_torch.tools import track_turns
    prm = pipe.track_params
    nt = len(prm.sym_taps)

    dibits, expected = streams.p25_control_stream(
        8, channel=0x1000, group=100, source=555000)
    iq = M.c4fm_modulate(dibits, fs=pipe.channel_fs)
    iq = iq[:len(iq) // prm.sym_decim * prm.sym_decim]
    trk = pipe.prescan(torch.as_tensor(iq[None, None], device=dev),
                       fm.quad_demod_init((1, 1), dev),
                       torch.zeros((1, 1, nt - 1), device=dev)).contiguous()
    got = tk.track_stream(trk, K.fsk4_init((1, 1), dev), prm)
    want = tk.track_stream_plain(trk, K.fsk4_init((1, 1), dev), prm)
    gd, wd = (o[3][0, 0][o[2][0, 0].bool()].cpu().numpy()
              for o in (got, want))
    g = streams.grants(gd)
    if not np.array_equal(gd, wd) or len(g) < 4 or not all(
            e in expected for e in g):
        raise AssertionError(f"stream tracker on the fixture: {len(gd)} vs "
                             f"{len(wd)} dibits, grants {g}")
    err = float((got[1] - want[1]).abs().max())
    log(f"mesh stream tracker: P25 fixture {trk.shape[-1]} track-rate "
        f"samples: compacted dibits identical, {len(g)} grants, "
        f"max_abs_err(syms)={err:.3e} ok")
    rng = np.random.default_rng(3)
    for s, c, m in MESH_SMALL:
        x = torch.as_tensor(3.0 * rng.standard_normal((s, c, m)).astype(
            np.float32), device=dev)
        got = tk.track_stream(x, K.fsk4_init((s, c), dev), prm)
        want = tk.track_stream_plain(x, K.fsk4_init((s, c), dev), prm)
        err = max(err, check_track_noise(
            [o.cpu().numpy() for o in got[1:3]],
            [o.cpu().numpy() for o in want[1:3]],
            f"stream S={s} C={c} M={m}"))

    s = BENCH_SOURCES
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(s, dev)
    state = pipe.init(s, dev)
    for _ in range(3):
        state, _ = pipe.step(state, x, offs)
    n = BLOCK // pipe.decim
    z2, gk, step = pipe.bank.operands(state.bank, x, offs)
    y_re, y_im = ck.bank_fused(z2, gk, state.bank.phase, step, n,
                               pipe.bank.p, pipe.decim)
    trk = pipe.prescan(torch.complex(y_re, y_im).transpose(1, 2),
                       state.quad, state.sym_hist).contiguous()

    def fresh():
        return type(state.fsk4)(*(t.clone() for t in state.fsk4))

    timed = fresh()
    res = {"stream_ms": cuda_ms(lambda: tk.track_stream(trk, timed, prm), 5)}
    got = tk.track_stream(trk, fresh(), prm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tk.track_stream_plain(trk, fresh(), prm)
    torch.cuda.synchronize()
    res["stream_plain_ms"] = (time.perf_counter() - t0) * 1e3
    err = max(err, check_track_noise(
        [o.cpu().numpy() for o in got[1:3]],
        [o.cpu().numpy() for o in want[1:3]],
        f"stream bench shape S={s} C={SLOTS} M={trk.shape[-1]}",
        BENCH_SYM_LANES))
    res["stream_bound_ms"], res["stream_bound_by"] = bound(
        FSK_OPS * trk.numel(), F32_PEAK, tensor_bytes(trk, fresh(), got))
    m = trk.shape[-1]
    rows = trk[0, :32, :tk.PROBE_ROWS].T.contiguous()
    (res["stream_floor_ms"], res["stream_floor_how"], _,
     res["sm_clock_mhz"]) = chain_floor(
        "fsk_track_stream", lambda: tk.chain_probe(rows, m, prm), m,
        "tracked samples", lambda: tk.track_stream(trk, timed, prm))
    log(f"mesh stream tracker: bench shape [{s}, {SLOTS}, {m}]: "
        f"{res['stream_ms']:.4f} ms (plain {res['stream_plain_ms']:.1f} ms), "
        f"bound {res['stream_bound_ms']:.4f} ms ({res['stream_bound_by']}), "
        f"floor {res['stream_floor_ms']:.4f} ms")
    turns = track_turns.fsk_turns(track_turns.EARLIER_FSK, y_re, y_im, state,
                                  prm)
    res["fsk_track_turns"] = turns
    same = turns["identical_lanes"] == turns["lanes"]
    log(f"fsk track turns: 3e03d30 {turns['other_ms']} ms, package "
        f"{turns['package_ms']} ms; {turns['identical_lanes']} of "
        f"{turns['lanes']} lanes bit-identical {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("fsk_track no longer gives 3e03d30's outputs")
    return res, err


def _mesh_trk_rank(dev) -> dict:
    """One rank (a world of 1) of ``mesh decode:``'s card-vs-CPU check:
    ``TimeShardedControlStep.step_debug`` over the dry run's grant
    capture on ``make_mesh3(1)``; returns the pre-scan stream and the
    grant lane's decoded grants."""
    from radiocapture_tpu_torch import entry
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    from radiocapture_tpu_torch.parallel import mesh as MESH
    from radiocapture_tpu_torch.testing import streams
    pipe = ControlPipeline.p25_c4fm(8, entry.DRYRUN_RATE)
    tsh = MESH.TimeShardedControlStep(pipe, MESH.make_mesh3(1), 1)
    wide = entry.grant_capture()
    blk = pipe.block_multiple * 64
    offs = torch.zeros((1, 8), device=dev)
    offs[0, 0] = entry.DRYRUN_OFFSET / entry.DRYRUN_RATE
    st, outs = tsh.init(dev), []
    for i in range(len(wide) // blk):
        xb = wide[i * blk:(i + 1) * blk]
        x = torch.as_tensor(np.stack([xb.real, xb.imag], -1)[None],
                            device=dev)
        st, o = tsh.step_debug(st, x, offs)
        outs.append([v.cpu().numpy() for v in o])
    dib, val, trk = (np.concatenate([o[i] for o in outs], -1)
                     for i in (2, 1, 3))
    return {"trk": trk, "grants": streams.grants(dib[0, 0][val[0, 0] > 0])}


def phase_mesh_decode(dev) -> dict:
    """``entry.dryrun_multichip`` on the card, at world size 1 (NCCL) and 2
    (gloo, both ranks on this card: ``make_mesh(2)`` is 1 × 2, tiles of 4
    of the 8 slots; ``make_mesh3(2)`` is 1 × 1 × 2, the block in two
    chunks): the P25 grant through ``ShardedControlStep`` and through
    ``TimeShardedControlStep``, the ranks holding their logs (dp×tp
    empty; time-sharded one halo, one all_to_all and one all_reduce per
    step at the formulas' bytes) and importing no JAX. Then the
    time-sharded pre-scan stream on the card against the CPU path's
    (``_mesh_trk_rank``, one rank each): the grant lane within
    MESH_TRK_ATOL, the same grants. Fails unless every kernel of both
    steps ran. Returns the launches summed over both worlds."""
    from radiocapture_tpu_torch.entry import dryrun_multichip
    from radiocapture_tpu_torch.parallel import mesh as MESH
    total: dict = {}
    need = {"dp_tp_launches": ("bank_operands", "xlat_bank", "fsk_track"),
            "time_launches": ("xlat_complex", "fsk_track_stream")}
    for n in MESH_WORLDS:
        t0 = time.perf_counter()
        r = dryrun_multichip(n)
        dt = time.perf_counter() - t0
        for rk in r["ranks"]:
            if rk["imported"]:
                raise AssertionError(f"rank {rk['rank']} imported "
                                     f"{rk['imported']}")
            log(f"mesh decode: world {n} ({r['backend']}) rank {rk['rank']} "
                f"on {rk['device']}: dp x tp mesh {r['mesh']} tile "
                f"{rk['dp_tp_shape']} grants {rk['dp_tp_grants']}, no "
                f"collective; time mesh {r['mesh3']} tile {rk['time_shape']} "
                f"grants {rk['time_grants']}, {rk['time_steps']} steps, per "
                f"step {rk['time_bytes']} bytes, staged "
                f"{rk['time_staged_bytes']} B in all; fir max_abs_err "
                f"{rk['fir_max_abs_err']:.3e}")
        for k, names in need.items():
            if min(r["launches"][k][name] for name in names) < 1:
                raise AssertionError(f"world {n}: a kernel of the path never "
                                     f"ran: {r['launches']}")
            for name, v in r["launches"][k].items():
                total[name] = total.get(name, 0) + v
        log(f"mesh decode: world {n} ok in {dt:.1f} s; launches "
            f"{json.dumps(r['launches'])}")
    card = MESH.spawn(1, _mesh_trk_rank)[0]
    cpu = MESH.spawn(1, _mesh_trk_rank, device="cpu")[0]
    err = float(np.abs(card["trk"][:, 0] - cpu["trk"][:, 0]).max())
    ok = err <= MESH_TRK_ATOL and card["grants"] == cpu["grants"] and len(
        card["grants"]) >= 4
    log(f"mesh decode: time-sharded pre-scan stream, card vs CPU, grant "
        f"lane max_abs_err={err:.3e} (tol {MESH_TRK_ATOL}); grants "
        f"{len(card['grants'])} / {len(cpu['grants'])} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the time-sharded step on the card disagrees "
                             "with its CPU path")
    return {"launches": total, "trk_card_vs_cpu": err}


def mesh_complex_bank(dev, pipe) -> tuple[dict, float]:
    """``xlat_complex``'s general path at the time-sharded step's shape at
    world size 1: 128 sources × 64 slots, K = 1440 taps, D = 96, the
    100 ms block and the c_ctx·D halo samples before it (2503 outputs),
    float32 wire. Its ms beside the plain version's, the f32 operations
    bound and one f32 ``bmm`` of the window matrix (no TF32, no
    rotation) as the library yardstick; held to the plain version within
    COMPLEX_REL_TOL. Returns (numbers, max |err|)."""
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    bank = pipe.bank
    d, k, s = bank.decim, bank.ntaps, BENCH_SOURCES
    t = BLOCK + len(pipe.sym_taps) * d
    n = t // d
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((s, t, 2), generator=gen, device=dev)
    hist = torch.view_as_complex(torch.randn((s, k - 1, 2), generator=gen,
                                             device=dev))
    offs = grid_offsets(s, dev)
    grev = bank.modulated_taps(offs).contiguous()
    phase0 = torch.randint(0, 2 ** 32, (s, SLOTS), generator=gen,
                           device=dev, dtype=torch.int64)
    step = phase_step_u32(offs, d)

    def kern():
        return ck.bank_complex(x, hist, grev, phase0, step, d)

    res = {"ms": cuda_ms(kern, 3)}
    z = ck.complex_z(x, hist)
    ck.bank_complex_plain(z, grev, phase0, step, n, d)  # allocator warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ck.bank_complex_plain(z, grev, phase0, step, n, d)
    torch.cuda.synchronize()
    res["plain_ms"] = (time.perf_counter() - t0) * 1e3
    got = kern()
    err = check_complex_bank(got, want, f"general path S={s} T={t} K={k} "
                             f"D={d} C={SLOTS}")
    del want
    flops = 8.0 * s * SLOTS * n * k
    res["bound_ms"], res["bound_by"] = bound(
        flops, F32_PEAK, tensor_bytes(x, hist, grev, phase0, step, got))
    zr = torch.view_as_real(z).reshape(s, -1)
    win = zr.as_strided((s, n, 2 * k), (zr.stride(0), 2 * d, 1)).contiguous()
    gt = grev.transpose(1, 2)
    g2 = torch.stack([torch.cat([gt.real, gt.imag], -1),
                      torch.cat([-gt.imag, gt.real], -1)],
                     dim=2).reshape(s, 2 * k, 2 * SLOTS)
    res["library_ms"] = cuda_ms(lambda: torch.bmm(win, g2), 3)
    del win, z, zr
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    log(f"mesh complex bank: general path S={s} N={n} K={k} D={d} "
        f"C={SLOTS}: {res['ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']}, {flops:.4g} FLOP), share "
        f"{res['share_of_bound']:.4f}; library (f32 bmm, no rotation) "
        f"{res['library_ms']:.3f} ms; plain {res['plain_ms']:.1f} ms")
    res["turns"] = general_turns("mesh", x, hist, grev, phase0, step, d)
    return res, err


def mesh_tile_bank(dev, pipe) -> dict:
    """The wire bank kernel on the tiles a slot split leaves, alone on
    the card: 128 sources × 240000 bf16 samples at 64, 32 and 4 slots.
    The kernel computes slots in groups of 64, so the 32- and 4-slot
    tiles cost about what 64 slots do: this is the padded columns'
    cost (ms by slot count)."""
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    s, bank = BENCH_SOURCES, pipe.bank
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    res = {}
    for c in (SLOTS, SLOTS // 2, 4):
        offs = grid_offsets(s, dev)[:, :c].contiguous()
        st = bank.init(s, dev)._replace(
            phase=torch.zeros((s, c), dtype=torch.int64, device=dev))
        z2, gk, step = bank.operands(st, x, offs)
        res[c] = cuda_ms(lambda: ck.bank_fused(
            z2, gk, st.phase, step, BLOCK // bank.decim, bank.p,
            bank.decim), 10)
    log("mesh tile bank: wire bank kernel at 128 sources x 240000 "
        "samples: " + ", ".join(f"{c} slots {ms:.4f} ms"
                                for c, ms in res.items())
        + f" (slot groups of {ck.SLOT_GROUP})")
    return res


def _bench_mesh_rank(dev) -> dict:
    """One rank of ``bench mesh:``: ``ShardedControlStep`` on
    ``make_mesh()`` and ``TimeShardedControlStep`` on ``make_mesh3()`` at
    128 sources × 64 slots × 240000-sample bf16 blocks (the same
    random-normal block every step, on the card from a seed), each on
    this rank's tile: step ms p50/p95 over MESH_BENCH_STEPS (host clock,
    the device synchronized after each), peak memory, then
    MESH_TIMED_STEPS with the communicator timing each collective; for
    the time-sharded step the complex bank alone on this rank's chunk
    and its bound."""
    import torch.distributed as dist

    from radiocapture_tpu_torch import entry
    from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
    from radiocapture_tpu_torch.ops import channelizer_kernel as ck
    from radiocapture_tpu_torch.ops.fir import phase_step_u32
    from radiocapture_tpu_torch.parallel import mesh as MESH
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE)
    s = BENCH_SOURCES
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((s, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(s, dev)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(dev)}
    for name, make, cls in (
            ("dp_tp", MESH.make_mesh, MESH.ShardedControlStep),
            ("time", MESH.make_mesh3, MESH.TimeShardedControlStep)):
        step = cls(pipe, make(), s)
        xl, ol = step.shard(x, offs)
        state = step.init(dev)
        for _ in range(MESH_WARM_STEPS):
            state, outs = step.step(state, xl, ol)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lat = []
        for _ in range(MESH_BENCH_STEPS):
            t0 = time.perf_counter()
            state, outs = step.step(state, xl, ol)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        lat.sort()
        step.comm.log.clear()
        step.comm.timed = True
        for _ in range(MESH_TIMED_STEPS):
            state, outs = step.step(state, xl, ol)
        torch.cuda.synchronize()
        ops: dict = {}
        for e in step.comm.collectives():
            o = ops.setdefault(e["op"], {"bytes": e["bytes"], "ms": []})
            o["ms"].append(e["ms"])
        r = {"mesh": list(step.layout.shape), "tile": list(xl.shape),
             "slots": ol.shape[1], "out": list(outs[0].shape),
             "p50_ms": lat[len(lat) // 2], "p95_ms": lat[int(len(lat) * 0.95)],
             "steps": len(lat), "peak_mem_bytes": peak,
             "collectives": ops,
             "staged_bytes_per_step": step.comm.staged_bytes()
             // MESH_TIMED_STEPS}
        if name == "dp_tp" and step.comm.log:
            raise AssertionError(f"dp x tp step ran collectives {step.comm.log}")
        if name == "time":
            r["formula_bytes"] = entry.check_time_log(
                step, xl.shape[0], BLOCK, MESH_TIMED_STEPS)
            bank, d = pipe.bank, pipe.decim
            t = xl.shape[1] + step.c_ctx * d
            xb = torch.randn((s, t, 2), generator=gen, device=dev)
            hist = torch.zeros((s, bank.ntaps - 1), dtype=torch.complex64,
                               device=dev)
            grev = bank.modulated_taps(ol).contiguous()
            stp = phase_step_u32(ol, d)
            y = ck.bank_complex(xb, hist, grev, state.phase, stp, d)
            r["bank_ms"] = cuda_ms(lambda: ck.bank_complex(
                xb, hist, grev, state.phase, stp, d), 3)
            r["bank_bound_ms"], r["bank_bound_by"] = bound(
                8.0 * s * ol.shape[1] * (t // d) * bank.ntaps, F32_PEAK,
                tensor_bytes(xb, hist, grev, state.phase, stp, y))
        out[name] = r
    return out


def phase_bench_mesh(dev, pipe) -> dict:
    """``bench mesh:``: the complex bank's general path at the C4FM shape
    (``mesh_complex_bank``), the wire bank at the tiles' slot counts
    (``mesh_tile_bank``), then ``_bench_mesh_rank`` at world size 1
    (NCCL) and 2 (gloo, both ranks sharing this card: dp×tp 1 × 2 gives
    each rank 32 slots, which the wire bank pads to its 64-slot group;
    time 1 × 1 × 2 gives each rank half the block). Returns the numbers
    and the general path's max |err|."""
    from radiocapture_tpu_torch.parallel import mesh as MESH
    bank, err = mesh_complex_bank(dev, pipe)
    torch.cuda.empty_cache()
    res = {"complex_bank": bank, "tile_bank_ms": mesh_tile_bank(dev, pipe),
           "worlds": {}}
    for n in MESH_WORLDS:
        ranks = MESH.spawn(n, _bench_mesh_rank)
        res["worlds"][n] = ranks
        for rk in ranks:
            for name in ("dp_tp", "time"):
                r = rk[name]
                coll = ", ".join(
                    f"{op} {c['bytes']} B {np.median(c['ms']):.3f} ms"
                    for op, c in r["collectives"].items()) or "none"
                extra = (f"; its complex bank {r['bank_ms']:.3f} ms, bound "
                         f"{r['bank_bound_ms']:.3f} ms ({r['bank_bound_by']})"
                         if name == "time" else "")
                log(f"bench mesh: world {n} ({rk['backend']}) rank "
                    f"{rk['rank']} {name} mesh {r['mesh']} tile {r['tile']} "
                    f"x {r['slots']} slots: step p50 {r['p50_ms']:.3f} / p95 "
                    f"{r['p95_ms']:.3f} ms over {r['steps']}; collectives "
                    f"per step {coll}; staged {r['staged_bytes_per_step']} B "
                    f"per step; peak {r['peak_mem_bytes'] / 2 ** 30:.2f} GiB"
                    f"{extra}")
    log("bench mesh: " + json.dumps(res))
    return {**res, "complex_bank_err": err}


def main() -> None:
    from radiocapture_tpu_torch import kernels
    from radiocapture_tpu_torch.device import require_cuda
    from radiocapture_tpu_torch.frontend.pipeline import (ControlPipeline,
                                                          SpectrumSplit2)

    dev = require_cuda()
    card = smi_line()
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.load()
    log(f"build: {len(kernels.sources())} sources -> "
        f"{kernels.library_path().name} in {time.perf_counter() - t0:.1f} s")

    pipe = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE)
    bank_err = phase_bank(dev, pipe)
    track_err = phase_tracker(dev, pipe)
    launches = phase_decode(dev, pipe)
    res, bench_bank_err, bench_track_err = phase_bench(dev, pipe)
    bank_err = max(bank_err, bench_bank_err)
    track_err = max(track_err, bench_track_err)
    res_block = phase_fsk4_block(dev, pipe)

    # the pfb and fft frontend modes: a P25 grant through each, the pfb
    # fine stage on pfb_fine, both at 128 sources
    launches_pfb, _ = phase_decode_pfb(dev)
    pfb_launches_match("decode pfb", launches_pfb)
    launches_fft = phase_decode(
        dev, ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE, frontend="fft"),
        "decode fft", ("fsk_track",))
    res_fine, fine_err = phase_pfb_fine(dev)
    pfb_rows = phase_pfb_rows(dev)
    pfb_bins = phase_pfb_bins(dev)
    res_fe = {fe: phase_frontend_bench(dev, fe) for fe in ("pfb", "fft")}
    # the live config's 10 MS/s source: the pfb step at M = 25
    res_fe["pfb10"] = phase_frontend_bench(dev, "pfb", LIVE_PFB_RATE)

    sp = SpectrumSplit2(SAMP_RATE)
    cbank_err = phase_complex_bank(dev, sp)
    cq_err = phase_cqpsk_tracker(dev)
    launches2 = phase_split2_decode(dev, sp)
    res2, bench_cbank_err, bench_cq_err, bench_bank_err = \
        phase_split2_bench(dev, sp)
    cbank_err = max(cbank_err, bench_cbank_err)
    cq_err = max(cq_err, bench_cq_err)
    bank_err = max(bank_err, bench_bank_err)
    ops = phase_operands_kernel(dev, pipe, sp)

    voice_err, res3 = phase_voice_kernel(dev)
    launches3 = phase_runtime_decode(dev)
    launches_rt_pfb = phase_runtime_decode(dev, "pfb")
    pfb_launches_match("runtime decode pfb", launches_rt_pfb)
    phase_runtime_bench(dev)
    rt_pfb = phase_runtime_bench(dev, "pfb")
    log("frontends: " + json.dumps({
        "xlat_step_ms": res["step_ms_median"],
        "pfb_step_ms": res_fe["pfb"]["step_ms_median"],
        "fft_step_ms": res_fe["fft"]["step_ms_median"],
        "fft_block_ms": res_fe["fft"]["block_ms"],
        "fsk4_block10_step_ms": res_block["step_ms_block10"],
        "fsk4_exact_step_ms": res_block["step_ms_block0"],
        "pfb_rows_ms": pfb_rows["bf16"]["ms"],
        "pfb_rows_f32_ms": pfb_rows["f32"]["ms"],
        "pfb_bins_ms": pfb_bins["bf16"]["ms"],
        "pfb_bins_f32_ms": pfb_bins["f32"]["ms"],
        "pfb_10msps_step_ms": res_fe["pfb10"]["step_ms_median"],
        "pfb_10msps_bins_share": res_fe["pfb10"]["pfb_bins_share"],
        "runtime_pfb_p50_ms": rt_pfb["step_p50_ms"],
        "runtime_pfb_p95_ms": rt_pfb["step_p95_ms"],
        "launches": {"decode_pfb": launches_pfb, "decode_fft": launches_fft,
                     "runtime_pfb": launches_rt_pfb}}))
    # the scan slice: spectrum scan, discovery, the conventional scanner
    # and the offline tools, on the kernels above
    scan = phase_decode_scan(dev)
    scanner = phase_decode_scanner(dev)
    f2w = phase_decode_file_to_wav(dev)
    bench_scan = phase_bench_scan(dev)
    log("tools: " + json.dumps({
        **{k: v for k, v in bench_scan.items() if k != "launches"},
        "spectrum_max_abs_err": scan["spectrum_max_abs_err"],
        "wav_max_abs_err": f2w["wav_max_abs_err"],
        "decode_p25_pcm": f2w["p25_pcm"],
        "launches": {"decode_scan": scan["launches"],
                     "decode_scanner": scanner["launches"],
                     "decode_file_to_wav": f2w["launches"],
                     "bench_scan": bench_scan["launches"]}}))
    # live SDR ingest through SiteRuntime, the soak and the longevity
    # check (L7)
    live_rtl = phase_live_rtl_tcp(dev)
    live_split2 = phase_live_split2(dev)
    live_gap = phase_live_dropout(dev)
    bench_live = phase_live_bench(dev)
    soak = phase_soak()
    longev = phase_longevity(dev)

    def facts(r):
        return {k: r[k] for k in ("blocks", "pop_ms", "zero_filled",
                                  "dropped", "uploads", "launches")}
    log("live: " + json.dumps({
        "decode_rtl_tcp": facts(live_rtl),
        "decode_rciq_split2": facts(live_split2),
        "dropout": {**facts(live_gap),
                    "zero_fill_waits_ms": [f[2] * 1e3
                                           for f in live_gap["fills"]]},
        "bench": bench_live,
        "soak": soak, "longevity": longev}))
    # the mesh slice: the stream tracker, the grant through both mesh
    # steps at world size 1 (NCCL) and 2 (gloo on this card), the bench
    stream, stream_err = phase_mesh_stream_tracker(dev, pipe)
    mesh = phase_mesh_decode(dev)
    bench_mesh = phase_bench_mesh(dev, pipe)
    mbank = bench_mesh["complex_bank"]
    loaded = [m for m in ("jax", "radiocapture_tpu") if m in sys.modules]
    if loaded:
        raise AssertionError(f"imported {loaded}")

    log(json.dumps({"kernels": [
        {"name": "bank_operands", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/bank_operands.cu",
         "replaces": "radiocapture_tpu/ops/channelizer.py:200",
         "replaces_what": "XLA fusion of XlatBank.call_wire's operand "
                          "build (:200-224), not a Pallas kernel",
         "launches": launches["bank_operands"],
         "max_abs_err": max(o["max_abs_err"] for o in ops.values()),
         **{k: ops["c4fm"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
         "library_ms": None,
         **{f"{shape}_{k}": v for shape, o in ops.items()
            for k, v in o.items()},
         "cqpsk_launches": launches2["bank_operands"]},
        {"name": "agc", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/agc.cu",
         "replaces": "radiocapture_tpu/demod/cqpsk.py:261",
         "replaces_what": "XLA fusion of block_agc, not a Pallas kernel",
         "launches": launches2["agc"], "max_abs_err": res2["agc_max_abs_err"],
         "max_rel_err": res2["agc_max_rel_err"], "ms": res2["agc_ms"],
         "plain_ms": res2["agc_plain_ms"], "bound_ms": res2["agc_bound_ms"],
         "bound_by": res2["agc_bound_by"],
         "library_ms": res2["agc_library_ms"]},
        {"name": "pfb_rows", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/pfb_rows.cu",
         "replaces": "radiocapture_tpu/ops/channelizer.py:276",
         "replaces_what": "XLA fusion of PfbChannelizer.__call__'s "
                          "combiner (:276-290), not a Pallas kernel",
         "launches": launches_pfb["pfb_rows"],
         "on_main_path": False,
         "off_path_why": "the pfb step's bins run pfb_bins; pfb_rows is "
                         "PfbChannelizer.rows, the time-major entry point",
         "standalone_launches":
             res_fine["pfb_bins"]["rows_launches"]["pfb_rows"],
         "max_abs_err": pfb_rows["max_abs_err"],
         **{k: pfb_rows["bf16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
         **{f"{shape}_{k}": v for shape, r in pfb_rows.items()
            if isinstance(r, dict) for k, v in r.items()},
         "runtime_launches": launches_rt_pfb["pfb_rows"]},
        {"name": "pfb_bins", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/pfb_rows.cu",
         "replaces": "radiocapture_tpu/ops/channelizer.py:276",
         "replaces_what": "XLA fusion of PfbChannelizer.__call__ "
                          "(:276-295: the combiner, the IDFT, the "
                          "rotation), not a Pallas kernel",
         "launches": launches_pfb["pfb_bins"],
         "max_abs_err": pfb_bins["max_abs_err"],
         "max_rel_err": pfb_bins["max_rel_err"],
         **{k: pfb_bins["bf16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
         **{f"{shape}_{k}": v for shape, r in pfb_bins.items()
            if isinstance(r, dict) for k, v in r.items()},
         "runtime_launches": launches_rt_pfb["pfb_bins"]},
        {"name": "xlat_bank", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/xlat_bank.cu",
         "replaces": "radiocapture_tpu/ops/pallas_channelizer.py:201",
         "launches": launches["xlat_bank"], "max_abs_err": bank_err,
         "ms": res["bank_ms"], "plain_ms": res["bank_plain_ms"],
         "bound_ms": res["bank_bound_ms"], "bound_by": res["bank_bound_by"],
         "library_ms": res["bank_library_ms"]},
        {"name": "fsk_track", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/fsk_track.cu",
         "replaces": "radiocapture_tpu/demod/fsk4.py:105",
         "launches": launches["fsk_track"], "max_abs_err": track_err,
         "ms": res["track_ms"], "plain_ms": res["track_plain_ms"],
         "bound_ms": res["track_bound_ms"],
         "bound_by": res["track_bound_by"], "library_ms": None,
         "floor_ms": res["track_floor_ms"],
         "floor_how": res["track_floor_how"]},
        {"name": "pfb_fine", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/pfb_fine.cu",
         "replaces": "radiocapture_tpu/ops/channelizer.py:351",
         "replaces_what": "PfbXlatBank.__call__'s fine stage, "
                          "vmap(freq_xlating_fir) under jit (:351-366), "
                          "not a Pallas kernel",
         "launches": launches_pfb["pfb_fine"],
         "runtime_launches": launches_rt_pfb["pfb_fine"],
         "max_rel_err": fine_err, "rb": res_fine["rb"],
         "ms": res_fine["pfb_fine_ms"],
         "ms_rb1": res_fine["pfb_fine_ms_rb1"],
         "plain_ms_64_rows": res_fine["pfb_fine_plain_ms_rows"],
         "bound_ms": res_fine["pfb_fine_bound_ms"],
         "bound_by": res_fine["pfb_fine_bound_by"],
         "library_ms": res_fine["pfb_fine_library_ms"],
         "identical_history": res_fine["identical_history"],
         "history": res_fine["history"],
         "pfb_bins": res_fine["pfb_bins"]},
        {"name": "xlat_complex", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/xlat_complex.cu",
         "replaces": "radiocapture_tpu/ops/pallas_channelizer.py:73",
         "launches": launches2["xlat_complex"], "max_abs_err": cbank_err,
         "ms": res2["xlat_complex_ms"],
         "plain_ms": res2["xlat_complex_plain_ms"],
         "bound_ms": res2["xlat_complex_bound_ms"],
         "bound_by": res2["xlat_complex_bound_by"],
         "library_ms": res2["xlat_complex_library_ms"],
         "pfb_fine_launches": launches_pfb["xlat_complex"],
         "mesh_c4fm_launches": mesh["launches"]["xlat_complex"],
         "mesh_c4fm_max_abs_err": bench_mesh["complex_bank_err"],
         "mesh_c4fm_ms": mbank["ms"], "mesh_c4fm_plain_ms": mbank["plain_ms"],
         "mesh_c4fm_bound_ms": mbank["bound_ms"],
         "mesh_c4fm_bound_by": mbank["bound_by"],
         "mesh_c4fm_library_ms": mbank["library_ms"],
         "mesh_c4fm_turns": mbank["turns"]},
        {"name": "cqpsk_track", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/cqpsk_track.cu",
         "replaces": "radiocapture_tpu/demod/cqpsk.py:133",
         "launches": launches2["cqpsk_track"], "max_abs_err": cq_err,
         "ms": res2["cqpsk_track_ms"],
         "plain_ms": res2["cqpsk_track_plain_ms"],
         "bound_ms": res2["cqpsk_track_bound_ms"],
         "bound_by": res2["cqpsk_track_bound_by"], "library_ms": None,
         "floor_ms": res2["cqpsk_track_floor_ms"],
         "floor_how": res2["cqpsk_track_floor_how"]},
        {"name": "fm_voice", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/fm_voice.cu",
         "replaces": "radiocapture_tpu/ops/fm.py:44",
         "launches": launches3["fm_voice"], "max_abs_err": voice_err,
         "ms": res3["fm_voice_ms"], "plain_ms": res3["fm_voice_plain_ms"],
         "bound_ms": res3["fm_voice_bound_ms"],
         "bound_by": res3["fm_voice_bound_by"], "library_ms": None,
         "traffic_ms": res3["fm_voice_traffic_ms"]},
        {"name": "fsk_track_stream", "route": "cuda",
         "source": "radiocapture_tpu_torch/csrc/fsk_track.cu",
         "replaces": "radiocapture_tpu/demod/fsk4.py:105",
         "launches": mesh["launches"]["fsk_track_stream"],
         "max_abs_err": stream_err, "ms": stream["stream_ms"],
         "plain_ms": stream["stream_plain_ms"],
         "bound_ms": stream["stream_bound_ms"],
         "bound_by": stream["stream_bound_by"], "library_ms": None,
         "floor_ms": stream["stream_floor_ms"],
         "floor_how": stream["stream_floor_how"]},
    ]}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
