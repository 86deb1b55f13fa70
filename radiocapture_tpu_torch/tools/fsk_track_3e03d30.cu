// Fused per-lane tracker for Hopper (sm_90a): quadrature discriminator
// -> streaming boxcar (stride sym_decim) -> fsk4 symbol tracking ->
// slicer, for every (source, slot) lane of the bank output.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (ControlPipeline._step_impl,
// pipeline.py:198-212): ops/fm.py::quadrature_demod,
// frontend/pipeline.py::_batched_fir, the demod/fsk4.py::fsk4_demod
// lax.scan (body fsk4.py:152-182) and slice_dibits_jax (fsk4.py:319).
//
// Bound: latency. The fsk4 loop is a serial feedback chain per lane
// (clock -> IEEE division -> Farrow Horner -> 8-term sums -> IEEE
// division -> rint -> tanh -> clock/fine-frequency update), ~1250 tracked
// samples per 100 ms block at the C4FM bench shape. Everything before it
// (loads, atan2 discriminator, boxcar) depends only on the input and the
// carried prev sample / boxcar window, so it is parallel over samples.
// The design takes that part off the chain:
//
// - A block owns a tile of TILE neighbouring slots of one source, so each
//   time step of the tile is one 128-byte row of each time-major [S, N, C]
//   plane; the grid is S x ceil(C / TILE) blocks (256 at the bench shape,
//   about two per SM), lanes past C masked.
// - Warp 0, the consumer, runs only the fsk4 loop, one lane per thread,
//   its state (clock, fine frequency, 8-sample history) in registers. It
//   reads each boxcar output xn from a shared-memory ring and stores
//   symbol, emit flag and dibit straight to the time-major outputs
//   (coalesced, off the chain).
// - PRODUCERS warps fill the ring. Each takes SEG input samples of the
//   tile at a time: it issues all the loads of its segment at once (the
//   SEG samples, the NT-1 before them for the boxcar window and one more
//   for the discriminator), then computes the atan2 discriminator and the
//   boxcar at stride sym_decim, and writes xn into its part of a STAGES-
//   deep ring of stages (STAGE_IN input samples each). Full/empty
//   mbarriers hand stages between producers and the consumer. atan2f
//   branches, so one warp runs its calls one after another on their own
//   latency: eight producer warps of 16-sample segments keep the ring
//   ahead of the consumer (H100: 2 warps of 32 samples left it waiting).
// - Carried state: the producer of the first segment takes prev and the
//   boxcar history from the lane state; the owner of each of the last
//   NT-1 discriminator values puts it in shared memory, and the consumer
//   writes the new history, prev (the last input sample), clock, fine
//   frequency and the 8-sample history back when the block is done.
//
// Arithmetic is the JAX scan's, step for step, and every per-lane
// operation and its order is that of the one-thread-per-lane kernel this
// design replaced: clip/round/where as fminf/fmaxf/rintf (half-to-even
// like jnp.round)/branch, IEEE divisions, the two 8-tap sums in index
// order. The one exception is the discriminator's complex multiply,
// whose fused product is pinned to PyTorch's (see discriminator). Built
// without fast math: the loop feeds its own rounding back, so
// atan2f/tanhf/division must stay IEEE-accurate.
//
// fsk_chain_probe runs the consumer's loop alone in one warp over boxcar
// outputs already in shared memory and counts its cycles with clock64():
// the latency floor of the chain, which no layout of the feed-forward
// part can beat.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HIST = 8;
constexpr int DEG1 = 5;            // degree-4 Farrow: 5 coefficient rows
constexpr int MAX_TAPS = 8;
constexpr int TILE = 32;           // lanes per block: one warp wide
constexpr int PRODUCERS = 8;       // producer warps per block
constexpr int SEG = 16;            // input samples per producer segment
constexpr int STAGE_IN = SEG * PRODUCERS;   // input samples per ring stage
constexpr int STAGES = 2;
constexpr int THREADS = TILE * (1 + PRODUCERS);
constexpr int PROBE_ROWS = 64;    // xn rows the chain probe replays

struct TrackConsts {
  float farrow[DEG1 * 2 * HIST];   // [5, 16] highest power first
  float taps[MAX_TAPS];            // boxcar taps (first NT used)
};

struct LoopConsts {
  float step, lo, spacing, top, k_ff, k_t;
  int nlevels;
};

struct __align__(16) TrackSmem {
  float ring[STAGES][STAGE_IN][TILE];   // xn, row = tracked index in stage
  float tail[MAX_TAPS - 1][TILE];       // the new boxcar history
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Release-arrive: this thread's shared-memory writes before it are
// visible to a thread whose wait sees the phase complete.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity (parity
// 1 before the first completion passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// gain * arg(x * conj(prev)): the complex multiply with b = conj(prev),
// (a*c - b*d, a*d + b*c), each part one fused multiply-add over the
// other product rounded, as PyTorch's complex multiply on CUDA rounds it,
// so the carried boxcar history equals the plain version's bit for bit.
__device__ __forceinline__ float discriminator(float are, float aim,
                                               float pr, float pi,
                                               float gain) {
  const float dre = __fmaf_rn(are, pr, -__fmul_rn(aim, -pi));
  const float dim = __fmaf_rn(are, -pi, __fmul_rn(aim, pr));
  return gain * atan2f(dim, dre);
}

// One fsk4 step (fsk4.py:152-182) on boxcar output xn; returns the
// interpolated symbol y and whether the clock emitted.
__device__ __forceinline__ float fsk4_step(float xn, float& clock, float& ff,
                                           float (&h)[HIST],
                                           const TrackConsts& kc,
                                           const LoopConsts& lc, bool& emit) {
#pragma unroll
  for (int j = 0; j < HIST - 1; ++j) h[j] = h[j + 1];
  h[HIST - 1] = xn - ff;
  clock = clock + lc.step;
  emit = clock >= 1.0f;
  float clockw = emit ? clock - 1.0f : clock;
  const float frac = fminf(fmaxf(clockw / lc.step, 0.0f), 0.999f);
  float y = 0.0f, dy = 0.0f;
#pragma unroll
  for (int j = 0; j < HIST; ++j) {
    float tv = kc.farrow[j];
    float td = kc.farrow[HIST + j];
#pragma unroll
    for (int d = 1; d < DEG1; ++d) {
      tv = tv * frac + kc.farrow[d * 2 * HIST + j];
      td = td * frac + kc.farrow[d * 2 * HIST + HIST + j];
    }
    y = y + h[j] * tv;
    dy = dy + h[j] * td;
  }
  const float idx =
      fminf(fmaxf(rintf((y - lc.lo) / lc.spacing), 0.0f), lc.top);
  const float err = y - (lc.lo + lc.spacing * idx);
  if (emit) {
    ff = ff + lc.k_ff * err;
    clockw = clockw - lc.k_t * tanhf(err * dy);
  }
  clock = clockw;
  return y;
}

__device__ __forceinline__ int slice(float y, int nlevels) {
  return (nlevels == 4)
             ? (y > 2.0f ? 1 : (y > 0.0f ? 0 : (y > -2.0f ? 2 : 3)))
             : (y > 0.0f ? 1 : 0);
}

// The consumer's loop over cnt ring rows (column col, row stride TILE):
// outputs go to out + t * out_stride for t < cnt.
__device__ __forceinline__ void track_rows(
    const float* col, int cnt, float& clock, float& ff, float (&h)[HIST],
    const TrackConsts& kc, const LoopConsts& lc, bool active,
    float* __restrict__ syms, int* __restrict__ valid,
    int* __restrict__ dibits, long long out, long long out_stride) {
#pragma unroll 8
  for (int t = 0; t < cnt; ++t) {
    bool emit;
    const float y = fsk4_step(col[t * TILE], clock, ff, h, kc, lc, emit);
    if (active) {
      const long long o = out + (long long)t * out_stride;
      syms[o] = y;
      valid[o] = emit ? 1 : 0;
      dibits[o] = slice(y, lc.nlevels);
    }
  }
}

// Producer: discriminator and boxcar over input samples [base, base+SEG)
// of one lane; xn of each tracked sample goes to ring row (off + k) /
// sym_decim, k the offset in the segment (sym_decim = 1 << sd_shift, a
// divisor of SEG); the last NT-1 discriminator values of the block go to
// tail.
template <int NT>
__device__ __forceinline__ void produce_segment(
    const float* __restrict__ xr, const float* __restrict__ xi, int base,
    int off, int N, long long C, bool active, float pr0, float pi0,
    const float (&sh)[NT > 1 ? NT - 1 : 1], float gain, int sd_shift,
    const TrackConsts& kc, float (*rows)[TILE], float (*tail)[TILE],
    int lane) {
  // x[base-NT .. base+SEG-1]; x[-1] is the carried prev sample
  float ar[SEG + NT], ai[SEG + NT];
#pragma unroll
  for (int j = 0; j < SEG + NT; ++j) {
    const int k = base - NT + j;
    const bool ok = active && k >= 0 && k < N;
    ar[j] = ok ? xr[(long long)k * C] : 0.0f;
    ai[j] = ok ? xi[(long long)k * C] : 0.0f;
  }
  if (base == 0) {
    ar[NT - 1] = pr0;
    ai[NT - 1] = pi0;
  }
  float w[NT];                       // boxcar window, oldest first
#pragma unroll
  for (int j = 0; j < NT; ++j) w[j] = 0.0f;
#pragma unroll
  for (int j = 1; j < SEG + NT; ++j) {
    const int k = base - NT + j;     // discriminator index
    float d = discriminator(ar[j], ai[j], ar[j - 1], ai[j - 1], gain);
    if (j < NT && base == 0) d = sh[j - 1];   // k < 0: carried history
#pragma unroll
    for (int i = 0; i < NT - 1; ++i) w[i] = w[i + 1];
    w[NT - 1] = d;
    // the block's last NT-1 values, written by the segment owning them
    if ((j >= NT || base == 0) && k >= N - (NT - 1) && k < N)
      tail[k - (N - (NT - 1))][lane] = d;
    if (j >= NT) {
      const int kk = j - NT;         // offset in the segment
      if ((kk & ((1 << sd_shift) - 1)) == 0 && k < N) {
        // boxcar output: sum_j taps[NT-1-j] * window[j], in j order
        float xn = kc.taps[NT - 1] * w[0];
#pragma unroll
        for (int i = 1; i < NT; ++i) xn = xn + kc.taps[NT - 1 - i] * w[i];
        rows[(off + kk) >> sd_shift][lane] = xn;
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
fsk_track_kernel(const float* __restrict__ y_re,
                 const float* __restrict__ y_im, float* __restrict__ prev,
                 float* __restrict__ sym_hist, float* __restrict__ clock_io,
                 float* __restrict__ ff_io, float* __restrict__ hist_io,
                 float* __restrict__ syms, int* __restrict__ valid,
                 int* __restrict__ dibits, const TrackConsts kc,
                 const LoopConsts lc, int N, int C, int tiles, int sym_decim,
                 float gain) {
  __shared__ TrackSmem sm;
  const int warp = threadIdx.x / TILE;
  const int lane = threadIdx.x % TILE;
  const int s = blockIdx.x / tiles;
  const int c = (blockIdx.x % tiles) * TILE + lane;
  const bool active = c < C;
  const long long li = (long long)s * C + c;       // lane index
  const long long in0 = (long long)s * N * C + c;
  const int n_stages = (N + STAGE_IN - 1) / STAGE_IN;
  const int sd_shift = __ffs(sym_decim) - 1;
  const int rows_per_stage = STAGE_IN >> sd_shift;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.full[st], PRODUCERS * TILE);
      mbar_init(&sm.empty[st], TILE);
    }
  }
  __syncthreads();

  if (warp > 0) {                    // producers
    const int p = warp - 1;
    float pr0 = 0.0f, pi0 = 0.0f;
    float sh[NT > 1 ? NT - 1 : 1];
    sh[0] = 0.0f;
    if (active) {
      pr0 = prev[2 * li];
      pi0 = prev[2 * li + 1];
#pragma unroll
      for (int j = 0; j < NT - 1; ++j) sh[j] = sym_hist[li * (NT - 1) + j];
    }
    for (int q = 0; q < n_stages; ++q) {
      const int st = q % STAGES;
      mbar_wait(&sm.empty[st], ((q / STAGES) & 1) ^ 1);
      const int base = q * STAGE_IN + p * SEG;
      if (base < N)
        produce_segment<NT>(y_re + in0, y_im + in0, base, p * SEG, N, C,
                            active, pr0, pi0, sh, gain, sd_shift, kc,
                            sm.ring[st], sm.tail, lane);
      mbar_arrive(&sm.full[st]);
    }
    return;
  }

  // consumer
  float clock = 0.0f, ff = 0.0f, h[HIST];
#pragma unroll
  for (int j = 0; j < HIST; ++j) h[j] = 0.0f;
  if (active) {
    clock = clock_io[li];
    ff = ff_io[li];
#pragma unroll
    for (int j = 0; j < HIST; ++j) h[j] = hist_io[li * HIST + j];
  }
  const int M = N / sym_decim;
  const long long out0 = (long long)s * M * C + c;
  for (int q = 0; q < n_stages; ++q) {
    const int st = q % STAGES;
    mbar_wait(&sm.full[st], (q / STAGES) & 1);
    const int m0 = q * rows_per_stage;
    const int cnt = min(rows_per_stage, M - m0);
    track_rows(&sm.ring[st][0][lane], cnt, clock, ff, h, kc, lc, active,
               syms, valid, dibits, out0 + (long long)m0 * C, C);
    __syncwarp();
    mbar_arrive(&sm.empty[st]);
  }
  if (active) {
    const long long last = in0 + (long long)(N - 1) * C;
    prev[2 * li] = y_re[last];
    prev[2 * li + 1] = y_im[last];
#pragma unroll
    for (int j = 0; j < NT - 1; ++j)
      sym_hist[li * (NT - 1) + j] = sm.tail[j][lane];
    clock_io[li] = clock;
    ff_io[li] = ff;
#pragma unroll
    for (int j = 0; j < HIST; ++j) hist_io[li * HIST + j] = h[j];
  }
}

// The consumer's loop alone, one warp, from a zero state: PROBE_ROWS rows
// of boxcar outputs xn [PROBE_ROWS, TILE] staged in shared memory are
// replayed for `steps` tracked samples (outputs [steps, TILE]); cycles[0]
// gets the clock64() count of the loop.
__global__ void __launch_bounds__(TILE)
fsk_chain_probe(const float* __restrict__ xn, int steps,
                float* __restrict__ syms, int* __restrict__ valid,
                int* __restrict__ dibits, float* __restrict__ state_out,
                long long* __restrict__ cycles, const TrackConsts kc,
                const LoopConsts lc) {
  __shared__ float rows[PROBE_ROWS][TILE];
  const int lane = threadIdx.x;
  for (int r = 0; r < PROBE_ROWS; ++r) rows[r][lane] = xn[r * TILE + lane];
  __syncwarp();
  float clock = 0.0f, ff = 0.0f, h[HIST];
#pragma unroll
  for (int j = 0; j < HIST; ++j) h[j] = 0.0f;
  const long long t0 = clock64();
  for (int m = 0; m < steps; m += PROBE_ROWS)
    track_rows(&rows[0][lane], min(PROBE_ROWS, steps - m), clock, ff, h, kc,
               lc, true, syms, valid, dibits, (long long)m * TILE + lane,
               TILE);
  const long long t1 = clock64();
  state_out[lane] = clock;
  state_out[TILE + lane] = ff;
  if (lane == 0) cycles[0] = t1 - t0;
}

TrackConsts read_consts(const void* host_consts) {
  TrackConsts kc;
  const float* hc = (const float*)host_consts;
  for (int j = 0; j < DEG1 * 2 * HIST; ++j) kc.farrow[j] = hc[j];
  for (int j = 0; j < MAX_TAPS; ++j) kc.taps[j] = hc[DEG1 * 2 * HIST + j];
  return kc;
}

LoopConsts loop_consts(float step, float lo, float spacing, int nlevels,
                       float k_ff, float k_t) {
  return LoopConsts{step, lo, spacing, (float)(nlevels - 1), k_ff, k_t,
                    nlevels};
}

}  // namespace

extern "C" int fsk_track_launch(
    const void* y_re, const void* y_im, void* prev, void* sym_hist,
    void* clock, void* ff, void* hist, void* syms, void* valid,
    void* dibits, const void* host_consts, int S, int N, int C, int ntaps,
    int sym_decim, float gain, float step, float lo, float spacing,
    int nlevels, float k_ff, float k_t, void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || sym_decim < 1 || SEG % sym_decim ||
      N % sym_decim)
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || C <= 0 || N <= 0) return (int)cudaSuccess;
  const TrackConsts kc = read_consts(host_consts);
  const LoopConsts lc = loop_consts(step, lo, spacing, nlevels, k_ff, k_t);
  const int tiles = (C + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)S * (unsigned)tiles;
  cudaStream_t st = (cudaStream_t)stream;
#define RC_TRACK_CASE(NT)                                                   \
  case NT:                                                                  \
    fsk_track_kernel<NT><<<blocks, THREADS, 0, st>>>(                       \
        (const float*)y_re, (const float*)y_im, (float*)prev,               \
        (float*)sym_hist, (float*)clock, (float*)ff, (float*)hist,          \
        (float*)syms, (int*)valid, (int*)dibits, kc, lc, N, C, tiles,       \
        sym_decim, gain);                                                   \
    break;
  switch (ntaps) {
    RC_TRACK_CASE(1)
    RC_TRACK_CASE(2)
    RC_TRACK_CASE(3)
    RC_TRACK_CASE(4)
    RC_TRACK_CASE(5)
    RC_TRACK_CASE(6)
    RC_TRACK_CASE(7)
    RC_TRACK_CASE(8)
  }
#undef RC_TRACK_CASE
  return (int)cudaGetLastError();
}

extern "C" int fsk_chain_probe_launch(
    const void* xn, int steps, void* syms, void* valid, void* dibits,
    void* state_out, void* cycles, const void* host_consts, float step,
    float lo, float spacing, int nlevels, float k_ff, float k_t,
    void* stream) {
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  fsk_chain_probe<<<1, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)xn, steps, (float*)syms, (int*)valid, (int*)dibits,
      (float*)state_out, (long long*)cycles, read_consts(host_consts),
      loop_consts(step, lo, spacing, nlevels, k_ff, k_t));
  return (int)cudaGetLastError();
}
