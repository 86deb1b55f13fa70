// Per-lane CQPSK (P25 LSM) tracker for Hopper (sm_90a): feedforward AGC
// gain -> carrier NCO -> Farrow interpolation -> Gardner timing -> diff
// phase atan2/(pi/4) -> x4 power-law AFC -> slicer, for every (source,
// slot) lane, the feedback loop in one consumer warp per 32-lane tile and
// everything off the loop in producer warps beside it.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (CqpskControlPipeline._step_impl,
// pipeline.py:340-350): the demod/cqpsk.py::cqpsk_demod lax.scan (body
// cqpsk.py:176-237) and slice_dibits_jax. The AGC gain 1/max(rms, 1e-9)
// (cqpsk.py::block_agc) comes in per lane, computed once in torch, and
// multiplies each sample as it is read, so no scaled copy of the planes
// exists.
//
// Bound: latency. Each lane is a serial feedback chain, and 16384 lanes
// are 512 tiles of 32: one consumer warp per scheduler of the 132 SMs, so
// nothing hides a consumer's stalls, and whatever else runs in its warp
// lengthens the chain's time. The 32 lanes of a tile are independent
// channels whose symbol instants do not line up: at 25 kS/s and 4800 Bd a
// lane emits on one sample in 5.21, so a loop over samples would have
// some lane of the warp emit on ~99.9% of them. The consumer is therefore
// symbol-major. Each pass of its outer loop is one symbol for every lane:
// the inner loop takes the lane's own samples up to and including its
// next emit (5-6 at 4800 Bd, 4-5 at 6000), each with the AGC gain, the
// NCO's sine and cosine, the rotation, the history shift and t + 1, and
// writes the rotated sample to the tile's ring in shared memory; the next
// sample's NCO (its phase through floor_mod, then sincosf) reads only the
// phase and freq, which hold until an emit, so it is computed after the
// sample (tools/cqpsk_variants.py nco_inline times it at the head). The
// emit sample leaves the inner loop, and after one __syncwarp the warp
// runs the emit step for all its emitting lanes at once: Farrow at the
// emit's fraction, the mid-symbol window at p_half = frac + 4 + omega/2
// with the old omega, Gardner, the omega and t updates, atan2f, err4, the
// AFC and prev; the consumer writes the symbol's value y (the new prev)
// beside its rotated sample. A lane that reaches N mid-symbol stops with
// the state the per-sample loop leaves (t, phase and history moved,
// nothing else), and the warp runs until every lane has taken N samples.
// The mid-symbol window (n0 among cqpsk_params' candidates, at most
// MAX_CAND) is one Horner evaluation and 8 samples picked from the
// candidates' windows by predicated selects, not a divergent switch: the
// kernel is instantiated per first candidate n0, so history indices stay
// compile-time constants and the 48-float history stays in registers.
//
// Producer warps of the tile do the rest, lane for lane with its
// consumer. The tile's ring holds RING rows of 32 lanes in STAGES stages:
// each row the planes' two samples (then the rotated sample, written over
// them, then z) and the emit's y (kNoEmit where the lane emitted
// nothing): 16 bytes a lane, so four tiles' rings of 96 rows fill an SM's
// shared memory. Lane c reads and writes only column c of a row, which
// is bank c whatever the row: no bank conflicts. Three mbarriers a stage
// hand it on. SYMBOL_WARPS symbol warps fill a stage by cp.async, GROUP
// rows in turn each (their y reset), and the copies arrive on the
// stage's `full` barrier as they land; the consumer waits there for the
// stage its slowest lane is in, tests the ones after it, and a lane
// stops, mid-symbol if need be, at the rows that have not landed (which
// leaves its state as the per-sample loop would). Once its slowest lane
// has passed a stage the consumer arrives on its `handed` barrier. The
// interpolation warp then takes the stage's rows in order: where a row
// emits nothing, the value interpolation over the 8 rotated samples
// before it (a window it carries in registers, from the lane's history
// at the start) with the taps held for the launch, where it emits the
// consumer's y; and z = y conj(prev) with the prev in force at that row
// (the carried prev, then each emit's y), written over the row's sample;
// then it arrives on `interpolated`. The symbol warps take their rows'
// z: atan2f and the division by pi/4 of GROUP rows side by side, and the
// symbol, valid flag and dibit stored one coalesced row at a time; then
// they refill their rows' slots with the rows STAGES stages ahead.
// atan2f and the IEEE division branch, so a warp runs them one row after
// another on their latency: one producer warp doing all of this took as
// long as the consumer alone (tools/cqpsk_variants.py prices the parts).
// The consumer runs nothing of it: per sample its warp reads two floats
// from shared memory and writes two, per symbol two more, and per pass
// the barrier checks.
//
// Grid: blocks of up to MAX_TILES tiles, the consumer warps first (warp w
// of a block is issued by scheduler w % 4, so one block of four tiles
// puts its four consumers on four schedulers), then the interpolation
// warps, then the symbol warps; as many tiles a block as spread them over
// the SMs, so 512 tiles are 128 blocks of 4.
//
// What bounds it now: the consumer's own chain, the per-sample NCO
// (floor_mod, sincosf), rotation and 46-register history shift with the
// emit step once a symbol, which cqpsk_chain_probe below runs alone at
// 535 cycles a sample; beside it the consumer's reads, writes and barrier
// checks (the consumer with idle producers runs 1.23x the probe), and
// the producer warps' instructions, which take issue slots from the
// consumer on its scheduler (the whole kernel runs 1.14x the consumer
// alone).
//
// Arithmetic follows the JAX scan step for step, and the outputs and
// carried state are bit-identical to the per-sample-loop kernel this
// replaces: every multiply and add is an explicitly rounded
// __fmul_rn/__fadd_rn/__fsub_rn (no FMA contraction), clips are
// fminf/fmaxf, jnp.mod is fmod (exact; fmod_pos) plus the sign fix,
// arg*pi - pi + pi is evaluated as written, the held taps are the same
// Horner steps on the same values, the emit's fraction is (frac + 4) - 4
// as the scan writes it, the interpolation warp's window sums are the
// consumer's on the same values, and the window's 8 products are summed
// in index order. Built without fast math: the loop feeds its own
// rounding back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HIST = 24;           // complex history span (cqpsk.HIST_C)
constexpr int NTAP = 8;            // interpolator taps
constexpr int DEG1 = 5;            // degree-4 Farrow: 5 coefficient rows
constexpr int N0_MIN = 3;          // window start HIST-5-n0 in [0, HIST-8]
constexpr int N0_MAX = HIST - 5;
constexpr int MAX_CAND = 3;        // mid-symbol candidates (cqpsk_params)
constexpr int S_VAL = HIST - 5 - 4;  // symbol-value window (n0 = delay 4)
constexpr int TILE = 32;           // lanes of a consumer warp
constexpr int MAX_TILES = 4;       // tiles a block: a consumer a scheduler
constexpr int STAGE = 24;          // rows a stage
constexpr int STAGES = 4;
constexpr int RING = STAGE * STAGES;  // as many as four tiles' rings hold
constexpr int GROUP = 4;           // rows a producer warp takes at once
constexpr int SYMBOL_WARPS = 2;    // a tile's warps for atan2f and stores
constexpr int WARPS = 2 + SYMBOL_WARPS;  // a tile's: consumer, interpolation
static_assert(STAGES >= 2, "a stage being turned while one is read");
static_assert(STAGE % (GROUP * SYMBOL_WARPS) == 0,
              "every stage splits its groups alike, and only the block's "
              "last group is partial");
constexpr int PROBE_ROWS = 64;     // samples the chain probe replays
constexpr unsigned FULL = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;        // float32(pi)
constexpr float kTwoPi = 6.28318530717958647692f;     // float32(2*pi)
constexpr float kQuarterPi = 0.78539816339744830962f; // float32(pi/4)
constexpr float kFracMax = 0.999f;
constexpr float kDelay = 4.0f;
// A row's y_r where the lane emitted nothing: a NaN no arithmetic gives
// (an operation on a NaN gives the canonical 0x7fffffff).
constexpr unsigned kNoEmit = 0xffffffffu;

struct CqpskConsts {
  float farrow[DEG1 * NTAP];       // [5, 8] value taps, highest power first
};

struct LoopConsts {
  float omega_lo, omega_hi, fmax, k_mu, k_om, k_f;
  int n0_count;
};

// One lane's carried state, in registers for the whole launch.
struct Lane {
  float t, omega, freq, phase, pr, pi;
  float hr[HIST], hi[HIST];
};

// A tile's ring and the barriers that hand its stages over.
struct __align__(16) TileSmem {
  float xr[RING][TILE];     // the planes' sample, the rotated one, then z
  float xi[RING][TILE];
  float yr[RING][TILE];     // the emit's symbol value, else kNoEmit's bits
  float yi[RING][TILE];
  uint64_t full[STAGES];    // the stage's rows have landed
  uint64_t handed[STAGES];  // every lane of the tile has taken them
  uint64_t interpolated[STAGES];  // their z are in the ring
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// fmodf(x, y) for y > 0. The loop's arguments stay below 2.5 y in
// magnitude (a phase below 2 pi plus 2 pi and the frequency; arg * pi
// within +/-4 pi), and there |x| minus the one or two y below it is exact
// (Sterbenz's lemma: a - b is exact for b/2 <= a <= 2b), so the remainder,
// with the sign of x, is fmodf's to the bit without its general loop.
// Other arguments take fmodf.
__device__ __forceinline__ float fmod_pos(float x, float y) {
  const float ax = fabsf(x);
  if (!(ax < __fmul_rn(2.5f, y))) return fmodf(x, y);
  const float y2 = __fmul_rn(2.0f, y);
  const float m1 = __fsub_rn(ax, y), m2 = __fsub_rn(ax, y2);
  return copysignf(ax < y ? ax : (ax < y2 ? m1 : m2), x);
}

// jnp.mod / torch.remainder: C fmod, then a nonzero remainder whose sign
// differs from the divisor's moves by one divisor.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float m = fmod_pos(x, y);
  if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
  return m;
}

// Farrow taps at frac by Horner, highest power first.
__device__ __forceinline__ void horner(const CqpskConsts& kc, float frac,
                                       float (&tt)[NTAP]) {
#pragma unroll
  for (int j = 0; j < NTAP; ++j) {
    float v = kc.farrow[j];
#pragma unroll
    for (int d = 1; d < DEG1; ++d)
      v = __fadd_rn(__fmul_rn(v, frac), kc.farrow[d * NTAP + j]);
    tt[j] = v;
  }
}

// The 8-term sums of a window and its taps, in index order.
__device__ __forceinline__ void window_sum(const float (&wr)[NTAP],
                                           const float (&wi)[NTAP],
                                           const float (&tt)[NTAP],
                                           float& yr, float& yi) {
  float ar = __fmul_rn(wr[0], tt[0]);
  float ai = __fmul_rn(wi[0], tt[0]);
#pragma unroll
  for (int j = 1; j < NTAP; ++j) {
    ar = __fadd_rn(ar, __fmul_rn(wr[j], tt[j]));
    ai = __fadd_rn(ai, __fmul_rn(wi[j], tt[j]));
  }
  yr = ar;
  yi = ai;
}

template <int S0>
__device__ __forceinline__ void window(const Lane& L, float (&wr)[NTAP],
                                       float (&wi)[NTAP]) {
  static_assert(S0 >= 0 && S0 + NTAP <= HIST, "window outside history");
#pragma unroll
  for (int j = 0; j < NTAP; ++j) {
    wr[j] = L.hr[S0 + j];
    wi[j] = L.hi[S0 + j];
  }
}

// Candidate N0F + Q's window replaces the picked one where k == Q.
template <int N0F, int Q>
__device__ __forceinline__ void pick(const Lane& L, int k, float (&wr)[NTAP],
                                     float (&wi)[NTAP]) {
  if constexpr (Q < MAX_CAND && N0F + Q <= N0_MAX) {
    constexpr int S0 = HIST - 5 - N0F - Q;
#pragma unroll
    for (int j = 0; j < NTAP; ++j) {
      wr[j] = k == Q ? L.hr[S0 + j] : wr[j];
      wi[j] = k == Q ? L.hi[S0 + j] : wi[j];
    }
  }
}

// The carrier NCO's phase for the lane's next sample, and its sine and
// cosine. It reads only the phase and freq, and freq moves only at a
// symbol instant, so after a sample that emits nothing it runs before the
// next one is read.
struct Nco {
  float phase, sn, cs;
};

__device__ __forceinline__ Nco next_nco(const Lane& L) {
  Nco q;
  q.phase = floor_mod(__fadd_rn(__fadd_rn(L.phase, L.freq), kTwoPi), kTwoPi);
  sincosf(q.phase, &q.sn, &q.cs);
  return q;
}

// One input sample into the lane at the NCO's phase q: de-rotation
// x * e^{-i*phase} and the history shift (compile-time indices: the
// history stays in registers), then t + 1. Returns whether the sample is
// a symbol instant.
__device__ __forceinline__ bool take_sample(Lane& L, const Nco& q, float are,
                                            float aim) {
  L.phase = q.phase;
  const float sn = q.sn, cs = q.cs;
  const float xr = __fadd_rn(__fmul_rn(are, cs), __fmul_rn(aim, sn));
  const float xi = __fsub_rn(__fmul_rn(aim, cs), __fmul_rn(are, sn));
#pragma unroll
  for (int j = 0; j < HIST - 1; ++j) {
    L.hr[j] = L.hr[j + 1];
    L.hi[j] = L.hi[j + 1];
  }
  L.hr[HIST - 1] = xr;
  L.hi[HIST - 1] = xi;
  L.t = __fadd_rn(L.t, 1.0f);
  return L.t >= L.omega;
}

// y * conj(prev), whose phase in quarter-pi units is the symbol.
struct Z {
  float r, i;
};

__device__ __forceinline__ Z diff_z(float yr, float yi, float pr, float pi) {
  return Z{__fadd_rn(__fmul_rn(yr, pr), __fmul_rn(yi, pi)),
           __fsub_rn(__fmul_rn(yi, pr), __fmul_rn(yr, pi))};
}

__device__ __forceinline__ float arg_of(Z z) {
  return __fdiv_rn(atan2f(z.i, z.r), kQuarterPi);
}

__device__ __forceinline__ int dibit_of(float arg) {
  return arg > 2.0f ? 1 : (arg > 0.0f ? 0 : (arg > -2.0f ? 2 : 3));
}

// The symbol instant: Gardner timing error Re{(y_k - y_{k-1}) conj(y_mid)}
// and the x4 power-law AFC, with the candidates' windows N0F, N0F+1, ...
// The symbol's value y becomes prev.
template <int N0F>
__device__ __forceinline__ void emit_step(Lane& L, const CqpskConsts& kc,
                                          const LoopConsts& lc) {
  const float frac_late = __fsub_rn(L.t, L.omega);
  const float p_sym = __fadd_rn(frac_late, kDelay);
  const float p_half = __fadd_rn(p_sym, __fmul_rn(L.omega, 0.5f));
  float tt[NTAP], wr[NTAP], wi[NTAP];
  horner(kc, clampf(__fsub_rn(p_sym, kDelay), 0.0f, kFracMax), tt);
  window<S_VAL>(L, wr, wi);
  float y_r, y_i;
  window_sum(wr, wi, tt, y_r, y_i);
  // the JAX where-chain: the last candidate n0 with p_half >= n0, else
  // the first
  int k = 0;
#pragma unroll
  for (int q = 1; q < MAX_CAND; ++q)
    if (q < lc.n0_count && p_half >= (float)(N0F + q)) k = q;
  horner(kc, clampf(__fsub_rn(p_half, (float)(N0F + k)), 0.0f, kFracMax),
         tt);
  window<HIST - 5 - N0F>(L, wr, wi);
  pick<N0F, 1>(L, k, wr, wi);
  pick<N0F, 2>(L, k, wr, wi);
  float m_r, m_i;
  window_sum(wr, wi, tt, m_r, m_i);

  const float e_t = clampf(
      __fadd_rn(__fmul_rn(__fsub_rn(y_r, L.pr), m_r),
                __fmul_rn(__fsub_rn(y_i, L.pi), m_i)),
      -1.0f, 1.0f);
  L.omega = clampf(__fsub_rn(L.omega, __fmul_rn(lc.k_om, e_t)), lc.omega_lo,
                   lc.omega_hi);
  L.t = __fadd_rn(frac_late, __fmul_rn(lc.k_mu, e_t));

  const float arg = arg_of(diff_z(y_r, y_i, L.pr, L.pi));
  const float err4 = __fsub_rn(
      floor_mod(__fadd_rn(__fsub_rn(__fmul_rn(arg, kPi), kPi), kPi), kTwoPi),
      kPi);
  const float err = __fmul_rn(err4, 0.25f);
  L.freq = clampf(__fadd_rn(L.freq, __fdiv_rn(__fmul_rn(lc.k_f, err),
                                              L.omega)),
                  -lc.fmax, lc.fmax);
  L.pr = y_r;
  L.pi = y_i;
}

__device__ __forceinline__ void load_lane(Lane& L, long long li,
                                          const float* t, const float* omega,
                                          const float* freq,
                                          const float* phase,
                                          const float* hist_re,
                                          const float* hist_im,
                                          const float* prev_re,
                                          const float* prev_im) {
  L.t = t[li];
  L.omega = omega[li];
  L.freq = freq[li];
  L.phase = phase[li];
  L.pr = prev_re[li];
  L.pi = prev_im[li];
#pragma unroll
  for (int j = 0; j < HIST; ++j) {
    L.hr[j] = hist_re[li * HIST + j];
    L.hi[j] = hist_im[li * HIST + j];
  }
}

__device__ __forceinline__ void store_lane(const Lane& L, long long li,
                                           float* t, float* omega,
                                           float* freq, float* phase,
                                           float* hist_re, float* hist_im,
                                           float* prev_re, float* prev_im) {
  t[li] = L.t;
  omega[li] = L.omega;
  freq[li] = L.freq;
  phase[li] = L.phase;
  prev_re[li] = L.pr;
  prev_im[li] = L.pi;
#pragma unroll
  for (int j = 0; j < HIST; ++j) {
    hist_re[li * HIST + j] = L.hr[j];
    hist_im[li * HIST + j] = L.hi[j];
  }
}

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

// The phase stays open until this thread's cp.async copies issued before
// it have landed (the arrival itself is the thread's mbar_arrive).
__device__ __forceinline__ void mbar_track_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
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

// Whether that phase has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t parity_of(int stage) {
  return (uint32_t)(stage / STAGES) & 1u;
}

// The consumer: the lane's feedback loop over its N samples (n = 0 for a
// lane past S*C), symbol by symbol, every rotated sample and each emit's
// symbol value written to the tile's ring.
template <int N0F>
__device__ __forceinline__ void consume(TileSmem& sm, Lane& L, float gain,
                                        int n, int N, const CqpskConsts& kc,
                                        const LoopConsts& lc, int lane) {
  const int stages = (N + STAGE - 1) / STAGE;
  int landed = 0;   // stages this warp has seen land
  int handed = 0;   // stages handed to the producer
  int i = 0;
  for (;;) {
    const int lo = __reduce_min_sync(FULL, i < n ? i : N);
    while (handed < stages && min(N, (handed + 1) * STAGE) <= lo) {
      mbar_arrive(&sm.handed[handed % STAGES]);
      ++handed;
    }
    if (lo >= N) break;
    for (; landed <= lo / STAGE; ++landed)   // the slowest lane's stage
      mbar_wait(&sm.full[landed % STAGES], parity_of(landed));
    // and those after it that have landed (lane 0's test for the warp;
    // the wait then gives every lane the stage's rows)
    while (landed < stages && landed <= handed + STAGES - 1 &&
           __shfl_sync(FULL, (int)mbar_test(&sm.full[landed % STAGES],
                                            parity_of(landed)), 0)) {
      mbar_wait(&sm.full[landed % STAGES], parity_of(landed));
      ++landed;
    }
    const int lim = min(n, landed * STAGE);
    bool emit = false;
    int r = i % RING;
    if (i < lim) {                        // the lane's samples to its emit
      float nre = sm.xr[r][lane], nim = sm.xi[r][lane];
      Nco q = next_nco(L);
      for (;;) {
        const float are = nre, aim = nim;
        const int rn = r + 1 < RING ? r + 1 : 0;
        nre = sm.xr[rn][lane];            // read ahead; a row that has not
        nim = sm.xi[rn][lane];            // landed is read again next pass
        emit = take_sample(L, q, __fmul_rn(are, gain), __fmul_rn(aim, gain));
        sm.xr[r][lane] = L.hr[HIST - 1];
        sm.xi[r][lane] = L.hi[HIST - 1];
        if (emit) break;
        q = next_nco(L);
        if (++i >= lim) break;
        r = rn;
      }
    }
    __syncwarp();
    if (emit) {                           // once per symbol, lanes together
      emit_step<N0F>(L, kc, lc);
      sm.yr[r][lane] = L.pr;
      sm.yi[r][lane] = L.pi;
      ++i;
    }
  }
}

// Symbol warp sw's copies of its rows of stage k (GROUP rows in turn to
// each symbol warp) into their slots, their y_r reset to kNoEmit; the
// stage's `full` phase completes when every symbol warp's copies have
// landed.
__device__ __forceinline__ void fill_rows(TileSmem& sm, int k, int sw,
                                          const float* xr, const float* xi,
                                          long long in0, int C, int N,
                                          bool active, int lane) {
  const int r0 = k * STAGE, base = (k % STAGES) * STAGE;
  const int cnt = min(N - r0, STAGE);
  for (int j = sw * GROUP; j < cnt; j += SYMBOL_WARPS * GROUP)
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      if (j + g < cnt) {
        const int s = base + j + g;
        if (active) {
          const long long o = in0 + (long long)(r0 + j + g) * C;
          cp_async4(&sm.xr[s][lane], xr + o);
          cp_async4(&sm.xi[s][lane], xi + o);
        }
        sm.yr[s][lane] = __uint_as_float(kNoEmit);
      }
  mbar_track_copies(&sm.full[k % STAGES]);
  mbar_arrive(&sm.full[k % STAGES]);
}

__device__ __forceinline__ bool emitted(float yr) {
  return __float_as_uint(yr) != kNoEmit;
}

// The interpolation warp's lane state: the 8 rotated samples before the
// next row (oldest first) and the prev in force there.
struct Interp {
  float wr[NTAP + GROUP], wi[NTAP + GROUP];
  float pr, pi;
};

// The cnt rows of stage q of the lane, handed over by the consumer: each
// row's symbol value (off a symbol instant the value interpolation with
// the held taps, at one the consumer's y) and z = y conj(prev) in row
// order, the prev moving at each emit; z is written over the rotated
// sample, which the window holds.
__device__ __forceinline__ void interpolate_rows(TileSmem& sm, Interp& W,
                                                 int q, int cnt,
                                                 const float (&vt)[NTAP],
                                                 int lane) {
  const int base = (q % STAGES) * STAGE;
  for (int j = 0; j < cnt; j += GROUP) {
    float yr[GROUP], yi[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {     // past cnt: rows of no one's
      const int s = base + j + g;
      W.wr[NTAP + g] = sm.xr[s][lane];
      W.wi[NTAP + g] = sm.xi[s][lane];
      yr[g] = sm.yr[s][lane];
      yi[g] = sm.yi[s][lane];
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float wr[NTAP], wi[NTAP], y_r, y_i;
#pragma unroll
      for (int k = 0; k < NTAP; ++k) {
        wr[k] = W.wr[g + k];
        wi[k] = W.wi[g + k];
      }
      window_sum(wr, wi, vt, y_r, y_i);
      const bool emit = emitted(yr[g]);
      y_r = emit ? yr[g] : y_r;
      y_i = emit ? yi[g] : y_i;
      const Z z = diff_z(y_r, y_i, W.pr, W.pi);
      W.pr = emit ? y_r : W.pr;
      W.pi = emit ? y_i : W.pi;
      if (j + g < cnt) {
        sm.xr[base + j + g][lane] = z.r;
        sm.xi[base + j + g][lane] = z.i;
      }
    }
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      W.wr[k] = W.wr[k + GROUP];
      W.wi[k] = W.wi[k + GROUP];
    }
  }
}

// Symbol warp sw's rows of the cnt of stage q, their z in the ring:
// atan2f and the division by pi/4 of GROUP rows side by side, then the
// symbol, valid flag and dibit of each, stored one coalesced row at a
// time.
__device__ __forceinline__ void store_symbols(const TileSmem& sm, int q,
                                              int cnt, int sw, float* syms,
                                              int* valid, int* dibits,
                                              long long in0, int C,
                                              int lane) {
  const int base = (q % STAGES) * STAGE;
  for (int j = sw * GROUP; j < cnt; j += SYMBOL_WARPS * GROUP) {
    float arg[GROUP];
    int v[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int s = base + j + g;
      arg[g] = arg_of(Z{sm.xr[s][lane], sm.xi[s][lane]});
      v[g] = emitted(sm.yr[s][lane]) ? 1 : 0;
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      if (j + g < cnt) {
        const long long o = in0 + (long long)(q * STAGE + j + g) * C;
        syms[o] = arg[g];
        valid[o] = v[g];
        dibits[o] = dibit_of(arg[g]);
      }
  }
}

// The interpolation warp: for each stage the consumer hands over, its z.
__device__ __forceinline__ void interpolate(TileSmem& sm, Interp& W, int N,
                                            bool active,
                                            const float (&vt)[NTAP],
                                            int lane) {
  const int stages = (N + STAGE - 1) / STAGE;
  for (int q = 0; q < stages; ++q) {
    mbar_wait(&sm.handed[q % STAGES], parity_of(q));
    if (active)
      interpolate_rows(sm, W, q, min(N - q * STAGE, STAGE), vt, lane);
    mbar_arrive(&sm.interpolated[q % STAGES]);
  }
}

// Symbol warp sw: its rows of the first STAGES stages' copies, then for
// each stage whose z are in, its rows' symbols and the copies of its rows
// of the stage STAGES on into their slots.
__device__ __forceinline__ void symbols(TileSmem& sm, int sw,
                                        const float* xr, const float* xi,
                                        long long in0, int C, int N,
                                        bool active, float* syms,
                                        int* valid, int* dibits, int lane) {
  const int stages = (N + STAGE - 1) / STAGE;
  for (int k = 0; k < min(stages, STAGES); ++k)
    fill_rows(sm, k, sw, xr, xi, in0, C, N, active, lane);
  for (int q = 0; q < stages; ++q) {
    mbar_wait(&sm.interpolated[q % STAGES], parity_of(q));
    if (active)
      store_symbols(sm, q, min(N - q * STAGE, STAGE), sw, syms, valid,
                    dibits, in0, C, lane);
    if (q + STAGES < stages)
      fill_rows(sm, q + STAGES, sw, xr, xi, in0, C, N, active, lane);
  }
}

extern __shared__ TileSmem tile_smem[];  // a block's tiles

template <int N0F>
__global__ void __launch_bounds__(TILE * MAX_TILES * WARPS)
cqpsk_track_kernel(const float* __restrict__ y_re,
                   const float* __restrict__ y_im,
                   const float* __restrict__ scale, float* __restrict__ t_io,
                   float* __restrict__ omega_io, float* __restrict__ freq_io,
                   float* __restrict__ phase_io,
                   float* __restrict__ hist_re_io,
                   float* __restrict__ hist_im_io,
                   float* __restrict__ prev_re_io,
                   float* __restrict__ prev_im_io, float* __restrict__ syms,
                   int* __restrict__ valid, int* __restrict__ dibits,
                   const CqpskConsts kc, const LoopConsts lc, int S, int N,
                   int C) {
  // Warps [0, tiles) are the block's consumers, [tiles, 2 tiles) their
  // interpolation warps, then SYMBOL_WARPS rounds of their symbol warps.
  // Lanes past S*C take no samples but stay in the loop: it votes per
  // warp.
  const int tiles = blockDim.x / (TILE * WARPS);
  const int warp = threadIdx.x / TILE;
  const int lane = threadIdx.x % TILE;
  const int w = warp % tiles;
  const int role = warp / tiles;       // 0 consumer, 1 interpolation, ...
  TileSmem& sm = tile_smem[w];
  const long long first = ((long long)blockIdx.x * tiles + w) * TILE;
  const long long li_raw = first + lane;
  const bool active = li_raw < (long long)S * C;
  const long long li = active ? li_raw : 0;
  const long long in0 = (li / C) * N * C + li % C;

  if (lane == 0 && role == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.full[st], TILE * SYMBOL_WARPS);
      mbar_init(&sm.handed[st], TILE);
      mbar_init(&sm.interpolated[st], TILE);
    }
  }
  // each role reads its part of the carried state before any writes it
  Lane L;
  Interp W;
  if (role == 0) {
    load_lane(L, li, t_io, omega_io, freq_io, phase_io, hist_re_io,
              hist_im_io, prev_re_io, prev_im_io);
  } else if (role == 1) {
    W.pr = prev_re_io[li];
    W.pi = prev_im_io[li];
#pragma unroll
    for (int j = 0; j < NTAP; ++j) {
      W.wr[j] = hist_re_io[li * HIST + HIST - NTAP + j];
      W.wi[j] = hist_im_io[li * HIST + HIST - NTAP + j];
    }
  }
  __syncthreads();
  if (first >= (long long)S * C) return;  // a tile past the lanes

  if (role == 1) {
    // off a symbol instant the scan evaluates the value taps at
    // clip((0 + 4) - 4) = 0: held for the launch
    float vt[NTAP];
    horner(kc, clampf(__fsub_rn(__fadd_rn(0.0f, kDelay), kDelay), 0.0f,
                      kFracMax), vt);
    interpolate(sm, W, N, active, vt, lane);
    return;
  }
  if (role > 1) {
    symbols(sm, role - 2, y_re, y_im, in0, C, N, active, syms, valid,
            dibits, lane);
    return;
  }
  consume<N0F>(sm, L, scale[li], active ? N : 0, N, kc, lc, lane);
  if (active)
    store_lane(L, li, t_io, omega_io, freq_io, phase_io, hist_re_io,
               hist_im_io, prev_re_io, prev_im_io);
}

// The feedback chain alone, one warp of 32 lanes from the given state
// (updated in place): the NCO, rotation and history shift of every sample
// and the emit step once per symbol, symbol-major as the tracker runs
// them, with no non-emit interpolation, atan2f or store. PROBE_ROWS rows
// of gained samples x [PROBE_ROWS, 32] staged in shared memory are
// replayed for `steps` samples; cycles[0] gets the clock64() count.
template <int N0F>
__global__ void __launch_bounds__(32)
cqpsk_chain_probe(const float* __restrict__ x_re,
                  const float* __restrict__ x_im, float* __restrict__ t_io,
                  float* __restrict__ omega_io, float* __restrict__ freq_io,
                  float* __restrict__ phase_io,
                  float* __restrict__ hist_re_io,
                  float* __restrict__ hist_im_io,
                  float* __restrict__ prev_re_io,
                  float* __restrict__ prev_im_io,
                  long long* __restrict__ cycles, const CqpskConsts kc,
                  const LoopConsts lc, int steps) {
  __shared__ float rows_re[PROBE_ROWS][32], rows_im[PROBE_ROWS][32];
  const int lane = threadIdx.x;
  for (int r = 0; r < PROBE_ROWS; ++r) {
    rows_re[r][lane] = x_re[r * 32 + lane];
    rows_im[r][lane] = x_im[r * 32 + lane];
  }
  Lane L;
  load_lane(L, lane, t_io, omega_io, freq_io, phase_io, hist_re_io,
            hist_im_io, prev_re_io, prev_im_io);
  __syncwarp();
  const long long t0 = clock64();
  int i = 0;
  while (__any_sync(FULL, i < steps)) {
    bool emit = false;
    Nco q = next_nco(L);
    while (i < steps) {
      const int r = i & (PROBE_ROWS - 1);
      if (take_sample(L, q, rows_re[r][lane], rows_im[r][lane])) {
        emit = true;
        break;
      }
      q = next_nco(L);
      ++i;
    }
    __syncwarp();
    if (emit) {
      emit_step<N0F>(L, kc, lc);
      ++i;
    }
  }
  const long long t1 = clock64();
  store_lane(L, lane, t_io, omega_io, freq_io, phase_io, hist_re_io,
             hist_im_io, prev_re_io, prev_im_io);
  if (lane == 0) cycles[0] = t1 - t0;
}

int check_candidates(int n0_first, int n0_count) {
  if (n0_count < 1 || n0_count > MAX_CAND || n0_first < N0_MIN ||
      n0_first + n0_count - 1 > N0_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

CqpskConsts read_consts(const void* host_consts) {
  CqpskConsts kc;
  const float* hc = (const float*)host_consts;
  for (int j = 0; j < DEG1 * NTAP; ++j) kc.farrow[j] = hc[j];
  return kc;
}

// Tiles a block: as few as spread the tiles over the card's SMs, at most
// MAX_TILES (one block of four on an SM gives each scheduler a consumer).
int tiles_per_block(long long tiles, int* out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &n, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    sms = n;
  }
  const long long spread = (tiles + sms - 1) / sms;
  *out = spread < MAX_TILES ? (int)spread : MAX_TILES;
  return (int)cudaSuccess;
}

}  // namespace

// One instantiation per first candidate n0 in [N0_MIN, N0_MAX].
#define RC_N0_CASES(X)                                                     \
  X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15)  \
  X(16) X(17) X(18) X(19)

extern "C" int cqpsk_track_launch(
    const void* y_re, const void* y_im, const void* scale, void* t,
    void* omega, void* freq, void* phase, void* hist_re, void* hist_im,
    void* prev_re, void* prev_im, void* syms, void* valid, void* dibits,
    const void* host_consts, int S, int N, int C, int n0_first,
    int n0_count, float omega_lo, float omega_hi, float fmax, float k_mu,
    float k_om, float k_f, void* stream) {
  if (int err = check_candidates(n0_first, n0_count)) return err;
  const long long lanes = (long long)S * C;
  if (lanes <= 0 || N <= 0) return (int)cudaSuccess;
  const CqpskConsts kc = read_consts(host_consts);
  const LoopConsts lc{omega_lo, omega_hi, fmax, k_mu, k_om, k_f, n0_count};
  const long long tiles = (lanes + TILE - 1) / TILE;
  int per_block = 1;
  if (int err = tiles_per_block(tiles, &per_block)) return err;
  const unsigned blocks = (unsigned)((tiles + per_block - 1) / per_block);
  const int threads = TILE * WARPS * per_block;
  const int smem = per_block * (int)sizeof(TileSmem);
  constexpr int smem_max = MAX_TILES * (int)sizeof(TileSmem);
  static bool sized[N0_MAX + 1] = {};
  cudaStream_t st = (cudaStream_t)stream;
#define RC_TRACK_CASE(N0F)                                                 \
  case N0F:                                                                \
    if (!sized[N0F]) {                                                     \
      if (cudaError_t e = cudaFuncSetAttribute(                            \
              cqpsk_track_kernel<N0F>,                                     \
              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max))      \
        return (int)e;                                                     \
      sized[N0F] = true;                                                   \
    }                                                                      \
    cqpsk_track_kernel<N0F><<<blocks, threads, smem, st>>>(                \
        (const float*)y_re, (const float*)y_im, (const float*)scale,       \
        (float*)t, (float*)omega, (float*)freq, (float*)phase,             \
        (float*)hist_re, (float*)hist_im, (float*)prev_re,                 \
        (float*)prev_im, (float*)syms, (int*)valid, (int*)dibits, kc, lc,  \
        S, N, C);                                                          \
    break;
  switch (n0_first) { RC_N0_CASES(RC_TRACK_CASE) }
#undef RC_TRACK_CASE
  return (int)cudaGetLastError();
}

extern "C" int cqpsk_chain_probe_launch(
    const void* x_re, const void* x_im, void* t, void* omega, void* freq,
    void* phase, void* hist_re, void* hist_im, void* prev_re, void* prev_im,
    void* cycles, const void* host_consts, int steps, int n0_first,
    int n0_count, float omega_lo, float omega_hi, float fmax, float k_mu,
    float k_om, float k_f, void* stream) {
  if (int err = check_candidates(n0_first, n0_count)) return err;
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  const CqpskConsts kc = read_consts(host_consts);
  const LoopConsts lc{omega_lo, omega_hi, fmax, k_mu, k_om, k_f, n0_count};
  cudaStream_t st = (cudaStream_t)stream;
#define RC_PROBE_CASE(N0F)                                                 \
  case N0F:                                                                \
    cqpsk_chain_probe<N0F><<<1, 32, 0, st>>>(                              \
        (const float*)x_re, (const float*)x_im, (float*)t, (float*)omega,  \
        (float*)freq, (float*)phase, (float*)hist_re, (float*)hist_im,     \
        (float*)prev_re, (float*)prev_im, (long long*)cycles, kc, lc,      \
        steps);                                                            \
    break;
  switch (n0_first) { RC_N0_CASES(RC_PROBE_CASE) }
#undef RC_PROBE_CASE
  return (int)cudaGetLastError();
}
