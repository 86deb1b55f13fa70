// Per-lane CQPSK (P25 LSM) tracker for Hopper (sm_90a): feedforward AGC
// gain -> carrier NCO -> Farrow interpolation -> Gardner timing -> diff
// phase atan2/(pi/4) -> x4 power-law AFC -> slicer, one thread per
// (source, slot) lane, the loop run symbol by symbol.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (CqpskControlPipeline._step_impl,
// pipeline.py:340-350): the demod/cqpsk.py::cqpsk_demod lax.scan (body
// cqpsk.py:176-237) and slice_dibits_jax. The AGC gain 1/max(rms, 1e-9)
// (cqpsk.py::block_agc) comes in per lane, computed once in torch, and
// multiplies each sample as it is read, so no scaled copy of the planes
// exists.
//
// Bound: latency. 16384 lanes are 512 warps, one per scheduler of the 132
// SMs, so nothing hides a warp's stalls, and each lane is a serial
// feedback chain. The 32 lanes of a warp are independent channels whose
// symbol instants do not line up: at 25 kS/s and 4800 Bd a lane emits on
// one sample in 5.21, so a loop over samples has some lane of the warp
// emit on ~99.9% of them, and the warp runs the emit's work (a second
// Farrow evaluation, the mid-symbol window, Gardner, atan2f and the AFC
// division) on nearly every sample. This kernel is symbol-major instead.
// Each pass of the outer loop is one symbol for every lane of the warp:
// the inner loop takes the lane's own samples up to and including its next
// emit (5-6 at 4800 Bd, 4-5 at 6000), each with the AGC gain, the NCO's
// sine and cosine, the rotation, the history shift and t + 1. A sample
// that emits nothing then interpolates the symbol value with taps held
// for the launch (the Farrow polynomials at fraction 0, which is where the
// scan evaluates them off a symbol instant) and forms z = y conj(prev);
// the next sample's NCO (its phase through floor_mod, then sincosf) reads
// only the phase and freq, which hold until an emit, so it is computed
// beside that, which times faster on the H100 than the NCO at the head of
// each sample (tools/cqpsk_variants.py nco_inline). The emit sample leaves
// the inner loop, and after one __syncwarp the warp runs the emit step for
// all its emitting lanes at once: Farrow at the emit's fraction, the
// mid-symbol window at p_half = frac + 4 + omega/2 with the old omega, Gardner, the omega and
// t updates, atan2f, err4, the AFC and prev. A lane that reaches N
// mid-symbol stops with the state the per-sample loop leaves (t, phase and
// history moved, nothing else), and the warp runs until every lane has
// taken N samples. The mid-symbol window (n0 among cqpsk_params'
// candidates, at most MAX_CAND) is one Horner evaluation and 8 samples
// picked from the candidates' windows by predicated selects, not a
// divergent switch: the kernel is instantiated per first candidate n0, so
// history indices stay compile-time constants and the 48-float history
// stays in registers.
//
// Memory: the lanes of a warp sit at different sample indices (locked
// lanes a few samples apart; noise lanes free-run within the +/-2% omega
// clamp and drift tens of samples apart over a 2500-sample block), so a
// warp's direct load or store of the time-major [S, N, C] planes touches
// up to 32 rows: 32 sectors and 32 L1 wavefronts where a row takes 4.
// Each warp therefore stages its planes through a ring of RING rows x 32
// lanes in shared memory (RingIo). Lane c reads and writes only column c
// of a row, which is bank c whatever row it is at: no bank conflicts, and
// no lane reads what another wrote. A sample's slot takes its z once the
// lane has read it. Once per symbol the warp takes the slowest lane's
// row: the rows before it are complete, and every lane turns the z of its
// column of each into the symbol (atan2f, the division by pi/4, the
// dibit; two rows at a time, so that two atan2f chains overlap) and
// stores it, valid and dibit, one coalesced row at a time. The slots they
// free are refilled with the rows RING ahead by cp.async, one commit group
// per symbol, and a lane reads only rows whose group has landed (a lane
// that far ahead of the slowest waits, mid-symbol if need be, which leaves
// its state as the per-sample loop would). 64-thread blocks: 256 blocks
// spread the 512 warps over all 132 SMs. tools/cqpsk_variants.py times
// other block sizes and ring depths against these.
//
// What stays for the next stage: the non-emit samples' interpolation and
// z, the symbols' atan2f and stores, and the ring's loads still run in the
// lane's own warp, between its symbols; moving them into other warps (the
// rotated samples handed over through shared memory) leaves the chain with
// the NCO and one emit per symbol, which cqpsk_chain_probe below measures
// alone.
//
// Arithmetic follows the JAX scan step for step, and the outputs and
// carried state are bit-identical to the per-sample-loop kernel this
// replaces: every multiply and add is an explicitly rounded
// __fmul_rn/__fadd_rn/__fsub_rn (no FMA contraction), clips are
// fminf/fmaxf, jnp.mod is fmod (exact; fmod_pos) plus the sign fix,
// arg*pi - pi + pi is evaluated as written, the held taps are the same
// Horner steps on the same values, the emit's fraction is (frac + 4) - 4
// as the scan writes it, and the window's 8 products are summed in index
// order. Built without fast math: the loop feeds its own rounding back.

#include <cuda_runtime.h>

namespace {

constexpr int HIST = 24;           // complex history span (cqpsk.HIST_C)
constexpr int NTAP = 8;            // interpolator taps
constexpr int DEG1 = 5;            // degree-4 Farrow: 5 coefficient rows
constexpr int N0_MIN = 3;          // window start HIST-5-n0 in [0, HIST-8]
constexpr int N0_MAX = HIST - 5;
constexpr int MAX_CAND = 3;        // mid-symbol candidates (cqpsk_params)
constexpr int S_VAL = HIST - 5 - 4;  // symbol-value window (n0 = delay 4)
constexpr int THREADS = 64;
constexpr int RING = 64;           // staged rows per warp
static_assert(THREADS % 32 == 0, "whole warps: the loop votes per warp");
static_assert(RING >= 16 && RING <= 64 && (RING & (RING - 1)) == 0,
              "the ring holds a power of two of rows, a symbol's and more, "
              "and a lane keeps a bit per row in 64");
constexpr int PROBE_ROWS = 64;     // samples the chain probe replays
constexpr unsigned FULL = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;        // float32(pi)
constexpr float kTwoPi = 6.28318530717958647692f;     // float32(2*pi)
constexpr float kQuarterPi = 0.78539816339744830962f; // float32(pi/4)
constexpr float kFracMax = 0.999f;
constexpr float kDelay = 4.0f;

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
// symbol instant, so after a sample that emits nothing it runs beside that
// sample's outputs.
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
// Returns the symbol's z.
template <int N0F>
__device__ __forceinline__ Z emit_step(Lane& L, const CqpskConsts& kc,
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

  const Z z = diff_z(y_r, y_i, L.pr, L.pi);
  const float arg = arg_of(z);
  const float err4 = __fsub_rn(
      floor_mod(__fadd_rn(__fsub_rn(__fmul_rn(arg, kPi), kPi), kPi), kTwoPi),
      kPi);
  const float err = __fmul_rn(err4, 0.25f);
  L.freq = clampf(__fadd_rn(L.freq, __fdiv_rn(__fmul_rn(lc.k_f, err),
                                              L.omega)),
                  -lc.fmax, lc.fmax);
  L.pr = y_r;
  L.pi = y_i;
  return z;
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

extern __shared__ float ring[];  // [warps][2][RING][32], RingIo's

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The planes staged through this warp's ring of RING rows: ring[a + ...]
// holds each row's real part until the lane has read it, then z's;
// ring[b + ...] the imaginary parts; bit r % RING of `emits` whether row r
// was a symbol. (Offsets into the shared array, not pointers: a generic
// pointer would make every access convert its address.)
struct RingIo {
  const float* xr;
  const float* xi;
  float* syms;
  int* valid;
  int* dibits;
  int a, b;
  long long in0;
  int C, N, lane;
  bool active;
  int filled = 0, flushed = 0;  // rows copied in, rows stored out
  float nre = 0.0f, nim = 0.0f; // the next sample, read one ahead
  unsigned long long emits = 0;

  __device__ int slot(int r) const { return (r & (RING - 1)) * 32 + lane; }
  __device__ Z z_at(int r) const {
    return Z{ring[a + slot(r)], ring[b + slot(r)]};
  }
  __device__ void fill_to(int hi) {
    if (active)
      for (int r = filled; r < hi; ++r) {
        cp_async4(&ring[a + slot(r)], xr + in0 + (long long)r * C);
        cp_async4(&ring[b + slot(r)], xi + in0 + (long long)r * C);
      }
    filled = max(filled, hi);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ void store_row(int r, float arg) {
    const long long o = in0 + (long long)r * C;
    syms[o] = arg;
    valid[o] = (int)(emits >> (r & (RING - 1))) & 1;
    dibits[o] = dibit_of(arg);
  }
  // the rows every lane has passed: their symbols, two rows at a time so
  // that two atan2f chains run side by side
  __device__ void flush_to(int hi) {
    if (active) {
      int r = flushed;
      for (; r + 1 < hi; r += 2) {
        const float a0 = arg_of(z_at(r));
        const float a1 = arg_of(z_at(r + 1));
        store_row(r, a0);
        store_row(r + 1, a1);
      }
      if (r < hi) store_row(r, arg_of(z_at(r)));
    }
    flushed = hi;
  }
  __device__ void begin() {
    fill_to(min(N, RING));
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __device__ int advance(int lo) {
    flush_to(lo);
    const int ready = filled;  // rows of the groups before this one
    fill_to(min(N, lo + RING));
    asm volatile("cp.async.wait_group 1;\n" ::);
    return active ? ready : 0;
  }
  // where a lane takes up its samples again: its next row
  __device__ void resume(int i) {
    nre = ring[a + slot(i)];
    nim = ring[b + slot(i)];
  }
  // the row after i is read ahead whether or not it has landed: a lane
  // that stops before it takes it up again through resume()
  __device__ void sample(int i, float& re, float& im) {
    re = nre;
    im = nim;
    nre = ring[a + slot(i + 1)];
    nim = ring[b + slot(i + 1)];
  }
  __device__ void put(int i, Z z, int v) {
    ring[a + slot(i)] = z.r;
    ring[b + slot(i)] = z.i;
    const unsigned long long bit = 1ull << (i & (RING - 1));
    emits = v ? emits | bit : emits & ~bit;
  }
  // the last rows out; no copy left in flight into the block's ring
  __device__ void finish() {
    flush_to(N);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
};

template <int N0F>
__global__ void __launch_bounds__(THREADS)
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
  // Lanes past S*C take no samples but stay in the loop: it votes per warp.
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < (long long)S * C;
  const long long li = active ? lane : 0;
  const int s = (int)(li / C);
  const int c = (int)(li % C);
  const int n = active ? N : 0;
  const long long in0 = (long long)s * N * C + c;

  Lane L;
  load_lane(L, li, t_io, omega_io, freq_io, phase_io, hist_re_io, hist_im_io,
            prev_re_io, prev_im_io);
  const float gain = scale[li];
  // off a symbol instant the scan evaluates the value taps at
  // clip((0 + 4) - 4) = 0: held for the launch
  float vt[NTAP];
  horner(kc, clampf(__fsub_rn(__fadd_rn(0.0f, kDelay), kDelay), 0.0f,
                    kFracMax), vt);

  const int mine = (threadIdx.x / 32) * 2 * RING * 32;
  RingIo io{y_re, y_im, syms, valid, dibits, mine, mine + RING * 32, in0,
            C, N, (int)(threadIdx.x % 32), active};
  io.begin();
  int i = 0;
  for (;;) {
    const int lo = __reduce_min_sync(FULL, i < n ? i : N);
    if (lo >= N) break;
    const int lim = io.advance(lo);
    bool emit = false;
    if (i < lim) {                        // the lane's samples to its emit
      io.resume(i);
      Nco q = next_nco(L);
      for (;;) {
        float xr, xi;
        io.sample(i, xr, xi);
        if (take_sample(L, q, __fmul_rn(xr, gain), __fmul_rn(xi, gain))) {
          emit = true;
          break;
        }
        q = next_nco(L);                  // beside this sample's outputs
        float wr[NTAP], wi[NTAP], y_r, y_i;
        window<S_VAL>(L, wr, wi);
        window_sum(wr, wi, vt, y_r, y_i);
        io.put(i, diff_z(y_r, y_i, L.pr, L.pi), 0);
        if (++i >= lim) break;
      }
    }
    __syncwarp();
    if (emit) {                           // once per symbol, lanes together
      io.put(i, emit_step<N0F>(L, kc, lc), 1);
      ++i;
    }
  }
  io.finish();

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
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  constexpr int smem = THREADS * 2 * RING * (int)sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define RC_TRACK_CASE(N0F)                                                 \
  case N0F:                                                                \
    if (smem > 48 * 1024)                                                  \
      if (cudaError_t e = cudaFuncSetAttribute(                            \
              cqpsk_track_kernel<N0F>,                                     \
              cudaFuncAttributeMaxDynamicSharedMemorySize, smem))          \
        return (int)e;                                                     \
    cqpsk_track_kernel<N0F><<<blocks, THREADS, smem, st>>>(                \
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
