// Per-lane CQPSK (P25 LSM) tracker for Hopper (sm_90a): feedforward AGC
// gain -> carrier NCO -> Farrow interpolation -> Gardner timing -> diff
// phase atan2/(pi/4) -> x4 power-law AFC -> slicer, one thread per
// (source, slot) lane.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (CqpskControlPipeline._step_impl,
// pipeline.py:340-350): the demod/cqpsk.py::cqpsk_demod lax.scan (body
// cqpsk.py:176-237) and slice_dibits_jax. The AGC gain 1/max(rms, 1e-9)
// (cqpsk.py::block_agc) comes in per lane, computed once in torch, and
// multiplies each sample as it is read, so no scaled copy of the planes
// exists.
//
// Bound: latency. Each lane is a serial feedback chain per sample
// (sincosf -> 3 Farrow evaluations -> Gardner error -> atan2f -> AFC
// update), 2500 samples per 100 ms block at 25 kS/s; 16384 lanes are 128
// blocks of 128 threads, one warp per scheduler on the 132 SMs. So the
// lane state (t, omega, freq, phase, prev symbol and the 24-sample
// complex history, 48 floats) lives in registers for the whole block; the
// history is shifted and windowed with compile-time indices only (a
// dynamic index would spill it to local memory): the mid-symbol window's
// runtime n0 selects one of the statically unrolled cases 3..19. The next
// sample is loaded one iteration ahead, so the coalesced load of the
// time-major [S, N, C] planes overlaps the chain.
//
// Arithmetic follows the JAX scan step for step: every multiply and add
// is an explicitly rounded __fmul_rn/__fadd_rn/__fsub_rn (no FMA
// contraction), clips are fminf/fmaxf, jnp.mod is fmodf plus the sign
// fix, and arg*pi - pi + pi is evaluated as written. Only the selected
// mid-symbol window is evaluated: the JAX where-chain keeps the last
// candidate n0 with p_half >= n0 (else the first), and the other
// candidates never reach an output. Built without fast math: the loop
// feeds its own rounding back.

#include <cuda_runtime.h>

namespace {

constexpr int HIST = 24;           // complex history span (cqpsk.HIST_C)
constexpr int NTAP = 8;            // interpolator taps
constexpr int DEG1 = 5;            // degree-4 Farrow: 5 coefficient rows
constexpr int N0_MIN = 3;          // window start HIST-5-n0 in [0, HIST-8]
constexpr int N0_MAX = HIST - 5;
constexpr int THREADS = 128;
constexpr float kPi = 3.14159265358979323846f;        // float32(pi)
constexpr float kTwoPi = 6.28318530717958647692f;     // float32(2*pi)
constexpr float kQuarterPi = 0.78539816339744830962f; // float32(pi/4)
constexpr float kFracMax = 0.999f;
constexpr float kDelay = 4.0f;

struct CqpskConsts {
  float farrow[DEG1 * NTAP];       // [5, 8] value taps, highest power first
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// jnp.mod / torch.remainder: C fmod, then a nonzero remainder whose sign
// differs from the divisor's moves by one divisor.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float m = fmodf(x, y);
  if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
  return m;
}

// Farrow interpolation at n0 + frac samples before the newest history
// sample: taps by Horner in frac, then the 8-term sums in index order.
template <int N0>
__device__ __forceinline__ void interp_at(const float (&hr)[HIST],
                                          const float (&hi)[HIST],
                                          const CqpskConsts& kc, float frac,
                                          float& yr, float& yi) {
  constexpr int S0 = HIST - 5 - N0;
  static_assert(S0 >= 0 && S0 + NTAP <= HIST, "window outside history");
  float ar = 0.0f, ai = 0.0f;
#pragma unroll
  for (int j = 0; j < NTAP; ++j) {
    float tt = kc.farrow[j];
#pragma unroll
    for (int d = 1; d < DEG1; ++d)
      tt = __fadd_rn(__fmul_rn(tt, frac), kc.farrow[d * NTAP + j]);
    if (j == 0) {
      ar = __fmul_rn(hr[S0], tt);
      ai = __fmul_rn(hi[S0], tt);
    } else {
      ar = __fadd_rn(ar, __fmul_rn(hr[S0 + j], tt));
      ai = __fadd_rn(ai, __fmul_rn(hi[S0 + j], tt));
    }
  }
  yr = ar;
  yi = ai;
}

__device__ __forceinline__ void interp_window(int n0, const float (&hr)[HIST],
                                              const float (&hi)[HIST],
                                              const CqpskConsts& kc,
                                              float frac, float& yr,
                                              float& yi) {
  switch (n0) {
#define RC_INTERP_CASE(N)                         \
  case N:                                         \
    interp_at<N>(hr, hi, kc, frac, yr, yi);       \
    break;
    RC_INTERP_CASE(3) RC_INTERP_CASE(4) RC_INTERP_CASE(5) RC_INTERP_CASE(6)
    RC_INTERP_CASE(7) RC_INTERP_CASE(8) RC_INTERP_CASE(9) RC_INTERP_CASE(10)
    RC_INTERP_CASE(11) RC_INTERP_CASE(12) RC_INTERP_CASE(13)
    RC_INTERP_CASE(14) RC_INTERP_CASE(15) RC_INTERP_CASE(16)
    RC_INTERP_CASE(17) RC_INTERP_CASE(18) RC_INTERP_CASE(19)
#undef RC_INTERP_CASE
    default:  // unreachable: the launcher checks the candidate range
      yr = 0.0f;
      yi = 0.0f;
  }
}

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
                   const CqpskConsts kc, int S, int N, int C, int n0_first,
                   int n0_count, float omega_lo, float omega_hi, float fmax,
                   float k_mu, float k_om, float k_f) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)S * C) return;
  const int s = (int)(lane / C);
  const int c = (int)(lane % C);

  float t = t_io[lane];
  float omega = omega_io[lane];
  float freq = freq_io[lane];
  float phase = phase_io[lane];
  float pr = prev_re_io[lane];
  float pi = prev_im_io[lane];
  float hr[HIST], hi[HIST];
#pragma unroll
  for (int j = 0; j < HIST; ++j) {
    hr[j] = hist_re_io[lane * HIST + j];
    hi[j] = hist_im_io[lane * HIST + j];
  }
  const float gain = scale[lane];

  const long long in0 = (long long)s * N * C + c;
  const float* xr_p = y_re + in0;
  const float* xi_p = y_im + in0;
  float nre = xr_p[0];
  float nim = xi_p[0];

  for (int i = 0; i < N; ++i) {
    const float are = __fmul_rn(nre, gain);
    const float aim = __fmul_rn(nim, gain);
    if (i + 1 < N) {
      nre = xr_p[(long long)(i + 1) * C];
      nim = xi_p[(long long)(i + 1) * C];
    }
    // carrier NCO de-rotation: x * e^{-i*phase}
    phase = floor_mod(__fadd_rn(__fadd_rn(phase, freq), kTwoPi), kTwoPi);
    float sn, cs;
    sincosf(phase, &sn, &cs);
    const float xr = __fadd_rn(__fmul_rn(are, cs), __fmul_rn(aim, sn));
    const float xi = __fsub_rn(__fmul_rn(aim, cs), __fmul_rn(are, sn));
#pragma unroll
    for (int j = 0; j < HIST - 1; ++j) {
      hr[j] = hr[j + 1];
      hi[j] = hi[j + 1];
    }
    hr[HIST - 1] = xr;
    hi[HIST - 1] = xi;

    t = __fadd_rn(t, 1.0f);
    const bool emit = t >= omega;
    const float frac_late = emit ? __fsub_rn(t, omega) : 0.0f;
    const float p_sym = __fadd_rn(frac_late, kDelay);
    const float p_half = __fadd_rn(p_sym, __fmul_rn(omega, 0.5f));
    float y_r, y_i;
    interp_at<4>(hr, hi, kc,
                 clampf(__fsub_rn(p_sym, kDelay), 0.0f, kFracMax), y_r, y_i);
    int n0 = n0_first;
    for (int k = 1; k < n0_count; ++k)
      if (p_half >= (float)(n0_first + k)) n0 = n0_first + k;
    float m_r, m_i;
    interp_window(n0, hr, hi, kc,
                  clampf(__fsub_rn(p_half, (float)n0), 0.0f, kFracMax), m_r,
                  m_i);

    // Gardner timing error Re{(y_k - y_{k-1}) conj(y_mid)}
    const float e_t = clampf(
        __fadd_rn(__fmul_rn(__fsub_rn(y_r, pr), m_r),
                  __fmul_rn(__fsub_rn(y_i, pi), m_i)),
        -1.0f, 1.0f);
    if (emit) {
      omega = clampf(__fsub_rn(omega, __fmul_rn(k_om, e_t)), omega_lo,
                     omega_hi);
      t = __fadd_rn(frac_late, __fmul_rn(k_mu, e_t));
    }

    // differential phase in quarter-pi units, x4 power-law AFC
    const float z_r = __fadd_rn(__fmul_rn(y_r, pr), __fmul_rn(y_i, pi));
    const float z_i = __fsub_rn(__fmul_rn(y_i, pr), __fmul_rn(y_r, pi));
    const float arg = __fdiv_rn(atan2f(z_i, z_r), kQuarterPi);
    const float err4 = __fsub_rn(
        floor_mod(__fadd_rn(__fsub_rn(__fmul_rn(arg, kPi), kPi), kPi),
                  kTwoPi),
        kPi);
    const float err = __fmul_rn(err4, 0.25f);
    if (emit) {
      freq = clampf(__fadd_rn(freq, __fdiv_rn(__fmul_rn(k_f, err), omega)),
                    -fmax, fmax);
      pr = y_r;
      pi = y_i;
    }

    const long long o = in0 + (long long)i * C;
    syms[o] = arg;
    valid[o] = emit ? 1 : 0;
    dibits[o] = arg > 2.0f ? 1 : (arg > 0.0f ? 0 : (arg > -2.0f ? 2 : 3));
  }

  t_io[lane] = t;
  omega_io[lane] = omega;
  freq_io[lane] = freq;
  phase_io[lane] = phase;
  prev_re_io[lane] = pr;
  prev_im_io[lane] = pi;
#pragma unroll
  for (int j = 0; j < HIST; ++j) {
    hist_re_io[lane * HIST + j] = hr[j];
    hist_im_io[lane * HIST + j] = hi[j];
  }
}

}  // namespace

extern "C" int cqpsk_track_launch(
    const void* y_re, const void* y_im, const void* scale, void* t,
    void* omega, void* freq, void* phase, void* hist_re, void* hist_im,
    void* prev_re, void* prev_im, void* syms, void* valid, void* dibits,
    const void* host_consts, int S, int N, int C, int n0_first,
    int n0_count, float omega_lo, float omega_hi, float fmax, float k_mu,
    float k_om, float k_f, void* stream) {
  if (n0_count < 1 || n0_first < N0_MIN ||
      n0_first + n0_count - 1 > N0_MAX)
    return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)S * C;
  if (lanes <= 0 || N <= 0) return (int)cudaSuccess;
  CqpskConsts kc;
  const float* hc = (const float*)host_consts;
  for (int j = 0; j < DEG1 * NTAP; ++j) kc.farrow[j] = hc[j];
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  cqpsk_track_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)y_re, (const float*)y_im, (const float*)scale,
      (float*)t, (float*)omega, (float*)freq, (float*)phase,
      (float*)hist_re, (float*)hist_im, (float*)prev_re, (float*)prev_im,
      (float*)syms, (int*)valid, (int*)dibits, kc, S, N, C, n0_first,
      n0_count, omega_lo, omega_hi, fmax, k_mu, k_om, k_f);
  return (int)cudaGetLastError();
}
