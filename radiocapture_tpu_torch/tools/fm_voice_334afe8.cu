// Fused analog voice tracker for Hopper (sm_90a): quadrature
// discriminator -> 75 us de-emphasis IIR -> squelch power meter, one
// thread per (source, slot) lane.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (AnalogVoicePipeline._step_impl,
// pipeline.py:420-423): ops/fm.py::quadrature_demod, the
// ops/fm.py::fm_deemphasis / first_order_iir lax.associative_scan
// (fm.py:44-84) and the power meter mean(|chan|^2).
//
// Bound: at the bench shape (8192 lanes x 2500 samples) the kernel reads
// ~164 MB and writes ~82 MB, ~0.07 ms at 3.35 TB/s; the serial part of
// each lane is one FMA per sample (the IIR), the atan2f of each sample
// depends only on the input. With 8192 lanes there are ~2 warps per SM,
// too few to hide load latency by occupancy, so each thread loads UNROLL
// samples of both planes before it computes them (independent loads in
// flight), loads and stores coalesce across neighbouring slots of the
// time-major [S, N, C] planes, and 64-thread blocks spread the lanes over
// all SMs. The power sum is kept in double, so its rounding does not grow
// with N. Built without fast math, as the other trackers.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

struct VoiceLane {
  float pr, pi;   // previous complex sample
  float yl, xl;   // de-emphasis output / input of the previous sample
  double pw;      // running sum of |x|^2
};

__device__ __forceinline__ float voice_sample(VoiceLane& st, float are,
                                              float aim, float gain,
                                              float z1, float b0) {
  // x * conj(prev), as the complex multiply with b = conj(prev)
  const float dre = are * st.pr - aim * (-st.pi);
  const float dim = are * (-st.pi) + aim * st.pr;
  const float disc = gain * atan2f(dim, dre);
  st.pr = are;
  st.pi = aim;
  // y[n] = z1 * y[n-1] + b0 * (x[n] + x[n-1])
  st.yl = z1 * st.yl + b0 * (disc + st.xl);
  st.xl = disc;
  st.pw += (double)(are * are + aim * aim);
  return st.yl;
}

__global__ void __launch_bounds__(THREADS)
fm_voice_kernel(const float* __restrict__ y_re,
                const float* __restrict__ y_im, float* __restrict__ prev,
                float* __restrict__ y_last, float* __restrict__ x_last,
                float* __restrict__ audio, float* __restrict__ power, int S,
                int N, int C, float gain, float z1, float b0) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)S * C) return;
  const int s = (int)(lane / C);
  const int c = (int)(lane % C);
  VoiceLane st{prev[2 * lane], prev[2 * lane + 1], y_last[lane],
               x_last[lane], 0.0};
  const long long base = (long long)s * N * C + c;
  const float* xr = y_re + base;
  const float* xi = y_im + base;
  float* out = audio + base;

  int i = 0;
  for (; i + UNROLL <= N; i += UNROLL) {
    float re[UNROLL], im[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      re[u] = xr[(long long)(i + u) * C];
      im[u] = xi[(long long)(i + u) * C];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      out[(long long)(i + u) * C] =
          voice_sample(st, re[u], im[u], gain, z1, b0);
  }
  for (; i < N; ++i)
    out[(long long)i * C] = voice_sample(st, xr[(long long)i * C],
                                         xi[(long long)i * C], gain, z1, b0);

  prev[2 * lane] = st.pr;
  prev[2 * lane + 1] = st.pi;
  y_last[lane] = st.yl;
  x_last[lane] = st.xl;
  power[lane] = (float)(st.pw / (double)N);
}

}  // namespace

extern "C" int fm_voice_launch(const void* y_re, const void* y_im,
                               void* prev, void* y_last, void* x_last,
                               void* audio, void* power, int S, int N, int C,
                               float gain, float z1, float b0, void* stream) {
  const long long lanes = (long long)S * C;
  if (lanes <= 0 || N <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  fm_voice_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)y_re, (const float*)y_im, (float*)prev, (float*)y_last,
      (float*)x_last, (float*)audio, (float*)power, S, N, C, gain, z1, b0);
  return (int)cudaGetLastError();
}
