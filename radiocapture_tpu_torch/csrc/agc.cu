// The CQPSK feedforward AGC gain in one reduction, for Hopper (sm_90a):
// scale[s, c] = 1 / max(sqrt(mean_n(re^2 + im^2)), 1e-9) over the
// time-major [S, N, C] float32 bank planes.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses
// radiocapture_tpu/demod/cqpsk.py::block_agc (:261-266) into the CQPSK
// step under jit; eager PyTorch ran demod/cqpsk.py::agc_scale (the plain
// version, kept) as hypot, pow and mean: three passes over the planes.
//
// Bound: bytes. At the split2 -> CQPSK bench shape (256 halves x 2500
// samples x 64 slots) the planes are 328 MB, read once: ~0.098 ms at
// 3.35 TB/s. A block takes 32 neighbouring slots of one source and 16 row
// groups: thread (x, y) sums the rows y, y + 16, ... of slot x, four rows'
// loads in flight at a time, so each warp reads 128 contiguous bytes of a
// row of each plane per load. The 16 partial sums of a slot are added in
// shared memory by a fixed tree. Every sum is float32 in a fixed order, so
// a run repeats bit for bit; the order is not the plain version's, whose
// bound against this kernel chip_smoke.py states.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;   // slots per block: one warp across a row
constexpr int ROWS = 16;   // row groups per block
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(COLS * ROWS)
agc_kernel(const float* __restrict__ y_re, const float* __restrict__ y_im,
           float* __restrict__ scale, int N, int C, int tiles) {
  __shared__ float part[ROWS][COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int s = blockIdx.x / tiles;
  const int c = (blockIdx.x - s * tiles) * COLS + tx;
  float acc = 0.f;
  if (c < C) {
    const long long base = (long long)s * N * C + c;
    int n = ty;
    for (; n + (UNROLL - 1) * ROWS < N; n += UNROLL * ROWS) {
      float re[UNROLL], im[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + (long long)(n + u * ROWS) * C;
        re[u] = y_re[i];
        im[u] = y_im[i];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc = __fmaf_rn(im[u], im[u], __fmaf_rn(re[u], re[u], acc));
    }
    for (; n < N; n += ROWS) {
      const long long i = base + (long long)n * C;
      const float re = y_re[i], im = y_im[i];
      acc = __fmaf_rn(im, im, __fmaf_rn(re, re, acc));
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
#pragma unroll
  for (int half = ROWS / 2; half > 0; half /= 2) {
    if (ty < half) part[ty][tx] = __fadd_rn(part[ty][tx], part[ty + half][tx]);
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    const float rms = __fsqrt_rn(__fdiv_rn(part[0][tx], (float)N));
    // torch.clamp_min keeps a NaN
    const float r = rms < 1e-9f ? 1e-9f : rms;
    scale[(long long)s * C + c] = __fdiv_rn(1.0f, r);
  }
}

}  // namespace

// y_re, y_im [S, N, C] float32 -> scale [S, C] float32.
extern "C" int agc_launch(const void* y_re, const void* y_im, void* scale,
                          int S, int N, int C, void* stream) {
  if (S < 0 || N < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return (int)cudaSuccess;
  const int tiles = (C + COLS - 1) / COLS;
  if ((long long)S * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  agc_kernel<<<(unsigned)(S * tiles), dim3(COLS, ROWS), 0,
               (cudaStream_t)stream>>>((const float*)y_re,
                                       (const float*)y_im, (float*)scale, N,
                                       C, tiles);
  return (int)cudaGetLastError();
}
