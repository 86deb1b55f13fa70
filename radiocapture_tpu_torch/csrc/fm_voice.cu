// Fused analog voice tracker for Hopper (sm_90a): quadrature
// discriminator -> 75 us de-emphasis IIR -> squelch power meter, for every
// (source, slot) lane of the bank output.
//
// Replaces the chain after the bank in
// radiocapture_tpu/frontend/pipeline.py (AnalogVoicePipeline._step_impl,
// pipeline.py:420-423): ops/fm.py::quadrature_demod, the
// ops/fm.py::fm_deemphasis / first_order_iir lax.associative_scan
// (fm.py:44-84) and the power meter mean(|chan|^2).
//
// Bound: bytes. At the bench shape (8192 lanes x 2500 samples) the kernel
// reads ~164 MB and writes ~82 MB, ~0.073 ms at 3.35 TB/s. Only the IIR
// y[n] = z1 y[n-1] + b0 (d[n] + d[n-1]) is a recurrence, and a linear one:
// the discriminator d[n] of each sample depends only on the input. One
// thread per lane (8192 threads, ~2 warps per SM) kept too few loads in
// flight to reach the bytes bound. The design spreads each lane over
// time as well:
//
// - A block owns a tile of TILE neighbouring slots of one source, so each
//   time step of the tile is one 128-byte row of each time-major [S, N, C]
//   plane; the grid is S x ceil(C / TILE) blocks (256 at the bench shape,
//   about two per SM), lanes past C masked.
// - The block walks the block's samples in time tiles of SPAN = WARPS x
//   CHUNK samples. In each, warp w takes the CHUNK samples starting at
//   n0 = tile start + w CHUNK for the tile's slots: it issues the loads of
//   all of them (and of the two samples before, for the discriminator
//   value before n0) at once, computes the discriminator of each, and runs
//   the IIR over its chunk from a zero start, v[k] = z1 v[k-1] + b0 u[k],
//   in registers. The value before n0 is that thread's own discriminator
//   of the two samples before (L1/L2 hits), or the lane state's x_last at
//   n = 0; the sample before n = 0 is the lane state's prev.
// - The chunk's end v[CHUNK-1] goes to shared memory. After one
//   __syncthreads each thread forms its chunk's incoming output Y_in from
//   the tile's carried output and the preceding chunks' ends, through
//   A = z1^CHUNK, in chunk order, and writes y[k] = v[k] + z1^(k+1) Y_in.
//   Every thread then runs the same chain over all WARPS ends to the
//   output carried into the next tile, so every warp holds the same carry
//   bit for bit. The ends are double-buffered by tile parity, so one
//   barrier per tile suffices. Samples past N are loaded as zero and never
//   stored.
// - Power: each thread sums |x|^2 over its chunk in float and adds the
//   chunk's sum to a double; the sums are reduced per slot across the
//   warps in warp order at the end and divided by N.
// - Carried state: every thread reads the lane state before the first
//   barrier; after the last one the thread that owns sample N-1 writes
//   prev = x[N-1], x_last = d[N-1] (computed again, the same operations)
//   and y_last = y[N-1] (its own store, read back).
// - Chunks wholly inside [0, N) of active lanes load and store without
//   bounds checks; the others mask each sample.
//
// H100 (tools/voice_variants.py): CHUNK 8-16 with WARPS 12-16 time within
// ~4% of each other, one block per SM ~35% slower, and the kernel with
// atan2f replaced by a product (wrong, a probe) only ~7% faster: what is
// left above the bytes bound is the memory pipeline, not the arithmetic.
// ptxas caps the 512-thread block at 64 registers for two blocks per SM
// (a few dozen bytes of spill).
//
// The discriminator's complex multiply (a*c - b*d, a*d + b*c with
// b = conj(prev)) is pinned to PyTorch's CUDA rounding with __fmaf_rn /
// __fmul_rn, as csrc/fsk_track.cu's discriminator is, and so is the gain
// product: d[n], and with it the carried x_last, equal the plain
// version's bit for bit. The IIR is evaluated in another association
// order than the plain doubling scan (as the JAX associative_scan is);
// with |z1| < 1 the rounding does not grow along the block. Built without
// fast math, as the other trackers.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                 // slots per block: one warp wide
constexpr int CHUNK = 16;                // samples per thread per time tile
constexpr int WARPS = 16;                // chunks per time tile
constexpr int SPAN = CHUNK * WARPS;      // samples per time tile
constexpr int THREADS = TILE * WARPS;

struct Powers {
  float p[CHUNK];                        // p[k] = z1^(k+1)
};

// gain * arg(x * conj(prev)), each product rounded as PyTorch's complex
// multiply and its scalar multiply round them on CUDA.
__device__ __forceinline__ float discriminator(float are, float aim,
                                               float pr, float pi,
                                               float gain) {
  const float dre = __fmaf_rn(are, pr, -__fmul_rn(aim, -pi));
  const float dim = __fmaf_rn(are, -pi, __fmul_rn(aim, pr));
  return __fmul_rn(gain, atan2f(dim, dre));
}

__global__ void __launch_bounds__(THREADS, 2)
fm_voice_kernel(const float* __restrict__ y_re,
                const float* __restrict__ y_im, float* __restrict__ prev,
                float* __restrict__ y_last, float* __restrict__ x_last,
                float* __restrict__ audio, float* __restrict__ power, int N,
                int C, int tiles, float gain, float b0, const Powers zp) {
  __shared__ float ends[2][WARPS][TILE];
  __shared__ double sums[WARPS][TILE];
  const int warp = threadIdx.x / TILE;
  const int lane = threadIdx.x % TILE;
  const int s = blockIdx.x / tiles;
  const int c = (blockIdx.x % tiles) * TILE + lane;
  const bool active = c < C;
  const long long li = (long long)s * C + c;          // lane index
  const long long in0 = (long long)s * N * C + c;
  const float* xr = y_re + in0;
  const float* xi = y_im + in0;
  float* out = audio + in0;
  const float z1 = zp.p[0];
  const float a = zp.p[CHUNK - 1];                     // z1^CHUNK

  float pr0 = 0.0f, pi0 = 0.0f, carry = 0.0f, xl0 = 0.0f;
  if (active) {
    pr0 = prev[2 * li];
    pi0 = prev[2 * li + 1];
    carry = y_last[li];
    xl0 = x_last[li];
  }
  double acc = 0.0;
  const int n_tiles = (N + SPAN - 1) / SPAN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * SPAN + warp * CHUNK;
    // x[n0-2 .. n0+CHUNK-1]; x[-1] is the carried prev sample
    float ar[CHUNK + 2], ai[CHUNK + 2];
    const long long row0 = (long long)(n0 - 2) * C;
    if (active && n0 >= 2 && n0 + CHUNK <= N) {
#pragma unroll
      for (int j = 0; j < CHUNK + 2; ++j) {
        ar[j] = xr[row0 + j * C];
        ai[j] = xi[row0 + j * C];
      }
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK + 2; ++j) {
        const int k = n0 - 2 + j;
        const bool ok = active && k >= 0 && k < N;
        ar[j] = ok ? xr[row0 + j * C] : 0.0f;
        ai[j] = ok ? xi[row0 + j * C] : 0.0f;
      }
      if (n0 == 0) {
        ar[1] = pr0;
        ai[1] = pi0;
      }
    }
    float dprev = n0 == 0 ? xl0
                          : discriminator(ar[1], ai[1], ar[0], ai[0], gain);
    float v[CHUNK];
    float vk = 0.0f, pw = 0.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float re = ar[j + 2], im = ai[j + 2];
      const float d = discriminator(re, im, ar[j + 1], ai[j + 1], gain);
      vk = __fmaf_rn(z1, vk, __fmul_rn(b0, __fadd_rn(d, dprev)));
      v[j] = vk;
      dprev = d;
      pw = __fmaf_rn(re, re, __fmaf_rn(im, im, pw));
    }
    acc += (double)pw;
    float (*e)[TILE] = ends[t & 1];
    e[warp][lane] = vk;
    __syncthreads();
    float yin = carry;
    for (int w = 0; w < warp; ++w) yin = __fmaf_rn(a, yin, e[w][lane]);
    float next = yin;
    for (int w = warp; w < WARPS; ++w) next = __fmaf_rn(a, next, e[w][lane]);
    carry = next;
    float* o = out + (long long)n0 * C;
    if (active && n0 + CHUNK <= N) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) o[j * C] = __fmaf_rn(zp.p[j], yin, v[j]);
    } else if (active) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (n0 + j < N) o[j * C] = __fmaf_rn(zp.p[j], yin, v[j]);
    }
  }

  sums[warp][lane] = acc;
  __syncthreads();
  if (!active) return;
  if (warp == 0) {
    double tot = 0.0;
    for (int w = 0; w < WARPS; ++w) tot += sums[w][lane];
    power[li] = (float)(tot / (double)N);
  }
  if (warp == ((N - 1) % SPAN) / CHUNK) {
    // owns sample N-1: its output (this thread's own store) and the
    // discriminator of x[N-1] computed again, the same operations
    const long long last = (long long)(N - 1) * C;
    const float re = xr[last], im = xi[last];
    const float qr = N > 1 ? xr[last - C] : pr0;
    const float qi = N > 1 ? xi[last - C] : pi0;
    prev[2 * li] = re;
    prev[2 * li + 1] = im;
    x_last[li] = discriminator(re, im, qr, qi, gain);
    y_last[li] = out[last];
  }
}

}  // namespace

// chunk and warps are the caller's copy of CHUNK and WARPS: a caller whose
// plan differs from the one built here is refused.
extern "C" int fm_voice_launch(const void* y_re, const void* y_im,
                               void* prev, void* y_last, void* x_last,
                               void* audio, void* power, int S, int N, int C,
                               float gain, float z1, float b0, int chunk,
                               int warps, void* stream) {
  if (chunk != CHUNK || warps != WARPS) return (int)cudaErrorInvalidValue;
  if (S <= 0 || C <= 0 || N <= 0) return (int)cudaSuccess;
  Powers zp;
  double zk = 1.0;
  for (int k = 0; k < CHUNK; ++k) {
    zk *= (double)z1;
    zp.p[k] = (float)zk;
  }
  const int tiles = (C + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)S * (unsigned)tiles;
  fm_voice_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)y_re, (const float*)y_im, (float*)prev, (float*)y_last,
      (float*)x_last, (float*)audio, (float*)power, N, C, tiles, gain, b0,
      zp);
  return (int)cudaGetLastError();
}
