// Complex-input xlat channelizer bank for Hopper (sm_90a), float32.
//
// Replaces radiocapture_tpu/ops/pallas_channelizer.py::bank_matmul_pallas
// (its _bank_kernel) and the rotation that follows it in
// ops/channelizer.py::XlatBank.__call__ (channelizer.py:164-171).
//
// Per source s, with z[s] the complex64 history ++ block and g[s] the
// correlation-reversed modulated taps [C, K]:
//
//   y[s, c, n] = e^{i*theta} * sum_k g[s, c, k] * z[s, n*D + k]
//   theta      = (float)(phase0[s,c] + step[s,c]*n mod 2^32) * 2pi/2^32
//
// Output: y [S, C, N] complex64, the JAX __call__ contract. Viewed as
// real it is the [S, 2, N, 2] layout SpectrumSplit2 hands on, so no
// transpose pass follows.
//
// Bound: memory at the shape the port sends here. SpectrumSplit2 has
// D=2, K=20 taps and C=2 slots: per output 20 complex taps x 2 slots
// (~320 FLOP) against 16 bytes in and 16 out, ~5 FLOP per byte moved,
// far under the f32 CUDA-core ridge. So the operands stay float32 with
// float32 accumulation (bf16 would save nothing here and would lose the
// precision the JAX __call__ keeps; the TPU kernel used bf16 only
// because f32 MXU operands are emulated in several passes), and the
// design reads each input sample from device memory once:
//   - a block owns BM consecutive outputs of one source and stages the
//     contiguous input span they need, (BM-1)*D + K complex samples, in
//     shared memory, then computes every slot of that source from it;
//   - consecutive threads take consecutive outputs of one slot, so the
//     tap load is a warp-wide broadcast (__ldg, L1-resident) and the
//     complex64 stores are coalesced;
//   - the exact uint32 phase is rotated in with one sincosf per output
//     (the epilogue of xlat_bank.cu).
// It is correct for any K, D, C and a ragged N: the launcher picks the
// largest BM whose span fits 48 KB of shared memory, and a tap count
// whose span alone exceeds that reads z straight from device memory.
// At wide C the kernel is bound by CUDA-core FMAs and shared loads
// (every slot re-reads the staged span); no port path sends wide-C
// complex input here: the pipelines take wire planes and xlat_bank.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM_MAX = 1024;
constexpr size_t SMEM_BYTES = 48 * 1024;

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
xlat_complex_kernel(const float2* __restrict__ z,
                    const float2* __restrict__ g,
                    const long long* __restrict__ phase0,
                    const long long* __restrict__ step,
                    float2* __restrict__ y, int N, int K, int D, int C,
                    long long z_len, int BM) {
  extern __shared__ float2 zs[];
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * BM;
  const int rows = min(BM, N - n0);
  const float2* zrow = z + (long long)s * z_len + (long long)n0 * D;
  if (STAGED) {
    const int span = (rows - 1) * D + K;
    for (int i = threadIdx.x; i < span; i += THREADS) zs[i] = zrow[i];
    __syncthreads();
  }
  const float2* gs = g + (long long)s * C * K;
  const float kAngle = 1.4629180792671596e-09f;   // float32(2*pi / 2^32)
  for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) {
    const int c = idx / rows;
    const int r = idx - c * rows;
    const float2* gc = gs + (long long)c * K;
    const float2* zw = STAGED ? zs + r * D : zrow + (long long)r * D;
    float ar = 0.0f, ai = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float2 gv = __ldg(gc + k);
      const float2 zv = STAGED ? zw[k] : __ldg(zw + k);
      ar = fmaf(gv.x, zv.x, ar);
      ar = fmaf(-gv.y, zv.y, ar);
      ai = fmaf(gv.x, zv.y, ai);
      ai = fmaf(gv.y, zv.x, ai);
    }
    const int n = n0 + r;
    const uint32_t u = (uint32_t)phase0[(long long)s * C + c]
                       + (uint32_t)step[(long long)s * C + c] * (uint32_t)n;
    float sn, cs;
    sincosf(__uint2float_rn(u) * kAngle, &sn, &cs);
    y[((long long)s * C + c) * N + n] =
        make_float2(ar * cs - ai * sn, ar * sn + ai * cs);
  }
}

}  // namespace

extern "C" int xlat_complex_launch(const void* z, const void* g,
                                   const void* phase0, const void* step,
                                   void* y, int S, int N, int K, int D,
                                   int C, long long z_len, void* stream) {
  if (K <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (S <= 0 || N <= 0 || C <= 0) return (int)cudaSuccess;
  const size_t per = sizeof(float2);
  int bm = BM_MAX;
  while (bm > 1 && ((size_t)(bm - 1) * D + K) * per > SMEM_BYTES) bm /= 2;
  const bool staged = ((size_t)(bm - 1) * D + K) * per <= SMEM_BYTES;
  if (!staged) bm = BM_MAX;
  dim3 grid((N + bm - 1) / bm, S);
  cudaStream_t st = (cudaStream_t)stream;
  if (staged) {
    const size_t smem = ((size_t)(bm - 1) * D + K) * per;
    xlat_complex_kernel<true><<<grid, THREADS, smem, st>>>(
        (const float2*)z, (const float2*)g, (const long long*)phase0,
        (const long long*)step, (float2*)y, N, K, D, C, z_len, bm);
  } else {
    xlat_complex_kernel<false><<<grid, THREADS, 0, st>>>(
        (const float2*)z, (const float2*)g, (const long long*)phase0,
        (const long long*)step, (float2*)y, N, K, D, C, z_len, bm);
  }
  return (int)cudaGetLastError();
}
