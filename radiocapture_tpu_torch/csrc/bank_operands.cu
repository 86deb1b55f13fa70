// The wire bank's operands in one launch, for Hopper (sm_90a): the z2 row
// buffer, the slot-group tap matrix and the uint32 phase step that
// csrc/xlat_bank.cu reads.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses this work into
// the surrounding ops under jit (radiocapture_tpu/ops/channelizer.py,
// XlatBank.call_wire:195-224: the factorized phasor build, the tap matrix,
// the history ++ block concatenation); eager PyTorch ran it op by op, each
// op one pass over ~94-246 MB at the bench shapes
// (ops/channelizer.py::XlatBank.operands_plain, whose CUDA branch is the
// plain version this kernel is held to bit for bit).
//
// Bound: bytes. At the C4FM bench shape (128 sources x 240000 bf16
// samples, K = 1440 taps, 64 slots) z2 reads ~123 MB and writes ~124 MB
// and the taps write ~94 MB: ~0.10 ms at 3.35 TB/s. The taps' arithmetic
// is one complex multiply, one real-by-complex multiply and two bf16
// roundings per tap and slot; their sin/cos are C (P + D) pairs per source,
// not C K, from the factorized phasor.
//
// Two kinds of block in one grid, the tap blocks spread evenly among the
// row blocks so that their sin/cos table builds overlap the rows' stream:
// - Tap blocks: one per (source, 64-slot group, chunk of SC slots). The
//   block computes e^{j a_c (P-1-q) D} and
//   e^{j a_c (D-1-j)} for its slots into shared memory (a_c = 2pi f_c),
//   then each thread takes 4 consecutive taps of one window chunk of one
//   slot and writes them as one 16-byte vector into the slot's re row and
//   one into its im row of the [S, G, 128, P W] layout
//   (ops/channelizer_kernel.py::kernel_tap_matrix); threads in a row write
//   neighbouring vectors. Slots past C and the W - 2D pad values are zero.
//   The block's first threads also write its slots' phase step.
// - Row blocks: each thread writes 4 samples (16 bytes) of the flat z2
//   [S, K + T] bf16 re/im pairs: history (complex64) for the first K - 1
//   samples of a source, the block x2 (bf16 copied, or float32 rounded)
//   for the next T, one zero sample last.
//
// Rounding, pinned to the eager CUDA path (ROADMAP hazard "Rounding"):
// a = 2pi_f32 * f and the angle a * (P-1-q) D are two float32 products
// (two PyTorch multiplies, no fma); sinf/cosf as torch.sin/torch.cos;
// the phasor product (a + bi)(c + di) as PyTorch's CUDA complex multiply
// contracts it, fma(a, c, -(b d)) and fma(a, d, b c); the tap h times the
// phasor as complex(h, 0) times it, the same contraction; one
// round-to-nearest-even to bf16 (__float2bfloat16_rn, as .to(bfloat16)).
// The phase step is ops/fir.py::phase_step_u32: fmodf(-f * D, 1), plus 1
// where negative, times 2^32, truncated to int64 and clamped to uint32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOT_GROUP = 64;   // slots per tap group (xlat_bank.cu)
constexpr int SC = 8;            // slots per tap block
constexpr int THREADS = 256;
constexpr float TWO_PI = 6.283185482025146484375f;   // float32(2 pi)
constexpr float PHASE_SCALE = 4294967296.0f;         // 2^32

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(float re, float im) {
  return bf16_bits(re) | (bf16_bits(im) << 16);
}

// One bf16 re/im pair of x2 as its packed bits (re in the low half).
__device__ __forceinline__ uint32_t wire_sample(const __nv_bfloat16* x,
                                                long long i) {
  return reinterpret_cast<const uint32_t*>(x)[i];
}

__device__ __forceinline__ uint32_t wire_sample(const float* x,
                                                long long i) {
  const float2 v = reinterpret_cast<const float2*>(x)[i];
  return pack(v.x, v.y);
}

template <typename In>
__device__ void z2_rows(const float2* __restrict__ hist,
                        const In* __restrict__ x, uint32_t* __restrict__ z2,
                        int S, int T, int K, long long vec) {
  const long long L = (long long)K + T;     // samples per source row
  const long long total = (long long)S * L;
  const long long i0 = vec * 4;
  if (i0 >= total) return;
  // a 64-bit division costs several times a 32-bit one
  long long s = total <= 0xFFFFFFFFLL
      ? (long long)((unsigned)i0 / (unsigned)L) : i0 / L;
  long long pos = i0 - s * L;
  uint32_t out[4];
  const int count = total - i0 < 4 ? (int)(total - i0) : 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0u;
    if (k < count) {
      if (pos < K - 1) {
        const float2 h = hist[s * (K - 1) + pos];
        v = pack(h.x, h.y);
      } else if (pos < K - 1 + T) {
        v = wire_sample(x, s * T + (pos - (K - 1)));
      }
      if (++pos == L) {
        pos = 0;
        ++s;
      }
    }
    out[k] = v;
  }
  if (count == 4) {
    reinterpret_cast<uint4*>(z2)[vec] = make_uint4(out[0], out[1], out[2],
                                                   out[3]);
  } else {
    for (int k = 0; k < count; ++k) z2[i0 + k] = out[k];
  }
}

__device__ void tap_block(const float* __restrict__ offs,
                          const float* __restrict__ taps,
                          __nv_bfloat16* __restrict__ g2,
                          long long* __restrict__ step, int blk, int C,
                          int P, int D, int W, float2* smem) {
  const int chunks = SLOT_GROUP / SC;
  const int G = (C + SLOT_GROUP - 1) / SLOT_GROUP;
  const int chunk = blk % chunks;
  const int grp = (blk / chunks) % G;
  const int s = blk / (chunks * G);
  const int slot0 = grp * SLOT_GROUP + chunk * SC;
  const int K = P * D;
  float2* tab_q = smem;                 // [SC][P]: e^{j a (P-1-q) D}
  float2* tab_j = smem + SC * P;        // [SC][D]: e^{j a (D-1-j)}

  for (int e = threadIdx.x; e < SC * (P + D); e += blockDim.x) {
    const int sl = e / (P + D);
    const int r = e - sl * (P + D);
    const int c = slot0 + sl;
    float2 v = make_float2(0.f, 0.f);
    if (c < C) {
      const float a = __fmul_rn(TWO_PI, offs[(long long)s * C + c]);
      const float ang = r < P ? __fmul_rn(a, (float)((P - 1 - r) * D))
                              : __fmul_rn(a, (float)(D - 1 - (r - P)));
      v = make_float2(cosf(ang), sinf(ang));
    }
    if (r < P) tab_q[sl * P + r] = v;
    else tab_j[sl * D + (r - P)] = v;
  }
  if (threadIdx.x < SC && slot0 + (int)threadIdx.x < C) {
    const int c = slot0 + threadIdx.x;
    float m = fmodf(__fmul_rn(-offs[(long long)s * C + c], (float)D), 1.0f);
    if (m != 0.f && m < 0.f) m = __fadd_rn(m, 1.0f);
    long long u = (long long)__fmul_rn(m, PHASE_SCALE);
    u = u < 0 ? 0 : (u > 0xFFFFFFFFll ? 0xFFFFFFFFll : u);
    step[(long long)s * C + c] = u;
  }
  __syncthreads();

  const int vw = W / 8;                 // 16-byte vectors per window chunk
  const long long row = (long long)P * W;
  // row r of the group: r < 64 the re column of slot 64 grp + r, else the
  // im column of slot 64 grp + r - 64
  uint4* base = reinterpret_cast<uint4*>(
      g2 + ((long long)s * G + grp) * (2 * SLOT_GROUP) * row);
  for (int e = threadIdx.x; e < SC * P * vw; e += blockDim.x) {
    const int v = e % vw;
    const int q = (e / vw) % P;
    const int sl = e / (vw * P);
    const int c = slot0 + sl;
    uint32_t re_row[4], im_row[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * v + t;
      re_row[t] = 0u;
      im_row[t] = 0u;
      if (c < C && j < D) {
        const float2 A = tab_q[sl * P + q];
        const float2 B = tab_j[sl * D + j];
        const float pr = __fmaf_rn(A.x, B.x, -__fmul_rn(A.y, B.y));
        const float pi = __fmaf_rn(A.x, B.y, __fmul_rn(A.y, B.x));
        const float h = taps[K - 1 - (q * D + j)];
        const float gr = __fmaf_rn(h, pr, -__fmul_rn(0.f, pi));
        const float gi = __fmaf_rn(h, pi, __fmul_rn(0.f, pr));
        const uint32_t br = bf16_bits(gr), bi = bf16_bits(gi);
        re_row[t] = br | ((bi ^ 0x8000u) << 16);    // (g_re, -g_im)
        im_row[t] = bi | (br << 16);                // (g_im, g_re)
      }
    }
    const long long off = (q * (long long)W) / 8 + v;
    const int r = slot0 - grp * SLOT_GROUP + sl;
    base[(r * row) / 8 + off] = make_uint4(re_row[0], re_row[1], re_row[2],
                                           re_row[3]);
    base[((r + SLOT_GROUP) * row) / 8 + off] = make_uint4(
        im_row[0], im_row[1], im_row[2], im_row[3]);
  }
}

template <typename In>
__global__ void __launch_bounds__(THREADS)
bank_operands_kernel(const float2* __restrict__ hist,
                     const In* __restrict__ x,
                     const float* __restrict__ offs,
                     const float* __restrict__ taps,
                     uint32_t* __restrict__ z2,
                     __nv_bfloat16* __restrict__ g2,
                     long long* __restrict__ step, int S, int T, int C,
                     int P, int D, int W, int taps_blocks, int stride) {
  extern __shared__ float2 smem[];
  // block b is tap block b / stride when stride divides it (the first
  // taps_blocks such b), else row block b less the tap blocks before it
  const int b = blockIdx.x;
  const int tap = b / stride;
  if (b % stride == 0 && tap < taps_blocks) {
    tap_block(offs, taps, g2, step, tap, C, P, D, W, smem);
  } else {
    const int before = tap + 1 < taps_blocks ? tap + 1 : taps_blocks;
    const long long vec = (long long)(b - before) * THREADS + threadIdx.x;
    z2_rows(hist, x, z2, S, T, P * D, vec);
  }
}

template <typename In>
int launch(const void* hist, const void* x, const void* offs,
           const void* taps, void* z2, void* g2, void* step, int S, int T,
           int C, int P, int D, int W, int parts, cudaStream_t stream) {
  const int G = (C + SLOT_GROUP - 1) / SLOT_GROUP;
  const long long taps_blocks = parts & 1
      ? (long long)S * G * (SLOT_GROUP / SC) : 0;
  const long long samples = (long long)S * ((long long)P * D + T);
  const long long row_blocks = parts & 2
      ? (samples + 4LL * THREADS - 1) / (4LL * THREADS) : 0;
  const long long blocks = taps_blocks + row_blocks;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const long long stride = taps_blocks ? blocks / taps_blocks : 1;
  const size_t shared = sizeof(float2) * SC * (size_t)(P + D);
  auto kernel = bank_operands_kernel<In>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, THREADS, shared, stream>>>(
      (const float2*)hist, (const In*)x, (const float*)offs,
      (const float*)taps, (uint32_t*)z2, (__nv_bfloat16*)g2,
      (long long*)step, S, T, C, P, D, W, (int)taps_blocks, (int)stride);
  return (int)cudaGetLastError();
}

}  // namespace

// hist [S, K-1] complex64, x [S, T, 2] bf16 (x_bf16) or float32,
// offs [S, C] float32, taps [K] float32 (K = P D) -> z2 [S, (K+T) 2] bf16,
// g2 [S, G, 128, P W] bf16, step [S, C] int64. W is a multiple of 8 no
// less than 2D. parts: 3 writes all three; 1 only g2 and step, 2 only z2
// (a measurement aid: each part's time alone).
extern "C" int bank_operands_launch(const void* hist, const void* x,
                                    const void* offs, const void* taps,
                                    void* z2, void* g2, void* step, int S,
                                    int T, int C, int P, int D, int W,
                                    int x_bf16, int parts, void* stream) {
  if (S < 0 || C < 0 || P <= 0 || D <= 0 || T < 0 || W % 8 != 0
      || W < 2 * D || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? launch<__nv_bfloat16>(hist, x, offs, taps, z2, g2, step,
                                        S, T, C, P, D, W, parts, st)
                : launch<float>(hist, x, offs, taps, z2, g2, step, S, T, C,
                                P, D, W, parts, st);
}
