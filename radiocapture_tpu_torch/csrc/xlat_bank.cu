// Fused xlat channelizer bank for Hopper (sm_90a): TMA-fed wgmma.
//
// Replaces radiocapture_tpu/ops/pallas_channelizer.py::bank_fused_pallas
// (its _fused_kernel, fused_tap_matrix and fused_rotation_tables).
//
// Per source s the bank is one real GEMM followed by the mixer rotation:
//
//   acc[n, :]  = z2[s][n*2D : n*2D + P*2D] . g2[s]          (bf16, f32 acc)
//   y[n, c]    = (acc[n, c] + i*acc[n, C+c]) * e^{i*theta}
//   theta      = (float)(phase0[s,c] + step[s,c]*n mod 2^32) * 2pi/2^32
//
// Window row n is P chunks of 2D values, and chunk q of row n is row n+q of
// Zb = z2[s] viewed as rows of 2D values. So, with W = 2D (rounded up to a
// multiple of 8 by the wrapper, which then zero-pads each row):
//
//   acc[n0:n0+BM, :] = sum_q Zb[n0+q : n0+q+BM, 0:W] . gk[:, q*W : (q+1)*W]^T
//
// Every A operand is rows n0+q .. n0+q+BM-1 of Zb: one TMA tensor map
// describes Zb ([S, rows, W], 3-D), and all P of them lie in the span of
// rows n0 .. n0+BM+P-2. gk is the tap matrix in K-major slot groups,
// [S, G, 128, P*W]: per group of 64 slots the re columns of its slots then
// their im columns, zero past C.
//
// Output: y_re, y_im time-major [S, N, C] float32.
//
// Bound: compute. At the C4FM bench shape (S=128, N=2500, D=96, P=15,
// C=64) the GEMM is 2*128*2500*2880*128 = 2.36e11 bf16 FLOP, 0.239 ms at
// 989 TFLOP/s, on 382 MB of operands and outputs (0.114 ms at 3.35 TB/s).
// The design, against what held the earlier wmma version at 4.5% of it:
//   - wgmma.mma_async m64n128k16 (the only path to Hopper's tensor-core
//     rate) on operands in 128-byte-swizzled shared memory;
//   - a block (BM = 128 rows, two consumer warpgroups of 64) covers all
//     128 GEMM columns of a 64-slot group, so a thread's accumulator holds
//     columns c and c+64 of a row, the re and im parts of slot c, and the
//     rotation is a per-thread epilogue (exact uint32 phase, one sincosf);
//   - the K loop runs over 64-column chunks of the rows and, within one,
//     over the window offsets q. One producer warp loads each chunk's span
//     (BM+P-1 rows) once with TMA, double-buffered, and keeps a 4-deep ring
//     of tap tiles full (cp.async.bulk.tensor + mbarrier complete_tx); the
//     consumers run 4 wgmma per tap tile on the span rows q .. q+BM-1 (the
//     swizzle follows the shared-memory address bits, so a descriptor can
//     start at any row) and release a tile once its wgmma group has
//     completed. The P shifted windows cost one span load, not P tiles;
//   - k16 slices past W are skipped (W = 96 at D = 48 fills 1.5 chunks);
//     TMA zero-fills rows past the source's data, columns past W (their tap
//     columns are zero-filled alike, so they add exactly 0) and slots past
//     C; stores are masked by N and C;
//   - the epilogue stages the rotated tile in the (then idle) span and tap
//     buffers, and each warp stores whole 128-byte row segments: the
//     per-thread layout of the accumulator would scatter 16-byte pieces;
//   - 105 KB of shared memory and 96 registers a thread let two blocks
//     share an SM, so one block's epilogue overlaps the other's main loop.
// Later levers: persistent blocks with TMA stores (the epilogue still
// stalls its own block), m64n256 instructions (each wgmma re-reads its
// operands from shared memory), cluster multicast of the tap tiles.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 2;             // warpgroups, 64 rows each
constexpr int BM = 64 * CONSUMERS;       // output rows per block
constexpr int SLOTS = 64;                // slots per block
constexpr int BN = 2 * SLOTS;            // GEMM columns per block
constexpr int BK = 64;                   // K per chunk: one 128-byte row
constexpr int STAGES = 4;                // tap tiles in flight
constexpr int SPANS = 2;                 // window spans in flight
constexpr int BOX_ROWS = 32;             // rows per span TMA box
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int B_BYTES = BN * BK * 2;
constexpr int BARRIER_BYTES = 2 * (STAGES + SPANS) * 8;
constexpr int STAGE_LD = SLOTS + 8;      // staged row stride, in floats

// Rows of a window span: the BM rows of the tile and the P-1 after them,
// rounded up to whole boxes.
__host__ __device__ __forceinline__ int span_rows(int P) {
  return (BM + P - 1 + BOX_ROWS - 1) / BOX_ROWS * BOX_ROWS;
}

// The spans and the tap-tile ring; after the main loop the same bytes
// stage the rotated output tile (re and im planes of each warpgroup's 64
// rows, rows STAGE_LD floats apart) for coalesced stores.
__host__ __device__ __forceinline__ int ring_bytes(int P) {
  const int loads = SPANS * span_rows(P) * BK * 2 + STAGES * B_BYTES;
  const int staged = CONSUMERS * 2 * 64 * STAGE_LD * 4;
  return loads > staged ? loads : staged;
}

__host__ __device__ __forceinline__ int smem_bytes(int P) {
  return ring_bytes(P) + BARRIER_BYTES + 1024;   // + room to align
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle TMA writes: 128-byte rows, 8-row atoms 1024 bytes apart. The
// swizzle is a function of the shared-memory address bits, so a window
// that starts at any row of a span (offset q) reads right with base
// offset 0 (a base offset of (addr >> 7) & 7 reads wrong rows; checked
// on an H100).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)        // start address
         | ((uint64_t)1 << 16)                    // leading offset (unused)
         | ((uint64_t)(1024 >> 4) << 32)          // stride offset
         | ((uint64_t)1 << 62);                   // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// d[64x128] += A[64x16] . B[128x16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// grid (ceil(N/BM), G, S); THREADS threads: warps 0 .. 4*CONSUMERS-1 are
// the consumer warpgroups, the last warp the producer. The K loop runs
// over chunks ch of 64 columns of the W-value rows, and within a chunk
// over window offsets q: step (ch, q) multiplies rows q .. q+BM-1 of span
// ch (rows n0 .. n0+BM+P-2 of Zb, columns 64ch .. 64ch+63) by tap tile
// (q, ch).
__global__ void __launch_bounds__(THREADS, 2)
xlat_bank_kernel(const __grid_constant__ CUtensorMap zmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const long long* __restrict__ phase0,
                 const long long* __restrict__ step,
                 float* __restrict__ y_re, float* __restrict__ y_im,
                 int N, int C, int P, int W) {
  extern __shared__ uint8_t smem_raw[];
  const int rows = span_rows(P);
  const uint32_t span_bytes = rows * BK * 2;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_s = base;                        // SPANS window spans
  const uint32_t b_s = a_s + SPANS * span_bytes;    // STAGES tap tiles
  const uint32_t full = base + ring_bytes(P);       // STAGES barriers
  const uint32_t empty = full + STAGES * 8;         // STAGES barriers
  const uint32_t a_full = empty + STAGES * 8;       // SPANS barriers
  const uint32_t a_empty = a_full + SPANS * 8;      // SPANS barriers

  const int n0 = blockIdx.x * BM;
  const int g = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int chunks = (W + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS);
    }
    for (int i = 0; i < SPANS; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // Producer: per chunk, its window span once, then its P tap tiles.
    if (threadIdx.x % 32 == 0) {
      const int grow = (s * gridDim.y + g) * BN;
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = 0; ch < chunks; ++ch) {
        const int sb = ch % SPANS;
        const uint32_t span = a_s + sb * span_bytes;
        mbar_wait(a_empty + 8 * sb, ((ch / SPANS) & 1) ^ 1);
        mbar_expect_tx(a_full + 8 * sb, span_bytes);
        for (int r = 0; r < rows; r += BOX_ROWS)
          tma_load_3d(span + r * BK * 2, &zmap, a_full + 8 * sb, ch * BK,
                      n0 + r, s);
        for (int q = 0; q < P; ++q) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, B_BYTES);
          tma_load_3d(b_s + stage * B_BYTES, &gmap, full + 8 * stage,
                      ch * BK, q, grow);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows n0 + 64*wg .. +63.
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int sb = ch % SPANS;
    const uint32_t span = a_s + sb * span_bytes + wg * 64 * BK * 2;
    const int k16 = min(BK, W - ch * BK + 15) / 16;   // slices with data
    mbar_wait(a_full + 8 * sb, (ch / SPANS) & 1);
    for (int q = 0; q < P; ++q) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a_row = span + q * BK * 2;        // window offset q
      const uint64_t db = sw128_desc(b_s + stage * B_BYTES);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // 16 values = 32 bytes = 2 units
        if (kk < k16)
          wgmma_m64n128k16(d, sw128_desc(a_row + 32 * kk), db + 2 * kk);
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();        // the previous step's group has completed
      if (leader && (ch > 0 || q > 0)) {
        mbar_arrive(empty + 8 * prev);
        if (q == 0) mbar_arrive(a_empty + 8 * ((ch - 1) % SPANS));
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(d);

  // Epilogue. Accumulator layout of m64nNk16: thread t of the warpgroup
  // holds rows 16*(t/32) + (t%32)/4 + {0, 8} and, per 8-column block b,
  // columns 8b + 2*(t%4) + {0, 1} in d[4b + 2*row_half + col]. Column c
  // (re of slot c) and c+64 (its im) are d[4b + ...] and d[4(b+8) + ...].
  // Each thread rotates its outputs into the staged tile; then each warp
  // stores whole rows of it, 128 contiguous bytes per instruction.
  asm volatile("bar.sync 1, %0;" :: "r"(CONSUMERS * 128) : "memory");
  float* stage_re = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw))) + wg * 2 * 64 * STAGE_LD;
  float* stage_im = stage_re + 64 * STAGE_LD;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;          // row in the 64
  const float kAngle = 1.4629180792671596e-09f;   // float32(2*pi / 2^32)
#pragma unroll
  for (int b = 0; b < SLOTS / 8; ++b) {
    const int c = g * SLOTS + 8 * b + 2 * (t % 4);
    uint32_t p0[2], st[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = c + j < C;
      p0[j] = in ? (uint32_t)phase0[(long long)s * C + c + j] : 0u;
      st[j] = in ? (uint32_t)step[(long long)s * C + c + j] : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t n = (uint32_t)(n0 + wg * 64 + r0 + 8 * h);
      float2 yr, yi;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float re = d[4 * b + 2 * h + j];
        const float im = d[4 * (b + SLOTS / 8) + 2 * h + j];
        float sn, cs;
        sincosf(__uint2float_rn(p0[j] + st[j] * n) * kAngle, &sn, &cs);
        (j ? yr.y : yr.x) = re * cs - im * sn;
        (j ? yi.y : yi.x) = re * sn + im * cs;
      }
      const int o = (r0 + 8 * h) * STAGE_LD + 8 * b + 2 * (t % 4);
      *reinterpret_cast<float2*>(stage_re + o) = yr;
      *reinterpret_cast<float2*>(stage_im + o) = yi;
    }
  }
  asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
  for (int r = (t / 32) * 16; r < (t / 32) * 16 + 16; ++r) {
    const int n = n0 + wg * 64 + r;
    if (n >= N) break;
    const long long o = ((long long)s * N + n) * C + g * SLOTS;
#pragma unroll
    for (int half = 0; half < SLOTS / 32; ++half) {
      const int cc = lane + 32 * half;
      if (g * SLOTS + cc < C) {
        y_re[o + cc] = stage_re[r * STAGE_LD + cc];
        y_im[o + cc] = stage_im[r * STAGE_LD + cc];
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor map, dims innermost first, 128-byte swizzle, zero fill
// out of bounds.
bool encode_3d(EncodeTiled enc, CUtensorMap* map, const void* ptr,
               cuuint64_t d0, cuuint64_t d1, cuuint64_t d2,
               cuuint64_t stride1_bytes, cuuint64_t stride2_bytes,
               cuuint32_t b0, cuuint32_t b1, cuuint32_t b2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1_bytes, stride2_bytes};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// zb: bf16 rows of W values, `rows` per source, sources z_stride values
// apart; gk: bf16 [S, ceil(C/64), 128, P*W]; phase0, step: int64 [S, C];
// y_re, y_im: float32 [S, N, C]. W and z_stride multiples of 8, zb and gk
// 16-byte aligned, rows >= N + P - 1. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for operands
// it does not take, cudaErrorNotSupported without the tensor-map encoder).
extern "C" int xlat_bank_launch(const void* zb, const void* gk,
                                const void* phase0, const void* step,
                                void* y_re, void* y_im, int S, int N, int P,
                                int W, int C, int rows, long long z_stride,
                                void* stream) {
  if (S <= 0 || N <= 0 || C <= 0) return (int)cudaSuccess;
  if (P <= 0 || W <= 0 || W % 8 || z_stride % 8 || rows < N + P - 1 ||
      (long long)rows * W > z_stride ||
      (reinterpret_cast<uintptr_t>(zb) | reinterpret_cast<uintptr_t>(gk)) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const int smem = smem_bytes(P);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int G = (C + SLOTS - 1) / SLOTS;
  CUtensorMap zmap, gmap;
  if (!encode_3d(enc, &zmap, zb, W, rows, S, 2ull * W, 2ull * z_stride, BK,
                 BOX_ROWS, 1) ||
      !encode_3d(enc, &gmap, gk, W, P, (cuuint64_t)S * G * BN, 2ull * W,
                 2ull * P * W, BK, 1, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      xlat_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BM - 1) / BM, G, S);
  xlat_bank_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      zmap, gmap, (const long long*)phase0, (const long long*)step,
      (float*)y_re, (float*)y_im, N, C, P, W);
  return (int)cudaGetLastError();
}

extern "C" const char* rc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
