// The pfb frontend's fine stage for Hopper (sm_90a), float32: a mixer
// plus one real-tap filter for every slot.
//
// Replaces no Pallas kernel: the JAX PfbXlatBank runs its fine stage as
// vmap(freq_xlating_fir) under jit (radiocapture_tpu/ops/channelizer.py:
// 351-366, ops/fir.py:117-143): each slot's K taps, the one real
// prototype h modulated to the slot's fine offset f, correlated with its
// bin's samples, then rotated by the exact uint32 mixer phase. The port
// ran that form on csrc/xlat_complex.cu's narrow plan, 4 FMAs a tap.
// Because every slot's taps are h modulated by its f, with z = history
// ++ the bin's samples, m = n*D + k and sigma = round(f * 2^32) (uint32):
//
//   y[n] = e^{i th(n)} sum_k h[K-1-k] e^{i 2pi f (K-1-k)} z[m]
//        = e^{i v(n)} sum_k h[K-1-k] w[m],  w[m] = z[m] e^{-i 2pi sigma m / 2^32}
//   th(n) = phase0 + step*n,   v(n) = th(n) + sigma*(n*D + K-1)   (mod 2^32)
//
// so each sample is mixed once for its slot (one complex multiply by the
// phasor of an exact uint32 phase), the filter takes 2 FMAs a tap (re and
// im apart), and the per-output factor folds into the rotation the bank
// already applied. Only the rounding differs from the modulated taps:
// sigma moves a tap's angle by at most 2pi * 2^-33 * (K-1), less than the
// float32 rounding of the modulated taps' angles 2pi*f*k.
//
// Bound: float32 FMAs. At the bench shape (8192 slot rows x 2500 outputs,
// K = 467, D = 16) the filter is 9.56e9 taps x 4 FLOP (0.571 ms at 67
// TFLOP/s), the mixing about 12 FLOP a sample more (8192 x 40466
// samples). The bins are read once from device memory; L2 and shared
// memory are the other limits, so the design stages a bin's span once for
// the slots that share it and spends as few shared-memory bytes per FMA
// as its registers allow:
//
//   - a block takes one tile of NB = 8*WP*O outputs of rb consecutive
//     slot rows, one row after another. Bulk copies (cp.async.bulk, an
//     mbarrier) stage the row's span as rows of D samples (row m = z[z0 +
//     m*D .. + D), 128 bytes), history and bin read in place through the
//     row index: the bin's part only where the row's bin is not the one
//     staged, the history's part for every row. The next row's copy is
//     issued once this row is mixed, so it lands during this row's filter;
//   - the block mixes the span into a second buffer, eight threads a row
//     (one 16-byte chunk each): each sample's phasor is the thread's base
//     phasor (its samples' phases, exact in uint32) times a row step from
//     a table of exact uint32 phases, and each row is written as its D
//     real parts in one half and its D imaginary parts in the other, the
//     halves swapped on odd rows (the two rows a half warp stores, and
//     the two a quarter warp loads, O odd rows apart, fall on both
//     halves of the banks);
//   - WP warps take the real parts and WP the imaginary parts of the
//     same outputs. Four lanes share O consecutive outputs, each taking 4
//     of a row's D planes (one 16-byte chunk): a lane keeps a window of O
//     rows of its 4 planes in registers and walks the tap rows q (tap row
//     q feeds output r from row q + r), loading one chunk of the entering
//     row and one of the row's taps (reversed, zero past K) a tap row
//     against 4*O FMAs. Two shuffles sum the four lanes' partial sums of
//     each output;
//   - the two parts meet in shared memory, in a box of G = 3 rows'
//     sums; once a group of G consecutive rows is filtered, each of its
//     outputs is rotated once by the phasor of v(n) and stored straight
//     into the trackers' time-major float32 planes y_re, y_im [S/C, N,
//     C]: row s is slot s % C of source s / C, so a time step's G slots
//     are one run of consecutive floats (two where the group straddles
//     two sources), and a row's own outputs C floats apart. A run
//     costs about what a lone float does (one write request to L2; a TMA
//     tensor store of 4-slot runs cost what threads' stores do): row by
//     row the planes took 0.22 ms more of the bench's 1.41 than whole
//     complex rows, in runs of 3 slots 0.07 (H100). A box of all 16 rows
//     leaves an SM two blocks (1.66 ms); runs of 4 need the taps out of
//     shared memory, and read from constant memory or through L1 they
//     slow the filter by what the runs save. G = 3 is the most the third
//     block's shared memory holds.
//
// O is small (15, a divisor of the 30 tap rows of K = 467): larger
// windows ran slower on an H100, for the warps their registers cost; three
// blocks share an SM (shared memory), so one block's mixing and copies
// overlap another's filter. The filter's loads are issued a tap row
// ahead: taps padded to whole groups of O leave no bounds check inside a
// group to stop the compiler hoisting them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAngle = 1.4629180792671596e-09f;   // float32(2*pi / 2^32)
constexpr int FINE_D = 16;        // samples a row: the decimation
constexpr int ROW = 2 * FINE_D;   // floats a staged row (128 bytes)
constexpr int PLANES = 4;         // planes (samples of a row) a lane takes
constexpr int LANES = FINE_D / PLANES;   // lanes that share an output
constexpr int FINE_O = 15;        // outputs a lane group
constexpr int FINE_WP = 2;        // warps a part (real or imaginary)
constexpr int FINE_NT = FINE_WP * 64;     // threads a block
constexpr int FINE_NB = FINE_WP * (32 / LANES) * FINE_O;   // outputs a tile
constexpr int FINE_BLOCKS = 3;    // blocks an SM holds (shared memory)
constexpr int MIX_THREADS = 8;    // threads a row in the mixing pass
constexpr int FINE_G = 3;         // slot rows a store group
static_assert(ROW * (int)sizeof(float) == 128, "a row spans the banks once");
static_assert(FINE_O % 2 == 1, "O odd: groups O rows apart, both halves");
static_assert(PLANES == 4 && MIX_THREADS == 8, "16-byte chunks");

// (cos, sin) of the uint32 phase u's float32 angle, as ops/fir.py rotate
__device__ __forceinline__ float2 cis(uint32_t u) {
  float sn, cs;
  sincosf(__uint2float_rn(u) * kAngle, &sn, &cs);
  return make_float2(cs, sn);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
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

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The physical 16-byte chunk of row m's part p (0 real, 1 imaginary),
// planes 4h .. 4h+3: the row's real parts fill one half, its imaginary
// parts the other, the halves swapped on odd rows, so the two lane groups
// of a quarter warp (O rows apart, O odd) read both halves, and the two
// rows a half warp mixes store both halves.
__device__ __forceinline__ int chunk(int m, int p, int h) {
  return 4 * (p ^ (m & 1)) + h;
}

// The block's shared memory in bytes at qp tap rows (Q rounded up to
// whole groups of O): the raw span and the mixed rows (NB + qp - 1 rows
// of 128 bytes each), the taps (qp rows of D), the mixer's row steps, the
// copies' mbarrier, and for a store group's G rows their planes' offsets,
// phase0, step and sigma and the two parts' sums (2 x NB x G).
__host__ __device__ constexpr int fine_bytes(int nb, int qp, int rstride) {
  return 2 * (nb + qp - 1) * ROW * (int)sizeof(float)
         + qp * FINE_D * (int)sizeof(float)
         + (nb + qp - 1 + rstride - 1) / rstride * (int)sizeof(float2)
         + (int)sizeof(unsigned long long)
         + FINE_G * ((int)sizeof(long long) + 3 * (int)sizeof(uint32_t))
         + 2 * nb * FINE_G * (int)sizeof(float);
}

// Rotate and store the outputs of a group of g <= FINE_G filtered rows:
// box [2][NB][FINE_G] their two parts' sums, at[j] the planes' offset of
// row j's output n0, rsc its phase0, step and sigma ([3][FINE_G]). The g
// rows' values of one time step are consecutive threads' and consecutive
// floats. g is a template parameter, reached from the group's row count
// at run time: dividing by a run-time g cost the kernel 2% on an H100 at
// 8192, 256 and 64 rows, and stepping by FINE_G with the slots past g
// idle 2.5% at 256 rows.
template <int G>
__device__ __forceinline__ void store_group(
    const float* box, const long long* at, const uint32_t* rsc, int g,
    int n0, int count, int K, int C, float* __restrict__ y_re,
    float* __restrict__ y_im) {
  if constexpr (G > 1) {
    if (g < G) {
      store_group<G - 1>(box, at, rsc, g, n0, count, K, C, y_re, y_im);
      return;
    }
  }
  for (int idx = threadIdx.x; idx < G * count; idx += FINE_NT) {
    const int k = idx / G, j = idx - k * G;
    const uint32_t n = (uint32_t)(n0 + k);
    const uint32_t v = rsc[j] + rsc[FINE_G + j] * n
        + rsc[2 * FINE_G + j] * (n * FINE_D + (uint32_t)(K - 1));
    const float2 yv = cmul(make_float2(box[k * FINE_G + j],
                                       box[(FINE_NB + k) * FINE_G + j]),
                           cis(v));
    const long long a = at[j] + (long long)k * C;
    y_re[a] = yv.x;
    y_im[a] = yv.y;
  }
}

__global__ void __launch_bounds__(FINE_NT, FINE_BLOCKS)
pfb_fine_kernel(const float2* __restrict__ x,
                const long long* __restrict__ xrow,
                const float2* __restrict__ hist,
                const float* __restrict__ taps,
                const float* __restrict__ fine,
                const long long* __restrict__ phase0,
                const long long* __restrict__ step,
                float* __restrict__ y_re, float* __restrict__ y_im,
                int S, int T, int N, int K, int C, int rb) {
  constexpr int O = FINE_O, NT = FINE_NT, NB = FINE_NB;
  constexpr int RSTRIDE = NT / MIX_THREADS;   // rows a mixing pass
  extern __shared__ __align__(128) unsigned char smem[];
  const int Q = (K + FINE_D - 1) / FINE_D;
  const int QP = (Q + O - 1) / O * O;     // whole groups of O tap rows
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * rb, n0 = blockIdx.y * NB;
  const int nrow = min(rb, S - s0);
  const int count = min(NB, N - n0);
  const int rows = count + Q - 1;         // staged rows, all inside z
  const int rowsp = count + QP - 1;       // and zero rows past them
  const int steps = (rowsp + RSTRIDE - 1) / RSTRIDE;
  float* raw = reinterpret_cast<float*>(smem);
  float* mixed = raw + (NB + QP - 1) * ROW;
  float* tp = mixed + (NB + QP - 1) * ROW;
  float2* ek = reinterpret_cast<float2*>(tp + QP * FINE_D);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      ek + (NB + QP - 1 + RSTRIDE - 1) / RSTRIDE);
  long long* at = reinterpret_cast<long long*>(bar + 1);     // [G]
  uint32_t* rsc = reinterpret_cast<uint32_t*>(at + FINE_G);  // [3][G]
  float* box = reinterpret_cast<float*>(rsc + 3 * FINE_G);   // [2][NB][G]
  const int z0 = n0 * FINE_D, zn = rows * FINE_D;
  const int hn = max(0, min(K - 1 - z0, zn));  // history samples of it
  const uint32_t b = smem_u32(bar);
  // row s's span, samples [z0, z0 + zn): its history part, and the bin's
  // part when the bin is not the one staged (thread 0)
  auto stage = [&](int s, bool bin) {
    mbar_expect_tx(b, (uint32_t)(bin ? zn : hn) * sizeof(float2));
    if (hn > 0)
      bulk_load(smem_u32(raw), hist + (long long)s * (K - 1) + z0,
                hn * sizeof(float2), b);
    if (bin && hn < zn)
      bulk_load(smem_u32(raw + 2 * hn),
                x + __ldg(xrow + s) * T + (z0 + hn - (K - 1)),
                (zn - hn) * sizeof(float2), b);
  };
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) stage(s0, true);
  long long staged = __ldg(xrow + s0);    // the bin row in raw
  int copies = 1;                         // copy groups issued
  bool pending = true;
  // the taps, correlation-reversed and zero past K
  for (int i = tid; i < QP * FINE_D; i += NT)
    tp[i] = i < K ? __ldg(taps + K - 1 - i) : 0.0f;

  const int c = tid % MIX_THREADS, r0 = tid / MIX_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int part = warp / FINE_WP;        // 0: real, 1: imaginary
  const int g = lane / LANES, h = lane % LANES;
  const int wbase = (warp - part * FINE_WP) * (32 / LANES) * O;
  const int base = wbase + g * O;         // the group's first output
  const bool active = wbase < count;      // warp-uniform
  const float4* raw4 = reinterpret_cast<const float4*>(raw);
  const float4* mix4 = reinterpret_cast<const float4*>(mixed);
  for (int i = 0; i < nrow; ++i) {
    const int s = s0 + i;
    const int slot = i % FINE_G;          // the row's place in its group
    // the row's mixer: sigma, the row steps ek[k] =
    // phasor(-sigma*D*RSTRIDE*k) and the thread's base phasors, of
    // samples z0 + D*r0 + 2*c + j
    const uint32_t sig = (uint32_t)__double2ll_rn(
        (double)__ldg(fine + s) * 4294967296.0);
    long long p0 = 0, st = 0;               // the row's rotation (thread 0)
    if (tid == 0) {
      p0 = __ldg(phase0 + s);
      st = __ldg(step + s);
    }
    for (int k = tid; k < steps; k += NT)
      ek[k] = cis(0u - sig * (uint32_t)(FINE_D * RSTRIDE * k));
    const uint32_t u0 = 0u - sig * (uint32_t)(z0 + FINE_D * r0 + 2 * c);
    const float2 ph0 = cis(u0), ph1 = cis(u0 - sig);
    if (pending) mbar_wait(b, (copies - 1) & 1);
    __syncthreads();    // the span, the steps; the last group stored
    if (tid == 0) {     // where the row's outputs go, and their rotation
      const int src = s / C;
      at[slot] = ((long long)src * N + n0) * C + (s - src * C);
      rsc[slot] = (uint32_t)p0;
      rsc[FINE_G + slot] = (uint32_t)st;
      rsc[2 * FINE_G + slot] = sig;
    }

    // mix: samples 2c, 2c+1 of raw row r (chunk c) become float2 c of
    // mixed row r's real half and of its imaginary half; the rows past
    // the span up to the last group's are zeros (their taps are zeros).
    // The loads run unguarded (inside shared memory), only the stores are
    float2* m2 = reinterpret_cast<float2*>(mixed) + r0 * 16 + c;
#pragma unroll 2
    for (int k = 0; k < steps; ++k, m2 += RSTRIDE * 16) {
      const int r = r0 + k * RSTRIDE;
      const float4 zv = raw4[r * 8 + c];
      const float2 e = ek[k];
      float2 w0 = cmul(make_float2(zv.x, zv.y), cmul(ph0, e));
      float2 w1 = cmul(make_float2(zv.z, zv.w), cmul(ph1, e));
      if (r >= rows) w0 = w1 = make_float2(0.0f, 0.0f);
      const int re = 8 * (r & 1);
      if (r < rowsp) {
        m2[re] = make_float2(w0.x, w1.x);
        m2[8 - re] = make_float2(w0.y, w1.y);
      }
    }
    __syncthreads();    // the rows mixed, the span free

    // the next row's span lands while this row's filter runs
    pending = false;
    if (i + 1 < nrow) {
      const long long nx = __ldg(xrow + s + 1);
      const bool bin = nx != staged;
      if (bin || hn > 0) {
        if (tid == 0) stage(s + 1, bin);
        ++copies;
        pending = true;
        staged = nx;
      }
    }

    // the filter: warps 0..WP-1 take the real parts, WP..2WP-1 the
    // imaginary; lane group g (four lanes) O consecutive outputs, lane h
    // of it planes 4h .. 4h+3
    float acc[O];
#pragma unroll
    for (int r = 0; r < O; ++r) acc[r] = 0.0f;
    if (active) {
      auto load_row = [&](float (&w)[PLANES], int m) {
        const float4 v = mix4[m * 8 + chunk(m, part, h)];
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      };
      // row base + m sits in window slot m % O; tap rows go in whole
      // groups of O from 0, so every slot index is a constant: the row
      // entering at tap row q + u is q + u + O-1, slot (u + O-1) % O, and
      // output r reads row q + u + r, slot (u + r) % O. The entering row
      // and the taps of tap row q + u + 1 are loaded during tap row q + u
      float win[O][PLANES];
#pragma unroll
      for (int m = 0; m < O - 1; ++m) load_row(win[m], base + m);
      const float4* t4 = reinterpret_cast<const float4*>(tp) + h;
      float next[PLANES];
      load_row(next, base + O - 1);
      float4 tn = t4[0];
      for (int q = 0; q < QP; q += O) {
#pragma unroll
        for (int u = 0; u < O; ++u) {
          const float t[PLANES] = {tn.x, tn.y, tn.z, tn.w};
#pragma unroll
          for (int j = 0; j < PLANES; ++j) win[(u + O - 1) % O][j] = next[j];
          if (u + 1 < O || q + O < QP) {
            load_row(next, base + q + u + O);
            tn = t4[(q + u + 1) * LANES];
          }
#pragma unroll
          for (int j = 0; j < PLANES; ++j)
#pragma unroll
            for (int r = 0; r < O; ++r)
              acc[r] = fmaf(t[j], win[(u + r) % O][j], acc[r]);
        }
      }
      // the group's four partial sums of each output meet
#pragma unroll
      for (int r = 0; r < O; ++r) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
        if (r % LANES == h)
          box[(part * NB + base + r) * FINE_G + slot] = acc[r];
      }
    }
    __syncthreads();    // the parts' sums written, the rows read

    if (slot == FINE_G - 1 || i == nrow - 1)   // the group filtered
      store_group<FINE_G>(box, at, rsc, slot + 1, n0, count, K, C, y_re,
                          y_im);
  }
}

}  // namespace

// x [R, T, 2] float32 bins (each row a bin's T samples; 16-byte aligned),
// xrow [S] int64 rows of x in [0, R); hist [S, K-1] complex64 (16-byte
// aligned); taps [K] float32, the prototype; fine [S] float32, each
// row's offset in cycles per bin sample; phase0, step [S] int64 uint32
// values; y_re, y_im [S/C, N, C] float32, the planes of the rows as
// C slots a source (S % C == 0). T = N*16 and K odd (whole 16-byte spans
// of history and bin); rb consecutive rows a block.
extern "C" int pfb_fine_launch(const void* x, const void* xrow,
                               const void* hist, const void* taps,
                               const void* fine, const void* phase0,
                               const void* step, void* y_re, void* y_im,
                               int S, int T, int N, int K, int C, int rb,
                               void* stream) {
  if (K <= 0 || K % 2 == 0 || N < 0 || T != N * FINE_D || rb < 1 || C < 1 ||
      S % C)
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || N == 0) return (int)cudaSuccess;
  const int QP = ((K + FINE_D - 1) / FINE_D + FINE_O - 1) / FINE_O * FINE_O;
  const int smem = fine_bytes(FINE_NB, QP, FINE_NT / MIX_THREADS);
  static int allowed = 0;                 // per process: one card
  if (smem > allowed) {
    if (cudaError_t e = cudaFuncSetAttribute(
            pfb_fine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem))
      return (int)e;
    allowed = smem;
  }
  const dim3 grid((S + rb - 1) / rb, (N + FINE_NB - 1) / FINE_NB);
  pfb_fine_kernel<<<grid, FINE_NT, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const long long*)xrow, (const float2*)hist,
      (const float*)taps, (const float*)fine, (const long long*)phase0,
      (const long long*)step, (float*)y_re, (float*)y_im, S, T, N, K, C,
      rb);
  return (int)cudaGetLastError();
}
