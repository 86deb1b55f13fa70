// Complex-input xlat channelizer bank for Hopper (sm_90a), float32.
//
// Replaces radiocapture_tpu/ops/pallas_channelizer.py::bank_matmul_pallas
// (its _bank_kernel) and the rotation that follows it in
// ops/channelizer.py::XlatBank.__call__ (channelizer.py:164-171).
//
// Per source s, with z[s] = history[s] ++ x[s] (K-1 complex64 history
// samples, then the T samples of the wire block) and g[s] the
// correlation-reversed modulated taps [C, K]:
//
//   y[s, c, n] = e^{i*theta} * sum_k g[s, c, k] * z[s, n*D + k]
//   theta      = (float)(phase0[s,c] + step[s,c]*n mod 2^32) * 2pi/2^32
//
// The operands are read where they lie: x is the [S, T, 2] wire block,
// bf16 or float32 (a complex64 block comes as its float32 view), and the
// history the [S, K-1] complex64 state; bf16 -> float32 is exact, so no
// conversion or concatenation pass runs before the kernel. Output: y
// [S, C, N] complex64, the JAX __call__ contract. Viewed as real it is
// the [S, 2, N, 2] layout SpectrumSplit2 hands on.
//
// Bound: memory. SpectrumSplit2 has D=2, K=20 taps (19 designed, padded
// to a multiple of D), C=2 slots: per output 160 FMAs against 8 bytes in
// (bf16 wire) and 16 out; at the bench shape (128 sources x 120,000
// outputs) 2.46 G FMAs, 0.073 ms at the f32 CUDA-core peak, against
// 0.110 ms for the bytes. Tensor cores would not pay: TF32 would lose the
// float32 agreement with the JAX __call__, and the FMAs already fit under
// the bytes. So the kernel keeps the load pipe and the issue slots for
// the FMAs:
//
//   - persistent warps: each warp walks a contiguous run of warp tiles
//     (32*R consecutive outputs of one source), so 128 sources and one
//     source (the runtime's split2 provider) both fill every SM; no
//     block-wide barrier anywhere, a warp only meets itself;
//   - the tile's input span, (32R + P-1)*D wire samples, is copied into
//     a per-warp shared ring by cp.async, one tile ahead of the compute;
//     the first K-1 samples of a source's first tile come from history;
//   - the span is converted to float32 and deinterleaved into D
//     polyphase planes, plane j row m = z[m*D + j], so tap q*D+j of
//     output n is row n+q of plane j;
//   - each lane computes R consecutive outputs for every slot: it streams
//     rows lane*R .. lane*R + R+P-2 of each plane once (R odd: a warp's
//     64-bit loads at stride R hit distinct banks) into 2*R*C float32
//     accumulators, with the source's taps (copied to shared memory when
//     the warp's run enters it) held in registers for the tile;
//   - each accumulator takes its terms in the order of the kernel this
//     one replaced (tools/xlat_complex_54b2cf5.cu: k ascending, the same
//     four fmaf per tap) and the same rotation epilogue, one sincosf of
//     the exact uint32 phase, so the outputs are that kernel's bit for
//     bit;
//   - split2's halves sit at +-fs/4, so at D=2 the phase steps by exactly
//     pi per output and takes two values per slot, by the parity of n:
//     their two sincosf are taken once per source instead of one per
//     output (other phase steps take one per output);
//   - the rotated outputs are staged in the planes' shared memory and
//     stored back in whole coalesced rows.
// Other (K, D, C) take the general path, whose outputs are that kernel's
// bit for bit too (the same chain per output). Its one plan, the wide
// plan (the time-sharded mesh step: C=64, K=1440, D=96): a block stages
// the span of its outputs (history and wire read in place) in shared
// memory as float32 polyphase planes at an odd pitch, so a warp's rows
// hit distinct banks, and each thread holds a register tile of 4 outputs
// x 8 slots, with the taps streamed through shared memory one chunk
// ahead. It is bound by float32 CUDA-core FMAs (8 FLOP per tap, output
// and slot; no tensor cores, which would lose the bits). A span too
// large for shared memory takes the direct fallback, which reads z
// straight from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAngle = 1.4629180792671596e-09f;   // float32(2*pi / 2^32)

// The split2 fast path's plan: SpectrumSplit2's bank shape and the
// outputs per lane, warps per block and ring depth.
constexpr int FAST_P = 10;
constexpr int FAST_D = 2;
constexpr int FAST_C = 2;
constexpr int R = 7;
constexpr int WARPS = 4;
constexpr int STAGES = 2;

// One wire sample (re, im): a bf16 pair read as one 32-bit word, or a
// float32 pair. Both convert to float2 exactly.
struct Bf16Pair {
  using T = uint32_t;
  static __device__ __forceinline__ float2 cvt(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};
struct F32Pair {
  using T = float2;
  static __device__ __forceinline__ float2 cvt(float2 v) { return v; }
};

template <typename W>
__device__ __forceinline__ void cp_async_sample(typename W::T* dst,
                                                const typename W::T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(typename W::T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The mixer's phasor at uint32 phase u: (sin, cos) of its float32 angle.
__device__ __forceinline__ float2 phasor(uint32_t u) {
  float sn, cs;
  sincosf(__uint2float_rn(u) * kAngle, &sn, &cs);
  return make_float2(sn, cs);
}

__device__ __forceinline__ float2 mix(float ar, float ai, float2 sc) {
  return make_float2(ar * sc.y - ai * sc.x, ar * sc.x + ai * sc.y);
}

__device__ __forceinline__ float2 rotate(float ar, float ai, uint32_t u) {
  return mix(ar, ai, phasor(u));
}

// ---- the split2 fast path ----------------------------------------------

constexpr int TILE = 32 * R;                        // outputs per warp tile
constexpr int ROWS = TILE + FAST_P - 1;             // plane rows per tile
constexpr int SPAN = ROWS * FAST_D;                 // samples per tile
// plane pitch in float2: >= ROWS and = 8 (mod 16), so the two planes'
// rows sit 16 banks apart and the deinterleaving stores do not conflict
constexpr int PITCH = (ROWS + 7) / 16 * 16 + 8;
static_assert(R % 2 == 1, "R odd: lanes at stride R hit distinct banks");
static_assert(PITCH >= ROWS && PITCH % 16 == 8, "plane pitch");
static_assert(FAST_C <= FAST_D && TILE <= PITCH,
              "the output staging fits in the planes");

template <typename W>
__host__ __device__ constexpr int warp_smem_bytes() {
  return STAGES * SPAN * (int)sizeof(typename W::T) +
         (FAST_D * PITCH + FAST_C * FAST_P * FAST_D) * (int)sizeof(float2);
}

template <typename W>
__global__ void __launch_bounds__(WARPS * 32, 4)
xlat_complex_split2(const typename W::T* __restrict__ x,
                    const float2* __restrict__ hist,
                    const float2* __restrict__ g,
                    const long long* __restrict__ phase0,
                    const long long* __restrict__ step,
                    float2* __restrict__ y, int S, int T, int N,
                    int tiles_per_src, int tiles_per_warp) {
  constexpr int P = FAST_P, D = FAST_D, C = FAST_C, K = P * D;
  using In = typename W::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  unsigned char* mine = smem + wib * warp_smem_bytes<W>();
  In* ring = reinterpret_cast<In*>(mine);
  float2* planes =
      reinterpret_cast<float2*>(mine + STAGES * SPAN * (int)sizeof(In));
  float2* taps = planes + FAST_D * PITCH;            // [C, K] of the source

  // the warp's run: tiles [t0, t0 + run) in source-major order
  const long long t0 = ((long long)blockIdx.x * WARPS + wib) * tiles_per_warp;
  const int run = (int)min((long long)tiles_per_warp,
                           (long long)S * tiles_per_src - t0);
  if (run <= 0) return;
  int s = (int)(t0 / tiles_per_src);
  int n0 = (int)(t0 - (long long)s * tiles_per_src) * TILE;
  auto advance = [&](int& s_, int& n0_) {
    n0_ += TILE;
    if (n0_ >= N) { n0_ = 0; ++s_; }
  };
  // tile (s_, n0_) reads the wire samples [lo, hi) of its source
  auto span = [&](int n0_, int& count, int& lo, int& hi) {
    count = min(TILE, N - n0_);
    lo = max(0, n0_ * D - (K - 1));
    hi = (n0_ + count + P - 1) * D - (K - 1);
  };
  int is = s, in0 = n0, issued = 0;      // the copy cursor
  auto issue_next = [&]() {
    if (issued < run) {
      int count, lo, hi;
      span(in0, count, lo, hi);
      const In* src = x + (long long)is * T + lo;
      In* dst = ring + (issued % STAGES) * SPAN;
      for (int i = lane; i < hi - lo; i += 32)
        cp_async_sample<W>(dst + i, src + i);
      advance(is, in0);
    }
    ++issued;
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue_next();

  uint32_t p0[C], st[C];
  // When every slot's phase step is 0 or pi (step*2 = 0 mod 2^32: split2's
  // +-fs/4 halves at D=2), the phase of output n is p0 + step*(n & 1), so
  // each slot has two phasors, taken once per source.
  bool two = false;
  float2 ph[C][2];
  int cur = -1;
  for (int it = 0; it < run; ++it, advance(s, n0)) {
    issue_next();                 // STAGES-1 tiles ahead
    cp_async_wait<STAGES - 1>();  // this tile's copies have landed
    int count, lo, hi;
    span(n0, count, lo, hi);
    if (s != cur) {               // the run crossed into another source
      cur = s;
      for (int i = lane; i < C * K; i += 32)
        taps[i] = __ldg(g + (long long)s * C * K + i);
      two = true;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p0[c] = (uint32_t)phase0[(long long)s * C + c];
        st[c] = (uint32_t)step[(long long)s * C + c];
        two = two && (st[c] << 1) == 0;
      }
      if (two) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          ph[c][0] = phasor(p0[c]);
          ph[c][1] = phasor(p0[c] + st[c]);
        }
      }
    }
    __syncwarp();

    // convert and deinterleave: plane j row m = z[(n0 + m)*D + j]
    const In* raw = ring + (it % STAGES) * SPAN;
    const int z0 = n0 * D;
    for (int i = lane; i < (count + P - 1) * D; i += 32) {
      const int zi = z0 + i;
      const float2 v = zi < K - 1 ? hist[(long long)s * (K - 1) + zi]
                                  : W::cvt(raw[zi - (K - 1) - lo]);
      planes[(i % D) * PITCH + i / D] = v;
    }
    __syncwarp();

    // R consecutive outputs per lane, every slot, taps in registers for
    // the tile (a broadcast load each)
    float2 gr[C][K];
#pragma unroll
    for (int i = 0; i < C * K; ++i) gr[i / K][i % K] = taps[i];
    const int base = lane * R;
    float ar[R][C], ai[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) ar[r][c] = ai[r][c] = 0.0f;
#pragma unroll
    for (int m = 0; m < R + P - 1; ++m) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float2 zv = planes[j * PITCH + base + m];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = m - r;
          if (q < 0 || q >= P) continue;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float2 gv = gr[c][q * D + j];
            ar[r][c] = fmaf(gv.x, zv.x, ar[r][c]);
            ar[r][c] = fmaf(-gv.y, zv.y, ar[r][c]);
            ai[r][c] = fmaf(gv.x, zv.y, ai[r][c]);
            ai[r][c] = fmaf(gv.y, zv.x, ai[r][c]);
          }
        }
      }
    }
    __syncwarp();         // every lane has read the planes

    // rotate; stage slot c's outputs in plane c's rows
    if (two) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool odd = (n0 + base + r) & 1;
#pragma unroll
        for (int c = 0; c < C; ++c)
          planes[c * PITCH + base + r] =
              mix(ar[r][c], ai[r][c], odd ? ph[c][1] : ph[c][0]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t n = (uint32_t)(n0 + base + r);
#pragma unroll
        for (int c = 0; c < C; ++c)
          planes[c * PITCH + base + r] =
              rotate(ar[r][c], ai[r][c], p0[c] + st[c] * n);
      }
    }
    __syncwarp();

    // whole rows out: lane i stores outputs n0 + i, n0 + i + 32, ...
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float2* yrow = y + ((long long)s * C + c) * N + n0;
      for (int i = lane; i < count; i += 32) yrow[i] = planes[c * PITCH + i];
    }
    __syncwarp();         // the planes are free for the next tile
  }
  cp_async_wait<0>();
}

// ---- the general path --------------------------------------------------
//
// Every accumulator is one chain in k order, as in the kernel this path
// replaced (tools/xlat_complex_54b2cf5.cu:69-80): k ascending, the same
// four fmaf per tap (fma4), the same rotation epilogue. How outputs and
// slots are spread over threads does not touch a chain, so every output
// is that kernel's bit for bit. A block stages the span of its outputs
// (history and wire read in place) as D float32 planes, plane j row m =
// z[(n0 + m)*D + j], so tap q*D + j of output n0 + m' is row m' + q of
// plane j. The plane pitch is odd: a warp's 64-bit stores of consecutive
// samples (consecutive planes) and its loads of rows at an odd stride
// hit distinct banks.

// The wide plan (the time-sharded mesh step: C=64, K=1440, D=96): a
// thread holds WIDE_R outputs (lane + 32*r) x WIDE_RC slots; a warp's
// taps are shared-memory broadcasts, float4 = two taps of a slot; the
// taps stream through shared memory in chunks of WIDE_KC, cp.async one
// chunk ahead. Per pair of taps a thread does 8*R*RC = 256 FMAs for 2R
// plane loads and RC tap loads: FMA-bound.
constexpr int WIDE_R = 4;
constexpr int WIDE_RC = 8;
constexpr int WIDE_WARPS = 8;       // warps per block at most
constexpr int WIDE_KC = 96;         // taps per staged chunk (even)
// Spans too large for shared memory take the direct kernel: one thread
// per (output, slot), z read from device memory.
constexpr int DIRECT_THREADS = 256;
constexpr int DIRECT_BM = 1024;
static_assert(WIDE_KC % 2 == 0, "tap pairs");

__device__ __forceinline__ void fma4(float& ar, float& ai, float2 gv,
                                     float2 zv) {
  ar = fmaf(gv.x, zv.x, ar);
  ar = fmaf(-gv.y, zv.y, ar);
  ai = fmaf(gv.x, zv.y, ai);
  ai = fmaf(gv.y, zv.x, ai);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// float2s of the planes, rounded up so what follows is 16-byte aligned
__host__ __device__ constexpr int plane_floats2(int D, int pitch) {
  return (D * pitch + 1) & ~1;
}

// Stage samples [z0, z0 + span) of history ++ x into the planes: sample
// z0 + i goes to plane i % D, row i / D. History and a float32 wire are
// copied by cp.async (the caller commits and waits); a bf16 wire is
// converted through registers.
template <typename W>
__device__ __forceinline__ void stage_planes(float2* planes, int pitch,
                                             const typename W::T* xs,
                                             const float2* hs, int K, int D,
                                             int z0, int span) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dm = nt / D, dj = nt - dm * D;
  int m = tid / D, j = tid - m * D;
  for (int i = tid; i < span; i += nt) {
    const int zi = z0 + i;
    float2* dst = planes + j * pitch + m;
    if (zi < K - 1)
      cp_async8(dst, hs + zi);
    else if constexpr (sizeof(typename W::T) == sizeof(float2))
      cp_async8(dst, xs + (zi - (K - 1)));
    else
      *dst = W::cvt(__ldg(xs + (zi - (K - 1))));
    m += dm;
    j += dj;
    if (j >= D) { j -= D; ++m; }
  }
}

template <typename W>
__global__ void __launch_bounds__(WIDE_WARPS * 32, 1)
xlat_complex_wide(const typename W::T* __restrict__ x,
                  const float2* __restrict__ hist,
                  const float2* __restrict__ g,
                  const long long* __restrict__ phase0,
                  const long long* __restrict__ step,
                  float2* __restrict__ y, int T, int N, int K, int D, int C,
                  int wn_warps, int pitch) {
  constexpr int R = WIDE_R, RC = WIDE_RC, KC = WIDE_KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = blockDim.x / (32 * wn_warps) * RC;   // slots of the block
  const int nb = wn_warps * 32 * R;                   // outputs of the block
  const int s = blockIdx.z, n0 = blockIdx.x * nb, c0 = blockIdx.y * cb;
  const int count = min(nb, N - n0);
  const int cn = min(cb, C - c0);
  float2* planes = reinterpret_cast<float2*>(smem);
  float2* tbuf = planes + plane_floats2(D, pitch);    // [2][cb][KC]

  stage_planes<W>(planes, pitch, x + (long long)s * T,
                  hist + (long long)s * (K - 1), K, D, n0 * D,
                  (count - 1) * D + K);
  cp_async_commit();
  const float2* gs = g + ((long long)s * C + c0) * K;
  const int chunks = (K + KC - 1) / KC;
  auto issue = [&](int ch) {        // taps [ch*KC, ch*KC + KC) of cn slots
    if (ch < chunks) {
      const int k0 = ch * KC, kc = min(KC, K - k0);
      float2* dst = tbuf + (ch & 1) * cb * KC;
      for (int i = tid; i < cn * KC; i += blockDim.x) {
        const int c = i / KC, kk = i - c * KC;
        if (kk < kc) cp_async8(dst + i, gs + (long long)c * K + k0 + kk);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int wn = warp % wn_warps, wc = warp / wn_warps;
  const int row0 = wn * 32 * R + lane;       // the thread's first output
  const bool active = wc * RC < cn && wn * 32 * R < count;   // warp-uniform
  float ar[R][RC], ai[R][RC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) ar[r][c] = ai[r][c] = 0.0f;

  for (int ch = 0; ch < chunks; ++ch) {
    issue(ch + 1);                 // one chunk ahead
    cp_async_wait<1>();            // the planes and chunk ch have landed
    __syncthreads();
    if (active) {
      const int k0 = ch * KC, kc = min(KC, K - k0);
      const float2* tb = tbuf + (ch & 1) * cb * KC + wc * RC * KC;
      int q = k0 / D, j = k0 - q * D;        // tap k0 + kk is (q, j)
      int kk = 0;
      for (; kk + 1 < kc; kk += 2) {
        const float2* za = planes + j * pitch + q + row0;
        if (++j == D) { j = 0; ++q; }
        const float2* zb = planes + j * pitch + q + row0;
        if (++j == D) { j = 0; ++q; }
        float2 z0[R], z1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          z0[r] = za[32 * r];
          z1[r] = zb[32 * r];
        }
        float4 t[RC];
#pragma unroll
        for (int c = 0; c < RC; ++c)
          t[c] = *reinterpret_cast<const float4*>(tb + c * KC + kk);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < RC; ++c)
            fma4(ar[r][c], ai[r][c], make_float2(t[c].x, t[c].y), z0[r]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < RC; ++c)
            fma4(ar[r][c], ai[r][c], make_float2(t[c].z, t[c].w), z1[r]);
      }
      if (kk < kc) {                 // an odd chunk's last tap
        const float2* za = planes + j * pitch + q + row0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 zv = za[32 * r];
#pragma unroll
          for (int c = 0; c < RC; ++c)
            fma4(ar[r][c], ai[r][c], tb[c * KC + kk], zv);
        }
      }
    }
    __syncthreads();               // chunk ch's buffer is free
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + row0 + 32 * r;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int cc = c0 + wc * RC + c;
      if (cc >= C) continue;
      const long long sc = (long long)s * C + cc;
      const uint32_t u = (uint32_t)phase0[sc]
                         + (uint32_t)step[sc] * (uint32_t)n;
      y[sc * N + n] = rotate(ar[r][c], ai[r][c], u);
    }
  }
}

template <typename W>
__device__ __forceinline__ float2 z_at(const typename W::T* xs,
                                       const float2* hs, int K, int zi) {
  return zi < K - 1 ? hs[zi] : W::cvt(xs[zi - (K - 1)]);
}

template <typename W>
__global__ void __launch_bounds__(DIRECT_THREADS)
xlat_complex_direct(const typename W::T* __restrict__ x,
                    const float2* __restrict__ hist,
                    const float2* __restrict__ g,
                    const long long* __restrict__ phase0,
                    const long long* __restrict__ step,
                    float2* __restrict__ y, int T, int N, int K, int D,
                    int C) {
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * DIRECT_BM;
  const int rows = min(DIRECT_BM, N - n0);
  const typename W::T* xs = x + (long long)s * T;
  const float2* hs = hist + (long long)s * (K - 1);
  const float2* gs = g + (long long)s * C * K;
  for (int idx = threadIdx.x; idx < rows * C; idx += DIRECT_THREADS) {
    const int c = idx / rows;
    const int r = idx - c * rows;
    const float2* gc = gs + (long long)c * K;
    float ar = 0.0f, ai = 0.0f;
    for (int k = 0; k < K; ++k)
      fma4(ar, ai, __ldg(gc + k), z_at<W>(xs, hs, K, (n0 + r) * D + k));
    const int n = n0 + r;
    const uint32_t u = (uint32_t)phase0[(long long)s * C + c]
                       + (uint32_t)step[(long long)s * C + c] * (uint32_t)n;
    y[((long long)s * C + c) * N + n] = rotate(ar, ai, u);
  }
}

template <typename W>
int launch_split2(const void* x, const void* hist, const void* g,
                  const void* phase0, const void* step, void* y, int S,
                  int T, int N, cudaStream_t st) {
  const size_t smem = (size_t)WARPS * warp_smem_bytes<W>();
  static int blocks_per_sm = 0, sms = 0;   // per process: one card
  if (blocks_per_sm == 0) {
    int dev;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (cudaError_t e = cudaFuncSetAttribute(
            xlat_complex_split2<W>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks_per_sm, xlat_complex_split2<W>, WARPS * 32, smem))
      return (int)e;
    if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int tiles_per_src = (N + TILE - 1) / TILE;
  const long long total = (long long)S * tiles_per_src;
  const long long warps = min((long long)blocks_per_sm * sms * WARPS, total);
  const int per_warp = (int)((total + warps - 1) / warps);
  const unsigned blocks =
      (unsigned)(((total + per_warp - 1) / per_warp + WARPS - 1) / WARPS);
  xlat_complex_split2<W><<<blocks, WARPS * 32, smem, st>>>(
      (const typename W::T*)x, (const float2*)hist, (const float2*)g,
      (const long long*)phase0, (const long long*)step, (float2*)y, S, T, N,
      tiles_per_src, per_warp);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_general(const void* x, const void* hist, const void* g,
                   const void* phase0, const void* step, void* y, int S,
                   int T, int N, int K, int D, int C, cudaStream_t st) {
  static int smem_max = 0;   // per process: one card
  if (smem_max == 0) {
    int dev, opt;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &opt, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      return (int)e;
    if (cudaError_t e = cudaFuncSetAttribute(
            xlat_complex_wide<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            opt))
      return (int)e;
    smem_max = opt;
  }
  const auto* xt = (const typename W::T*)x;
  const auto* ht = (const float2*)hist;
  const auto* gt = (const float2*)g;
  const auto* p0 = (const long long*)phase0;
  const auto* sp = (const long long*)step;
  auto* yt = (float2*)y;
  const int Q = (K + D - 1) / D;
  // the largest block whose planes (nb + Q - 1 rows at an odd pitch) and
  // tap chunks fit
  const int wc = min(WIDE_WARPS, (C + WIDE_RC - 1) / WIDE_RC);
  for (int wn = WIDE_WARPS / wc; wn >= 1; --wn) {
    const int nb = wn * 32 * WIDE_R, pitch = (nb + Q - 1) | 1;
    const size_t smem = sizeof(float2) * (size_t)(
        plane_floats2(D, pitch) + 2 * wc * WIDE_RC * WIDE_KC);
    if (smem > (size_t)smem_max) continue;
    const dim3 grid((N + nb - 1) / nb,
                    (C + wc * WIDE_RC - 1) / (wc * WIDE_RC), S);
    xlat_complex_wide<W><<<grid, wn * wc * 32, smem, st>>>(
        xt, ht, gt, p0, sp, yt, T, N, K, D, C, wn, pitch);
    return (int)cudaGetLastError();
  }
  const dim3 grid((N + DIRECT_BM - 1) / DIRECT_BM, S);
  xlat_complex_direct<W><<<grid, DIRECT_THREADS, 0, st>>>(
      xt, ht, gt, p0, sp, yt, T, N, K, D, C);
  return (int)cudaGetLastError();
}

template <typename W>
int launch(const void* x, const void* hist, const void* g,
           const void* phase0, const void* step, void* y, int S, int T,
           int N, int K, int D, int C, cudaStream_t st) {
  if (K == FAST_P * FAST_D && D == FAST_D && C == FAST_C)
    return launch_split2<W>(x, hist, g, phase0, step, y, S, T, N, st);
  return launch_general<W>(x, hist, g, phase0, step, y, S, T, N, K, D, C,
                           st);
}

}  // namespace

// x [S, T, 2] bf16 (x_bf16 = 1) or float32 wire; hist [S, K-1] and
// g [S, C, K] complex64; phase0, step [S, C] int64; y [S, C, N]
// complex64. Needs (N-1)*D + K <= K-1 + T, i.e. every window inside
// history ++ x.
extern "C" int xlat_complex_launch(const void* x, const void* hist,
                                   const void* g, const void* phase0,
                                   const void* step, void* y, int S, int T,
                                   int N, int K, int D, int C, int x_bf16,
                                   void* stream) {
  if (K <= 0 || D <= 0 || T < 0 || (N > 0 && (long long)(N - 1) * D + 1 > T))
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || N <= 0 || C <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? launch<Bf16Pair>(x, hist, g, phase0, step, y, S, T, N, K,
                                   D, C, st)
                : launch<F32Pair>(x, hist, g, phase0, step, y, S, T, N, K, D,
                                  C, st);
}
