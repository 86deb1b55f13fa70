// The pfb frontend's coarse polyphase combiner for Hopper (sm_90a), two
// entry points: pfb_rows_launch writes the flipped branch rows of
// ops/channelizer.py::PfbChannelizer.rows, ready for the M-point inverse
// FFT (cuFFT) that follows it there; pfb_bins_launch (below) applies the
// inverse DFT and the channel rotation to the same sums in the block and
// writes the bin-major bins of PfbChannelizer.bins, the pfb step's.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses this work under
// jit (radiocapture_tpu/ops/channelizer.py, PfbChannelizer.__call__:
// 276-290: history ++ block, the [N, P, M] window stack, the einsum over
// P, the flip); eager PyTorch ran it op by op (ops/pfb_kernel.py::
// pfb_rows_plain, the plain version this kernel is held to bit for bit):
// a bf16 -> float32 copy, a cat, one multiply and P-1 in-place addcmul_
// passes over the float32 accumulator, a flip.
//
// Per source s, with z = history[s] ++ x[s] as rows of M samples,
// zr[r, m'] = z[r M + m'] (rows r < P-1 are the (P-1) M history samples,
// row r >= P-1 is block row r - (P-1)), and hp2 [M, P] the reversed-row
// polyphase taps:
//
//   v'[t, m'] = sum_q hp2[m', q] * zr[t + P-1-q, m']     (re, im apart)
//   v[s, t, m] = v'[t, M-1-m]                  t in [0, n), n = T / M
//
// v is complex64 [S, n, M], the layout torch.fft.ifft(dim=-1) reads. The
// last (P-1) M samples of z go to a new history tensor (never the old one
// in place: another block may still read it); for n < P-1 they span the
// old history and the block.
//
// Rounding: each output's sum is the eager chain, q ascending from one
// product, acc = zr_0 h_0, then acc = fma(zr_q, h_q, acc): nvcc contracts
// PyTorch's CUDA addcmul_ (acc + 1 * b * c) into one fma. On an H100 that
// form gave every output of the eager chain bit for bit, a separate
// product and sum about a third of them. Both steps are pinned with
// __fmul_rn / __fmaf_rn. bf16 -> float32 is exact. No taps are padded:
// an extra zero term could flip the sign of a zero sum.
//
// Bound: bytes. At the bench shape (128 sources x 240000 bf16 samples,
// M = 6, P = 24) the block is 122.9 MB read once and the rows 245.8 MB
// written once, ~0.110 ms at 3.35 TB/s; the 2.95e9 FLOP (a product and a
// sum per tap and component) are 0.044 ms at the 67 TFLOP/s float32 peak.
// The design keeps each byte to one trip through device memory and the
// sums in registers:
//
//   - a block takes one source, a tile of R = 32 K slabs output rows and
//     a group of at most 16 branches; it stages the tile's span of z,
//     (R + P-1) rows, with 16-byte loads of the wire (the history for the
//     first tile) into float32 planes in shared memory, plane m' row r =
//     zr[r, m'], beside its branches' taps;
//   - one warp per (branch, slab of 32 K rows): lane l computes the K
//     consecutive rows K l .. K l + K-1 of its branch, re and im, in
//     registers (K odd: the lanes' 64-bit loads at stride K hit distinct
//     banks). A register window of K + Q - 1 plane rows covers Q = 8 taps
//     and carries its K - 1 lowest rows to the next taps, so each row is
//     read from shared memory once; the tap is a broadcast;
//   - K = 11 on a bf16 wire, 7 on float32, at most 64 registers: the
//     fastest of the odd K tried (5 to 15) on an H100 at the bench
//     shape, where shared memory traffic (fewer rows per lane) and the
//     blocks an SM holds (more) pull apart, and the float32 wire needs
//     more bytes in flight;
//   - the sums are staged in the planes' shared memory, flipped, and
//     stored as whole coalesced rows: a block's output is one contiguous
//     span of v when it holds every branch.
//
// pfb_bins replaces, on the card, the rest of the JAX PfbChannelizer.
// __call__ (radiocapture_tpu/ops/channelizer.py:292-295, fused by XLA:
// the IDFT, y * rot, the transpose), which eager PyTorch ran as cuFFT's
// ifft and a complex multiply, two round trips of 246 MB at the bench
// shape. Its plain version is ops/pfb_kernel.py::pfb_bins_plain
// (pfb_rows_plain, torch.fft.ifft, the rotation, bin-major):
//
//   bins[s, c, t] = sum_m' v'[t, m'] W[c, m']
//   W[c, m'] = e^{+j 2 pi ((c (M-1-m')) mod M) / M} rot[c]
//
// W (ops/pfb_kernel.py::bins_table) folds in the flip, the twiddle and
// PfbChannelizer.rot (its float32 angles), built in float64 and rounded
// once. The staging and the tap sums are pfb_rows' code, so v' and the
// new history are bit for bit pfb_rows'; the IDFT's sum order is not
// cuFFT's, so the bins agree with the plain version to a few float32
// ulps of max|bins|, not bit for bit. Per channel c, m' ascending from
// zero, each step two fmas a component:
//
//   re = fma(-v.im, w.im, fma(v.re, w.re, re))
//   im = fma(v.im, w.re, fma(v.re, w.im, im))
//
// Bound: bytes, the same as pfb_rows' (0.110 ms on bf16, 0.147 on
// float32 at the bench shape, M = 6), with the IDFT counted at an FFT's
// 5 M log2 M FLOP a row. The direct IDFT here does 8 M^2 FLOP a row,
// 1.47e9 at M = 6 beside the taps' 2.95e9, so from M ~ 20 its own float32
// work passes the bytes and keeps it off the bound (a factored IDFT would
// not). The design:
//   - a block holds every branch of its rows, for every M (no branch
//     groups): wb warps a slab take branches bw, bw + wb, ...; after each
//     round's barrier a warp writes its rows' sums over its branch's
//     plane, which no warp reads again, so plane m' row r becomes
//     v'[t0 + r, m'];
//   - the rows of a tile follow M: the wire's K unless the planes, W and
//     the taps pass the shared memory a block can use, then K_SMALL (the
//     plan, ops/pfb_kernel.py::bins_plan, is passed in and checked);
//   - the epilogue: a thread per (row, chunk of CB channels), lanes over
//     consecutive rows, so a row's M sums are read at consecutive
//     addresses across lanes (no bank conflicts) and each channel's store
//     is one coalesced run of bins[s, c, :]; W sits in shared memory
//     m'-major, zero-padded to whole chunks, read by every lane of a warp
//     at once (a broadcast), two channels a 16-byte load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 8;              // taps a register window covers
constexpr int MB_MAX = 16;        // branches a block holds
constexpr int WARPS_MAX = 8;      // warps a block aims for (slabs x branches)
constexpr int U = 4;              // 16-byte loads a thread has in flight
constexpr int K_SMALL = 3;        // pfb_bins' rows a lane where K does not fit
constexpr int CB = 8;             // channels a pfb_bins thread sums at once
constexpr int SMEM_MAX = 232448;  // shared memory a block can use (H100)

// One wire sample (re, im): a bf16 pair read as one 32-bit word, or a
// float32 pair; both convert to float2 exactly. Vec is a 16-byte load. K
// is the rows a lane computes (odd: lanes at stride K hit distinct banks).
struct Bf16Wire {
  using Sample = uint32_t;
  using Vec = uint4;
  static constexpr int VEC = 4;
  static constexpr int K = 11;
  static __device__ __forceinline__ float2 cvt(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ void unpack(const uint4& v,
                                                float2 (&f)[VEC]) {
    f[0] = cvt(v.x);
    f[1] = cvt(v.y);
    f[2] = cvt(v.z);
    f[3] = cvt(v.w);
  }
};
struct F32Wire {
  using Sample = float2;
  using Vec = float4;
  static constexpr int VEC = 2;
  static constexpr int K = 7;
  static __device__ __forceinline__ float2 cvt(float2 v) { return v; }
  static __device__ __forceinline__ void unpack(const float4& v,
                                                float2 (&f)[VEC]) {
    f[0] = make_float2(v.x, v.y);
    f[1] = make_float2(v.z, v.w);
  }
};

// One tap of the eager chain: acc + z h with one rounding, as nvcc
// contracts PyTorch's CUDA addcmul_ (acc + 1 * z * h).
__device__ __forceinline__ float tap(float acc, float z, float h) {
  return __fmaf_rn(z, h, acc);
}

// The block's view of z: source row t0 onwards, branches mb .. mb+mb_n-1,
// plane (m' - mb) at planes + (m' - mb) * pitch.
struct Tile {
  float2* planes;
  int pitch, M, t0, mb, mb_n;

  // z sample i of the source (flat, history first) into its plane
  __device__ __forceinline__ void put(int i, float2 val) const {
    const int r = i / M;
    const int c = i - r * M - mb;
    if (c >= 0 && c < mb_n) planes[c * pitch + (r - t0)] = val;
  }
  // CNT consecutive samples from z sample i
  template <int CNT>
  __device__ __forceinline__ void put_run(int i, const float2 (&f)[CNT])
      const {
    int r = i / M;
    int c = i - r * M - mb;
#pragma unroll
    for (int k = 0; k < CNT; ++k) {
      if (c >= 0 && c < mb_n) planes[c * pitch + (r - t0)] = f[k];
      if (++c == M - mb) {
        c = -mb;
        ++r;
      }
    }
  }
};

// Stage z samples [z0, z1) of source s: the history's below H = (P-1) M,
// the wire block's samples z - H above. Interior wire samples come in
// aligned 16-byte vectors, U a thread in flight; the partial vectors at
// the ends sample by sample.
template <typename W>
__device__ void stage(const Tile& tile, const float2* __restrict__ hist,
                      const typename W::Sample* __restrict__ xs, int H,
                      int z0, int z1) {
  using Vec = typename W::Vec;
  constexpr int VEC = W::VEC;
  for (int i = z0 + threadIdx.x; i < min(z1, H); i += blockDim.x)
    tile.put(i, hist[i]);
  const int j0 = max(z0, H) - H, j1 = z1 - H;
  if (j0 >= j1) return;
  // vector v holds samples [v VEC - off, v VEC - off + VEC) of xs
  const int off = (int)((reinterpret_cast<uintptr_t>(xs)
                         / sizeof(typename W::Sample)) % VEC);
  const int v0 = (j0 + off) / VEC, v1 = (j1 - 1 + off) / VEC;
  for (int v = v0 + threadIdx.x; v <= v1; v += U * blockDim.x) {
    Vec raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vv = v + u * blockDim.x;
      const int b = vv * VEC - off;
      if (vv <= v1 && b >= j0 && b + VEC <= j1)
        raw[u] = *reinterpret_cast<const Vec*>(xs + b);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vv = v + u * blockDim.x;
      const int b = vv * VEC - off;
      if (vv > v1) break;
      if (b >= j0 && b + VEC <= j1) {
        float2 f[VEC];
        W::unpack(raw[u], f);
        tile.put_run<VEC>(H + b, f);
      } else {
        for (int k = 0; k < VEC; ++k)
          if (b + k >= j0 && b + k < j1)
            tile.put(H + b + k, W::cvt(xs[b + k]));
      }
    }
  }
}

// Taps q0 .. q0+Q-1 of a lane's K rows. Window entry i is plane row
// lo + i, lo = base + P-1 - (q0 + Q-1), so row base + j takes tap q0 + q
// from entry j + Q-1 - q. Entries Q .. Q+K-2 are the previous window's
// 0 .. K-2 (rows already in registers); entries 0 .. Q-1 are loaded, and
// on return the carry for the next window is in place. GUARD: the last,
// partial window (taps past P skipped; rows they would need are clamped
// into the plane, never used).
template <int K, bool GUARD>
__device__ __forceinline__ void window(const float2* pl, const float* h,
                                       int base, int q0, int P,
                                       float2 (&w)[K + Q - 1],
                                       float (&re)[K], float (&im)[K]) {
  const int lo = base + P - 1 - (q0 + Q - 1);
#pragma unroll
  for (int i = 0; i < Q; ++i) w[i] = pl[GUARD ? max(lo + i, 0) : lo + i];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (!GUARD || q0 + q < P) {
      const float hq = h[q0 + q];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        re[j] = tap(re[j], w[j + Q - 1 - q].x, hq);
        im[j] = tap(im[j], w[j + Q - 1 - q].y, hq);
      }
    }
  }
#pragma unroll
  for (int i = K - 2; i >= 0; --i) w[Q + i] = w[i];   // memmove order
}

// The K consecutive rows base .. base+K-1 of one branch (plane pl, taps
// h), re and im: the eager chain's sums, q ascending from one product.
template <int K>
__device__ __forceinline__ void branch_sums(const float2* pl, const float* h,
                                            int base, int P, float (&re)[K],
                                            float (&im)[K]) {
  const float h0 = h[0];
  float2 w[K + Q - 1];
#pragma unroll
  for (int j = 0; j < K; ++j) {          // tap 0: one product, no sum
    const float2 z = pl[base + j + P - 1];
    re[j] = __fmul_rn(z.x, h0);
    im[j] = __fmul_rn(z.y, h0);
    if (j < K - 1) w[Q + j] = z;
  }
  int q0 = 1;
  for (; q0 + Q <= P; q0 += Q)
    window<K, false>(pl, h, base, q0, P, w, re, im);
  if (q0 < P) window<K, true>(pl, h, base, q0, P, w, re, im);
}

// What both kernels do first: the new history, the last (P-1) M samples
// of z (nh non-null in one block of the source's last tile), the taps of
// the tile's branches, and the tile's span of z, R + P-1 rows or what is
// left of them, into the planes.
template <typename W>
__device__ __forceinline__ void prologue(const Tile& tile, float* taps,
                                         const float* __restrict__ hp2,
                                         const float2* __restrict__ hs,
                                         const typename W::Sample*
                                             __restrict__ xs,
                                         float2* nh, int n, int P, int R) {
  const int M = tile.M, H = (P - 1) * M;
  if (nh) {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const int zi = n * M + i;
      nh[i] = zi < H ? hs[zi] : W::cvt(xs[zi - H]);
    }
  }
  for (int i = threadIdx.x; i < tile.mb_n * P; i += blockDim.x)
    taps[i] = hp2[(long long)tile.mb * P + i];
  const int span = min(R + P - 1, n + P - 1 - tile.t0);     // rows of z
  stage<W>(tile, hs, xs, H, tile.t0 * M, (tile.t0 + span) * M);
}

template <typename W>
__global__ void __launch_bounds__(32 * MB_MAX, 2)
pfb_rows_kernel(const float2* __restrict__ hist,
                const typename W::Sample* __restrict__ x,
                const float* __restrict__ hp2, float2* __restrict__ v,
                float2* __restrict__ new_hist, int T, int M, int P, int mb_w,
                int slabs, int tiles, int groups) {
  constexpr int K = W::K, SLAB = 32 * K;
  static_assert(K % 2 == 1, "K odd: lanes at stride K hit distinct banks");
  extern __shared__ float4 smem4[];
  const int grp = blockIdx.x % groups;
  const int tile_i = (blockIdx.x / groups) % tiles;
  const long long s = blockIdx.x / ((long long)groups * tiles);
  const int n = T / M, H = (P - 1) * M;
  const int R = slabs * SLAB;
  const int t0 = tile_i * R;
  const int mb = grp * mb_w;
  const int mb_n = min(mb_w, M - mb);
  const int pitch = R + P - 1;
  float2* planes = reinterpret_cast<float2*>(smem4);
  float* taps = reinterpret_cast<float*>(planes + mb_w * pitch);
  const Tile tile{planes, pitch, M, t0, mb, mb_n};
  prologue<W>(tile, taps, hp2, hist + s * H, x + s * T,
              tile_i == tiles - 1 && grp == 0 ? new_hist + s * H : nullptr,
              n, P, R);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ml = warp % mb_w, slab = warp / mb_w;
  const int base = slab * SLAB + lane * K;              // tile-local row
  const bool active = ml < mb_n && t0 + slab * SLAB < n;
  float re[K], im[K];
  if (active)
    branch_sums<K>(planes + ml * pitch, taps + ml * P, base, P, re, im);
  __syncthreads();          // every warp is done with the planes

  // flipped into the planes' memory: out[r][mb_w-1-ml] is v column
  // M-mb-mb_w + (mb_w-1-ml) = M-1-(mb+ml)
  float2* out = planes;
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      out[(base + j) * mb_w + (mb_w - 1 - ml)] = make_float2(re[j], im[j]);
  }
  __syncthreads();
  const int rows = min(R, n - t0);
  if (rows <= 0) return;
  float2* vs = v + (s * n + t0) * M;
  if (mb_w == M) {          // every branch: one contiguous span of v
    for (int i = threadIdx.x; i < rows * M; i += blockDim.x) vs[i] = out[i];
  } else {
    const int col = M - mb - mb_w;
    for (int i = threadIdx.x; i < rows * mb_w; i += blockDim.x) {
      const int r = i / mb_w, c = i - r * mb_w;
      if (col + c >= 0) vs[(long long)r * M + col + c] = out[i];
    }
  }
}

// Shared memory of a pfb_bins block: W m'-major over whole chunks of CB
// channels, the planes of all M branches, the taps.
size_t bins_shared(int M, int P, int K, int slabs) {
  const size_t cpad = (size_t)(M + CB - 1) / CB * CB;
  return sizeof(float2) * M * (cpad + (size_t)slabs * 32 * K + P - 1)
         + sizeof(float) * (size_t)M * P;
}

template <typename W, int K>
__global__ void __launch_bounds__(32 * MB_MAX, 2)
pfb_bins_kernel(const float2* __restrict__ hist,
                const typename W::Sample* __restrict__ x,
                const float* __restrict__ hp2,
                const float2* __restrict__ table, float2* __restrict__ bins,
                float2* __restrict__ new_hist, int T, int M, int P, int wb,
                int slabs, int tiles) {
  constexpr int SLAB = 32 * K;
  static_assert(K % 2 == 1, "K odd: lanes at stride K hit distinct banks");
  static_assert(CB % 2 == 0, "W is read two channels a 16-byte load");
  extern __shared__ float4 smem4[];
  const int tile_i = blockIdx.x % tiles;
  const long long s = blockIdx.x / tiles;
  const int n = T / M, H = (P - 1) * M;
  const int R = slabs * SLAB, t0 = tile_i * R, pitch = R + P - 1;
  const int cpad = (M + CB - 1) / CB * CB;
  float2* wt = reinterpret_cast<float2*>(smem4);        // [M][cpad]
  float2* planes = wt + M * cpad;
  float* taps = reinterpret_cast<float*>(planes + M * pitch);
  for (int i = threadIdx.x; i < M * cpad; i += blockDim.x) {
    const int mp = i / cpad, c = i - mp * cpad;
    wt[i] = c < M ? table[c * M + mp] : make_float2(0.f, 0.f);
  }
  const Tile tile{planes, pitch, M, t0, 0, M};
  prologue<W>(tile, taps, hp2, hist + s * H, x + s * T,
              tile_i == tiles - 1 ? new_hist + s * H : nullptr, n, P, R);
  __syncthreads();

  // warp (bw, slab) sums branches bw, bw + wb, ...; after each round's
  // barrier (the slabs sharing a plane have read it) it writes its rows'
  // sums over its branch's plane: plane m' row r becomes v'[t0 + r, m']
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bw = warp % wb, slab = warp / wb;
  const int base = slab * SLAB + lane * K;
  const bool live = t0 + slab * SLAB < n;
  for (int m0 = 0; m0 < M; m0 += wb) {
    const int ml = m0 + bw;
    const bool active = live && ml < M;
    float re[K], im[K];
    if (active)
      branch_sums<K>(planes + ml * pitch, taps + ml * P, base, P, re, im);
    __syncthreads();
    if (active) {
      float2* pl = planes + ml * pitch;
#pragma unroll
      for (int j = 0; j < K; ++j) pl[base + j] = make_float2(re[j], im[j]);
    }
  }
  __syncthreads();

  // the IDFT and the rotation: a thread per (row, chunk of CB channels),
  // lanes over consecutive rows; a row's M sums sit at consecutive
  // addresses across lanes, W is a broadcast, each channel's store one
  // coalesced run of bins[s, c, :]
  const int rows = min(R, n - t0);
  const int chunks = cpad / CB;
  float2* out = bins + s * M * (long long)n + t0;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int ch = i / rows, r = i - ch * rows;
    float ar[CB], ai[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) ar[k] = ai[k] = 0.f;
    const float4* w4 = reinterpret_cast<const float4*>(wt + ch * CB);
    for (int mp = 0; mp < M; ++mp) {
      const float2 v = planes[mp * pitch + r];
#pragma unroll
      for (int k = 0; k < CB / 2; ++k) {
        const float4 w = w4[mp * (cpad / 2) + k];
        ar[2 * k] = __fmaf_rn(-v.y, w.y, __fmaf_rn(v.x, w.x, ar[2 * k]));
        ai[2 * k] = __fmaf_rn(v.y, w.x, __fmaf_rn(v.x, w.y, ai[2 * k]));
        ar[2 * k + 1] = __fmaf_rn(-v.y, w.w,
                                  __fmaf_rn(v.x, w.z, ar[2 * k + 1]));
        ai[2 * k + 1] = __fmaf_rn(v.y, w.z,
                                  __fmaf_rn(v.x, w.w, ai[2 * k + 1]));
      }
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = ch * CB + k;
      if (c < M) out[(long long)c * n + r] = make_float2(ar[k], ai[k]);
    }
  }
}

template <typename W>
int launch(const void* hist, const void* x, const void* hp2, void* v,
           void* new_hist, int S, int T, int M, int P, cudaStream_t stream) {
  const int groups = (M + MB_MAX - 1) / MB_MAX;
  const int mb_w = (M + groups - 1) / groups;          // branches a block
  const int slabs = mb_w >= WARPS_MAX ? 1 : WARPS_MAX / mb_w;
  const int R = slabs * 32 * W::K;
  const int n = T / M;
  const int tiles = n > 0 ? (n + R - 1) / R : 1;
  const long long blocks = (long long)S * tiles * groups;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(float2) * (size_t)mb_w * (R + P - 1)
                        + sizeof(float) * (size_t)mb_w * P;
  auto kernel = pfb_rows_kernel<W>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, 32 * mb_w * slabs, shared, stream>>>(
      (const float2*)hist, (const typename W::Sample*)x, (const float*)hp2,
      (float2*)v, (float2*)new_hist, T, M, P, mb_w, slabs, tiles, groups);
  return (int)cudaGetLastError();
}

template <typename W, int K>
int launch_bins(const void* hist, const void* x, const void* hp2,
                const void* table, void* bins, void* new_hist, int S, int T,
                int M, int P, int wb, int slabs, cudaStream_t stream) {
  const int R = slabs * 32 * K;
  const int n = T / M;
  const int tiles = n > 0 ? (n + R - 1) / R : 1;
  const long long blocks = (long long)S * tiles;
  const size_t shared = bins_shared(M, P, K, slabs);
  if (blocks > 0x7FFFFFFFLL || shared > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto kernel = pfb_bins_kernel<W, K>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, 32 * wb * slabs, shared, stream>>>(
      (const float2*)hist, (const typename W::Sample*)x, (const float*)hp2,
      (const float2*)table, (float2*)bins, (float2*)new_hist, T, M, P, wb,
      slabs, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// hist [S, (P-1) M] complex64, x [S, T, 2] bf16 (x_bf16) or float32 (a
// complex64 block as its float32 view), hp2 [M, P] float32 -> v [S, T/M, M]
// complex64, new_hist [S, (P-1) M] complex64. T % M == 0.
extern "C" int pfb_rows_launch(const void* hist, const void* x,
                               const void* hp2, void* v, void* new_hist,
                               int S, int T, int M, int P, int x_bf16,
                               void* stream) {
  if (S < 0 || T < 0 || M <= 0 || P <= 0 || T % M != 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? launch<Bf16Wire>(hist, x, hp2, v, new_hist, S, T, M, P, st)
                : launch<F32Wire>(hist, x, hp2, v, new_hist, S, T, M, P, st);
}

// hist, x, hp2 as pfb_rows_launch; table [M, M] complex64, W[c, m']
// (ops/pfb_kernel.py::bins_table) -> bins [S, M, T/M] complex64 bin-major,
// new_hist [S, (P-1) M]. The plan (ops/pfb_kernel.py::bins_plan): k rows
// a lane (the wire's K or K_SMALL), wb warps over the branches, slabs
// slabs of 32 k rows; anything else is refused.
extern "C" int pfb_bins_launch(const void* hist, const void* x,
                               const void* hp2, const void* table,
                               void* bins, void* new_hist, int S, int T,
                               int M, int P, int x_bf16, int k, int wb,
                               int slabs, void* stream) {
  if (S < 0 || T < 0 || M <= 0 || P <= 0 || T % M != 0 || wb < 1
      || slabs < 1 || wb * slabs > MB_MAX)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16 && k == Bf16Wire::K)
    return launch_bins<Bf16Wire, Bf16Wire::K>(hist, x, hp2, table, bins,
                                              new_hist, S, T, M, P, wb,
                                              slabs, st);
  if (x_bf16 && k == K_SMALL)
    return launch_bins<Bf16Wire, K_SMALL>(hist, x, hp2, table, bins,
                                          new_hist, S, T, M, P, wb, slabs,
                                          st);
  if (!x_bf16 && k == F32Wire::K)
    return launch_bins<F32Wire, F32Wire::K>(hist, x, hp2, table, bins,
                                            new_hist, S, T, M, P, wb, slabs,
                                            st);
  if (!x_bf16 && k == K_SMALL)
    return launch_bins<F32Wire, K_SMALL>(hist, x, hp2, table, bins,
                                         new_hist, S, T, M, P, wb, slabs,
                                         st);
  return (int)cudaErrorInvalidValue;
}
