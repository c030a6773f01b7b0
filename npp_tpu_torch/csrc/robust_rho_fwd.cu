// K4 forward: the row-wise weighted Barron rho,
//
//   r[m] = sum_c w_c * rho(x[m, c], alpha_c, s_c),
//
// for the `loss_otherwise` branch of general_lossfun with its beta_safe /
// alpha_safe clamps, for up to sixteen (x, alpha, s, w, r) segments in one
// launch: the five LPIPS layers of a 'same' step go out together. Replaces
// the XLA-fused per-element rho of `nllfun` (npp_tpu/losses/robust.py:63-81,
// 134-138). kernels/robust_rho.py::rho_rows_plain is the same function in
// PyTorch.
//
// Bound: memory. x is read once and r written once (39.9 MB at the LPIPS
// layer-1 shape 153,600 x 64). What held the Triton kernel back, and what
// this design does about it:
//  - host time per launch: one launch for all segments. The segments are
//    passed by value in the kernel's parameter struct (no host-to-device
//    copy, so a CUDA graph can capture the launch); blocks map to segments
//    by a prefix over the per-segment block counts;
//  - lanes: where C % 4 == 0 and x is 16-byte aligned, a row is 2^k lanes
//    of one warp (up to 32) with 16-byte loads, summed by an xor butterfly
//    over those lanes. Otherwise (C = 3) the block walks a tile of rows as
//    one flat array, one value per lane, and each thread then sums one row
//    of the tile from shared memory; no lane is padding;
//  - the grid fills the card once (as many blocks per SM as fit), shared
//    out among the segments by their element counts, with a whole number of
//    sweeps of rows per block;
//  - bytes in flight: each thread issues the loads of four row groups
//    before their arithmetic (vector path) or of its four values of a tile
//    (flat path);
//  - sums run in a fixed order (lane order, then the butterfly): no
//    atomics, the same bits on every run.
//  - wide rows (C above 1,024, the style loss's flattened Grams: 6 rows of
//    4,096, 16,384 and 65,536): a warp per row would leave the card idle
//    and the channels' constants no longer fit in shared memory, so each
//    row is cut into chunks of 2,048 columns, one block per (row, chunk),
//    which computes the constants per element, sums its chunk (butterfly,
//    then the warps in order) and writes one partial; a second small kernel
//    adds each row's partials in chunk order. No float atomics: the same
//    bits on every run, as on the other paths.
// rho = (beta/alpha_safe) expm1(alpha/2 log1p(sq/beta)): pow(u, alpha/2) - 1
// cancels in f32 for small alpha. log1pf and expm1f are the precise ones:
// cheaper forms (a corrected logf, series for small arguments) were as
// accurate but no faster on an H100 (scripts/split_k4_fwd.py).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
// segments of one launch: the five LPIPS layers of up to three images
// (parallel/batch.py), each image with its own alpha and scale
constexpr int kMaxSegments = 16;
constexpr int kMaxChannels = 1024;
constexpr int kPerThread = 4;                   // flat path: values a thread
constexpr int kTile = kThreads * kPerThread;    // holds in one tile
constexpr int kUnroll = 4;   // vector path: row groups whose loads are in
                             // flight together
constexpr int kWide = -2;                       // lanes_log2 of a wide row
constexpr int kWideChunk = 2048;                // its columns per block
constexpr int kWidePerThread = kWideChunk / kThreads;

// One segment of the launch, as the kernel sees it.
struct Segment {
  const float* x;
  const float* alpha;
  const float* scale;
  const float* w;
  float* r;
  long long m;
  long long rows_per_block;
  int c;
  float* part;       // wide path: (m, n_chunks) partial row sums
  int lanes_log2;    // lanes per row = 2^lanes_log2; -1: the flat path;
                     // kWide: the wide path
  int per_lane;      // float4 a lane reads per row (vector path)
  int n_chunks;      // wide path: chunks of kWideChunk columns per row
  int block_begin;   // first block of this segment
};

struct Plan {
  Segment seg[kMaxSegments];
  int n;
};

// A channel's constants {1/s, alpha/2, 1/beta_safe, w beta_safe/alpha_safe}.
__device__ __forceinline__ float4 channel_constants(const Segment& sp,
                                                    int c) {
  const float a = sp.alpha[c];
  const float b = fmaxf(fabsf(a - 2.0f), kEps);
  const float asafe = (a >= 0.0f ? 1.0f : -1.0f) * fmaxf(fabsf(a), kEps);
  return make_float4(1.0f / sp.scale[c], 0.5f * a, 1.0f / b,
                     sp.w[c] * (b / asafe));
}

// w_c rho(x, alpha_c, s_c) from the channel's constants k.
__device__ __forceinline__ float rho_w(float x, float4 k) {
  const float z = x * k.x;
  return k.w * expm1f(k.y * log1pf(z * z * k.z));
}

// Vector path: 2^lanes_log2 lanes of a warp per row, per_lane float4 each.
// A warp takes kUnroll groups of its rows at a time, a block sweep apart,
// and issues their loads before their arithmetic: with one load in flight
// per thread the kernel read 39 MB in 29 us with no arithmetic at all
// (scripts/split_k4_fwd.py on an H100).
__device__ __forceinline__ void rows_vec(const Segment& sp,
                                         const float4* consts,
                                         long long row0, long long row_end) {
  const int lanes_log2 = sp.lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane >> lanes_log2;          // row within the warp's rows
  const int j = lane & (lanes - 1);            // lane within the row
  const int rows_per_warp = 32 >> lanes_log2;
  const long long sweep = (long long)rows_per_warp * kWarps;
  const int n4 = sp.c >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(sp.x);
  // `base` is the same on every lane of a warp, so all of them reach the
  // shuffles
  for (long long base = row0 + (long long)warp * rows_per_warp;
       base < row_end; base += sweep * kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0f;
    for (int k = 0; k < sp.per_lane; ++k) {
      const int i = j + (k << lanes_log2);
      if (i >= n4) break;
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = base + u * sweep + sub;
        v[u] = row < row_end ? __ldg(x4 + row * n4 + i)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      const float4 k0 = consts[4 * i], k1 = consts[4 * i + 1];
      const float4 k2 = consts[4 * i + 2], k3 = consts[4 * i + 3];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc[u] += rho_w(v[u].x, k0);
        acc[u] += rho_w(v[u].y, k1);
        acc[u] += rho_w(v[u].z, k2);
        acc[u] += rho_w(v[u].w, k3);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float a = acc[u];
      for (int off = lanes >> 1; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      const long long row = base + u * sweep + sub;
      if (row < row_end && j == 0) sp.r[row] = a;
    }
  }
}

// Flat path: tiles of min(256, kTile / c) rows, read as one flat array of
// values (thread t takes values t, t + 256, ...), w rho into shared memory,
// then thread t sums row t of the tile in channel order.
__device__ __forceinline__ void rows_flat(const Segment& sp,
                                          const float4* consts, float* tile,
                                          long long row0, long long row_end) {
  const int c = sp.c;
  const int tid = threadIdx.x;
  const int tile_rows = min(kThreads, kTile / c);
  const int ch0 = tid % c;
  const int ch_step = kThreads % c;
  for (long long t0 = row0; t0 < row_end; t0 += tile_rows) {
    const int rows = (int)min((long long)tile_rows, row_end - t0);
    const int n = rows * c;
    const float* xs = sp.x + t0 * c;
    float xv[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      xv[i] = e < n ? __ldg(xs + e) : 0.0f;
    }
    int ch = ch0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n) tile[e] = rho_w(xv[i], consts[ch]);
      ch += ch_step;
      if (ch >= c) ch -= c;
    }
    __syncthreads();
    for (int rr = tid; rr < rows; rr += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < c; ++k) acc += tile[rr * c + k];
      sp.r[t0 + rr] = acc;
    }
    __syncthreads();
  }
}

// Wide path: block `b` of the segment sums chunk b % n_chunks of row
// b / n_chunks into its partial. All loads of a thread go out before the
// arithmetic; the constants are computed per element from alpha, s and w.
__device__ __forceinline__ void row_chunk_wide(const Segment& sp, long long b,
                                               float* red) {
  const long long row = b / sp.n_chunks;
  const int chunk = (int)(b - row * sp.n_chunks);
  const int c0 = chunk * kWideChunk + threadIdx.x;
  const float* xr = sp.x + row * sp.c;
  float xv[kWidePerThread], av[kWidePerThread], sv[kWidePerThread],
      wv[kWidePerThread];
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int ch = c0 + i * kThreads;
    const bool in = ch < sp.c;
    xv[i] = in ? __ldg(xr + ch) : 0.0f;
    av[i] = in ? __ldg(sp.alpha + ch) : 1.0f;
    sv[i] = in ? __ldg(sp.scale + ch) : 1.0f;
    wv[i] = in ? __ldg(sp.w + ch) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const float a = av[i];
    const float bs = fmaxf(fabsf(a - 2.0f), kEps);
    const float asafe = (a >= 0.0f ? 1.0f : -1.0f) * fmaxf(fabsf(a), kEps);
    if (c0 + i * kThreads < sp.c)
      acc += rho_w(xv[i], make_float4(1.0f / sv[i], 0.5f * a, 1.0f / bs,
                                      wv[i] * (bs / asafe)));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[k];
    sp.part[row * sp.n_chunks + chunk] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
rho_fwd_group_kernel(const Plan plan) {
  __shared__ float4 consts[kMaxChannels];
  __shared__ float tile[kTile];
  const int b = blockIdx.x;
  // this block's segment: the last one that begins at or before it (a
  // segment of no rows has no blocks, and begins where the next one does)
  Segment sp = plan.seg[0];
#pragma unroll
  for (int s = 1; s < kMaxSegments; ++s)
    if (s < plan.n && b >= plan.seg[s].block_begin) sp = plan.seg[s];
  if (sp.lanes_log2 == kWide) {   // the same on every thread of the block
    row_chunk_wide(sp, b - sp.block_begin, tile);
    return;
  }
  for (int ch = threadIdx.x; ch < sp.c; ch += kThreads)
    consts[ch] = channel_constants(sp, ch);
  __syncthreads();
  const long long row0 = (long long)(b - sp.block_begin) * sp.rows_per_block;
  const long long row_end = min(sp.m, row0 + sp.rows_per_block);
  if (sp.lanes_log2 >= 0)
    rows_vec(sp, consts, row0, row_end);
  else
    rows_flat(sp, consts, tile, row0, row_end);
}

// Wide rows: r[row] = the row's partials summed in chunk order. blockIdx.y
// is the segment; other segments' blocks return.
__global__ void rho_fwd_wide_finish(const Plan plan) {
  Segment sp = plan.seg[0];
#pragma unroll
  for (int s = 1; s < kMaxSegments; ++s)
    if (s == (int)blockIdx.y) sp = plan.seg[s];
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (sp.lanes_log2 != kWide || row >= sp.m) return;
  const float* p = sp.part + row * sp.n_chunks;
  float s = 0.0f;
  for (int k = 0; k < sp.n_chunks; ++k) s += p[k];
  sp.r[row] = s;
}

// Resident blocks of the kernel per SM, at most kMaxBlocksPerSm; asked of
// the runtime once.
int blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    int got = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &got, rho_fwd_group_kernel, kThreads, 0) != cudaSuccess ||
        got <= 0)
      got = 1;
    n = got < kMaxBlocksPerSm ? got : kMaxBlocksPerSm;
  }
  return n;
}

}  // namespace

// One segment as the caller passes it: x (m, c) row-major, alpha, scale,
// w (c,), r (m,), all float32 on the card.
struct RhoSegment {
  const float* x;
  const float* alpha;
  const float* scale;
  const float* w;
  float* r;
  long long m;
  long long c;
  float* part;   // c > 1024: m * ceil(c / 2048) floats of scratch
};

// r of each of the n (1 to 16) segments, in one launch on `stream` (and,
// where a segment has more than 1024 channels, a second small one that
// finishes the wide rows). Returns cudaGetLastError() (0 on success).
extern "C" int npp_robust_rho_fwd_group(const RhoSegment* segs, int n,
                                        int sm_count, void* stream) {
  if (n < 1 || n > kMaxSegments || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  double total = 0.0;     // elements of the narrow segments
  long long wide_m = 0;   // rows of the longest wide segment
  for (int s = 0; s < n; ++s) {
    if (segs[s].c < 1 || segs[s].c > (1LL << 30) || segs[s].m < 0)
      return (int)cudaErrorInvalidValue;
    if (segs[s].c > kMaxChannels) {
      if (segs[s].part == nullptr && segs[s].m > 0)
        return (int)cudaErrorInvalidValue;
      wide_m = segs[s].m > wide_m ? segs[s].m : wide_m;
    } else {
      total += (double)segs[s].m * (double)segs[s].c;
    }
  }
  const double target = (double)blocks_per_sm() * sm_count;
  Plan plan = {};
  plan.n = n;
  long long begin = 0;
  for (int s = 0; s < n; ++s) {
    const RhoSegment& in = segs[s];
    Segment& d = plan.seg[s];
    d.x = in.x;
    d.alpha = in.alpha;
    d.scale = in.scale;
    d.w = in.w;
    d.r = in.r;
    d.m = in.m;
    d.c = (int)in.c;
    d.part = in.part;
    d.block_begin = (int)begin;
    if (d.c > kMaxChannels) {   // one block per (row, chunk)
      d.lanes_log2 = kWide;
      d.n_chunks = (d.c + kWideChunk - 1) / kWideChunk;
      d.rows_per_block = 1;
      begin += in.m * d.n_chunks;
      continue;
    }
    long long sweep;   // rows a block takes in one pass of its loop
    if (d.c % 4 == 0 && (reinterpret_cast<uintptr_t>(in.x) & 15) == 0) {
      const int n4 = d.c / 4;
      int lanes_log2 = 0;
      while ((1 << lanes_log2) < n4 && lanes_log2 < 5) ++lanes_log2;
      d.lanes_log2 = lanes_log2;
      d.per_lane = (n4 + (1 << lanes_log2) - 1) >> lanes_log2;
      sweep = (long long)(32 >> lanes_log2) * kWarps * kUnroll;
    } else {
      d.lanes_log2 = -1;
      d.per_lane = 0;
      sweep = kTile / d.c < kThreads ? kTile / d.c : kThreads;
    }
    // this segment's share of one full wave of blocks
    long long share = total > 0.0
        ? (long long)(target * ((double)in.m * in.c) / total + 0.5) : 1;
    if (share < 1) share = 1;
    const long long sweeps = (in.m + sweep - 1) / sweep;
    d.rows_per_block = (sweeps + share - 1) / share * sweep;
    if (in.m > 0) begin += (in.m + d.rows_per_block - 1) / d.rows_per_block;
  }
  if (begin > 0)
    rho_fwd_group_kernel<<<(unsigned)begin, kThreads, 0,
                           (cudaStream_t)stream>>>(plan);
  if (wide_m > 0) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    rho_fwd_wide_finish<<<dim3((unsigned)((wide_m + kThreads - 1) / kThreads),
                               (unsigned)n),
                          kThreads, 0, (cudaStream_t)stream>>>(plan);
  }
  return (int)cudaGetLastError();
}
