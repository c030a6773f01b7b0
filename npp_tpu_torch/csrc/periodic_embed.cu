// K1: periodic warp + Fourier re-encode, one output row per coordinate,
// written in float32 or bfloat16.
//
// Replaces the XLA-fused `TaskEmbedder.embed` of npp_tpu/nn/embedder.py:87-162
// (periodic_warp -> fourier_encode, vmapped over the top-K proposals), which
// is also what the deleted Pallas kernel ops/fused_embed.py::_fused computed,
// and `make_embedding_table`'s `.astype(dtype)` of it (embedder.py:215-236).
//
// Layout of one output row, D = P * (1 + 2F) per proposal, proposals major:
//   periodic channels p[0..P) = [norm_x, orient-0 (S*O*A*2), norm_y, orient-1]
//   with orient channels ordered scale -> offset -> angle offset -> (sin, cos);
//   then the Fourier layout [p, sin(f1 p), cos(f1 p), sin(f2 p), ...], each
//   block spanning all P channels (embedder.py:59-76,108-128,161-162).
//
// Bound: memory. The output write (N * K * D values) is the whole cost:
// 1.09 GB in f32 and 0.54 GB in bf16 for the 384x512 canvas table at K=3,
// F=10. Design:
//  - a block takes a tile of rows, all K * D channels, and computes it into
//    shared memory in the output's own layout: one thread per (row,
//    proposal, periodic channel) computes that channel once and its 2F
//    Fourier values with one sincosf each; the block has as many threads
//    as split those items into equal rounds;
//  - the tile is then one contiguous run of the output, written with
//    coalesced 16-byte stores. Tiles hold a whole number of rows chosen so
//    that every tile starts 16-byte aligned (2 rows of 1386 f32, 4 of
//    1386 bf16), as many as fit in 48 KB of shared memory beside the
//    channel table (8 rows of 1386 f32, 16 of bf16: 44 KB);
//  - what does not depend on the row (each channel's frequency and the
//    cos / sin of its angle) is computed once per block into shared memory,
//    so no thread divides by P or K, or evaluates the angle's trig.
//
// Numerics follow the plain version op by op: __f*_rn intrinsics stop nvcc
// from contracting into FMAs, the modulo is floored (p - f*floor(p/f), as
// jnp.mod; fmodf truncates and the projection is negative for angle 180),
// and sin / cos are the precise library functions, not __sinf. Where both
// values of one argument are needed the kernel calls sincosf, which gives
// the same bits as sinf and cosf on an H100 (scripts/check_k1_sincos.py).
// bf16 goes through __float2bfloat16_rn (round to nearest even, as
// astype(jnp.bfloat16)).
//
// K1 backward (`npp_periodic_embed_bwd`): with the warp field on
// (npp_tpu/nn/warp.py) the coordinates are learned, and JAX's autodiff
// carries the gradient through the embedding into them. Per row,
//   dL/d(y, x) = sum over proposals and periodic channels of
//                dL/dp * dp/d(y, x),
//   dL/dp = g[p] + sum_b band_b (g[sin b] cos(band_b p) - g[cos b] sin(band_b p)),
// with dp/dx = 2/w (normalised x), dp/dy = 2/h (normalised y), and for a
// phase channel p = sin or cos of phase = 2 pi mod(proj, f)/f,
// proj = y cos(th) + x sin(th): dp/dproj = +-(cos or sin)(phase) 2 pi/f
// (the modulo's derivative is 1, as jnp.mod's). The phases are recomputed
// in f32 as the forward computes them. Bound: memory, the (N, K*D) f32
// gradient read once (329 MB for 59,392 rows of 1,386). One thread per
// (row, proposal, periodic channel) item, as the forward, reads its 2F + 1
// gradient values (neighbouring threads, neighbouring channels); the items'
// products go to shared memory and one thread per row sums them in channel
// order: no atomics, the same bits on every run.
//
// Batched entries (`npp_periodic_embed_batched`, `_bwd_batched`): the
// multi-image fit (parallel/batch.py) embeds B images in one launch, each
// with its own proposals (B, K, 2) and its own normalisation dims (B, 2),
// all device arrays, so a launch copies nothing from the host. blockIdx.y
// is the image: its coordinates, output and dims are offset by it, and the
// rest of the kernel is the single-image one. Bound: memory, as above, for
// B times the rows (0.99 GB in f32 for 3 x 59,392 rows of 1,386).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kMaxThreads = 512;
// a block's shared memory: the 48 KB that need no opt-in; 8 rows of 1386
// f32 (44,352 bytes) and the channel table fit
constexpr long long kSmemBytes = 48 * 1024;

// One periodic channel of one proposal: frequency, cos / sin of its angle,
// and where it and its kind go. code: bit 0 orient, bit 1 cos (else sin),
// bit 2 the normalised coordinate instead of a phase; bits 3.. its offset
// kk * D + c in the row.
struct Channel {
  float f, cth, sth;
  int code;
};

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// Fills the K*P channel table and the bands in shared memory.
__device__ __forceinline__ void fill_channels(
    Channel* chan, float* band, const float* __restrict__ angles,
    const float* __restrict__ periods, const float* __restrict__ bands,
    int n_bands, const float* __restrict__ scales,
    const float* __restrict__ offsets, int n_offsets,
    const float* __restrict__ angle_offsets, int n_angle_offsets, int half,
    int P, int D, int KP) {
  for (int i = threadIdx.x; i < KP; i += blockDim.x) {
    const int kk = i / P;
    const int c = i - kk * P;
    const int orient = c < half ? 0 : 1;
    const int j = c - orient * half;
    Channel ch{0.0f, 0.0f, 0.0f, ((kk * D + c) << 3) | orient};
    if (j == 0) {
      ch.code |= 4;
    } else {
      int q = j - 1;
      ch.code |= (q & 1) << 1;
      q >>= 1;
      const int ia = q % n_angle_offsets;
      q /= n_angle_offsets;
      const int io = q % n_offsets;
      const int is = q / n_offsets;
      ch.f = __fmul_rn(__fadd_rn(periods[2 * kk + orient], offsets[io]),
                       scales[is]);
      const float th = __fmul_rn(
          __fadd_rn(angles[2 * kk + orient], angle_offsets[ia]), kDeg2Rad);
      ch.cth = cosf(th);
      ch.sth = sinf(th);
    }
    chan[i] = ch;
  }
  for (int b = threadIdx.x; b < n_bands; b += blockDim.x) band[b] = bands[b];
}

// The periodic channel's phase, floored modulo as jnp.mod.
__device__ __forceinline__ float phase_of(const Channel& ch, float y,
                                          float x) {
  const float proj = __fadd_rn(__fmul_rn(y, ch.cth), __fmul_rn(x, ch.sth));
  const float m = __fsub_rn(proj,
                            __fmul_rn(ch.f, floorf(__fdiv_rn(proj, ch.f))));
  return __fmul_rn(__fdiv_rn(m, ch.f), kTwoPi);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
periodic_embed_kernel(const float* __restrict__ coords,
                      const float* __restrict__ angles,
                      const float* __restrict__ periods,
                      const float* __restrict__ bands, int n_bands,
                      const float* __restrict__ scales, int n_scales,
                      const float* __restrict__ offsets, int n_offsets,
                      const float* __restrict__ angle_offsets,
                      int n_angle_offsets, long long n, int k, float h,
                      float w, const float* __restrict__ res, int tile_rows,
                      T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = 1 + n_scales * n_offsets * n_angle_offsets * 2;
  const int P = 2 * half;
  const int D = P * (1 + 2 * n_bands);
  const int KP = k * P;
  const int KD = k * D;
  // image blockIdx.y of a batched launch: its rows, proposals and dims
  const long long img = blockIdx.y;
  coords += img * n * 2;
  angles += img * 2 * k;
  periods += img * 2 * k;
  out += img * n * KD;
  if (res != nullptr) {
    h = res[2 * img];
    w = res[2 * img + 1];
  }
  // shared memory: [tile of tile_rows * KD values][K*P channels][bands]
  T* tile = reinterpret_cast<T*>(smem);
  Channel* chan = reinterpret_cast<Channel*>(
      smem + ((tile_rows * KD * (int)sizeof(T) + 15) & ~15));
  float* band = reinterpret_cast<float*>(chan + KP);

  fill_channels(chan, band, angles, periods, bands, n_bands, scales, offsets,
                n_offsets, angle_offsets, n_angle_offsets, half, P, D, KP);
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, n - row0);
  for (int it = threadIdx.x; it < rows * KP; it += blockDim.x) {
    const int r = it / KP;
    const Channel ch = chan[it - r * KP];
    const float y = coords[2 * (row0 + r)];
    const float x = coords[2 * (row0 + r) + 1];
    float p;
    if (ch.code & 4) {
      p = (ch.code & 1) == 0
          ? __fmul_rn(__fsub_rn(__fdiv_rn(x, w), 0.5f), 2.0f)
          : __fmul_rn(__fsub_rn(__fdiv_rn(y, h), 0.5f), 2.0f);
    } else {
      const float phase = phase_of(ch, y, x);
      p = (ch.code & 2) == 0 ? sinf(phase) : cosf(phase);
    }
    T* o = tile + r * KD + (ch.code >> 3);
    o[0] = to_out(p, T());
    for (int b = 0; b < n_bands; ++b) {
      const float xf = __fmul_rn(p, band[b]);
      float s, c;
      sincosf(xf, &s, &c);
      o[(1 + 2 * b) * P] = to_out(s, T());
      o[(2 + 2 * b) * P] = to_out(c, T());
    }
  }
  __syncthreads();

  // the tile is one contiguous run of the output
  const int n_vals = rows * KD;
  T* dst = out + row0 * KD;
  const int bytes = n_vals * (int)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(tile);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      dst4[i] = src4[i];
    for (int i = (bytes / 16) * 16 / (int)sizeof(T) + threadIdx.x;
         i < n_vals; i += blockDim.x)
      dst[i] = tile[i];
  } else {
    for (int i = threadIdx.x; i < n_vals; i += blockDim.x) dst[i] = tile[i];
  }
}

template <typename T>
int launch(const float* coords, const float* angles, const float* periods,
           const float* bands, int n_bands, const float* scales, int n_scales,
           const float* offsets, int n_offsets, const float* angle_offsets,
           int n_angle_offsets, long long n, int k, float h, float w,
           const float* res, int nb, T* out, cudaStream_t stream) {
  const int P = 2 * (1 + n_scales * n_offsets * n_angle_offsets * 2);
  const long long row_bytes =
      (long long)k * P * (1 + 2 * n_bands) * (long long)sizeof(T);
  const long long table_bytes =
      (long long)k * P * sizeof(Channel) + n_bands * sizeof(float);
  const long long budget = kSmemBytes - 16 - table_bytes;
  // rows per tile: a multiple of the rows that make a 16-byte step
  int align_rows = 1;
  while ((row_bytes * align_rows) % 16 != 0) align_rows *= 2;
  long long tile_rows = budget / row_bytes / align_rows * align_rows;
  if (tile_rows == 0 && row_bytes <= budget) tile_rows = 1;   // unaligned
  if (tile_rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((tile_rows * row_bytes + 15) & ~15LL) + table_bytes;
  const long long blocks = (n + tile_rows - 1) / tile_rows;
  // threads: the tile's (row, proposal, channel) items in as few equal
  // rounds as fit in kMaxThreads (528 items in f32: 2 rounds of 264 on
  // 288 threads; 1056 in bf16: 3 rounds of 352)
  const long long items = tile_rows * k * P;
  const long long rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = (int)(((items + rounds - 1) / rounds + 31) / 32 * 32);
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  periodic_embed_kernel<T><<<dim3((unsigned)blocks, (unsigned)nb), threads,
                             smem, stream>>>(
      coords, angles, periods, bands, n_bands, scales, n_scales, offsets,
      n_offsets, angle_offsets, n_angle_offsets, n, k, h, w, res,
      (int)tile_rows, out);
  return (int)cudaGetLastError();
}

// K1 backward: dcoords (n, 2) = dL/d(y, x) from grad (n, K*D) f32. A block
// takes tile_rows rows; shared memory holds the channel table, the bands
// and each item's (dL/dy, dL/dx) terms.
__global__ void __launch_bounds__(kMaxThreads)
periodic_embed_bwd_kernel(const float* __restrict__ grad,
                          const float* __restrict__ coords,
                          const float* __restrict__ angles,
                          const float* __restrict__ periods,
                          const float* __restrict__ bands, int n_bands,
                          const float* __restrict__ scales, int n_scales,
                          const float* __restrict__ offsets, int n_offsets,
                          const float* __restrict__ angle_offsets,
                          int n_angle_offsets, long long n, int k, float h,
                          float w, const float* __restrict__ res,
                          int tile_rows, float* __restrict__ dcoords) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = 1 + n_scales * n_offsets * n_angle_offsets * 2;
  const int P = 2 * half;
  const int D = P * (1 + 2 * n_bands);
  const int KP = k * P;
  const int KD = k * D;
  // image blockIdx.y of a batched launch
  const long long img = blockIdx.y;
  grad += img * n * KD;
  coords += img * n * 2;
  angles += img * 2 * k;
  periods += img * 2 * k;
  dcoords += img * n * 2;
  if (res != nullptr) {
    h = res[2 * img];
    w = res[2 * img + 1];
  }
  // shared memory: [K*P channels][bands][tile_rows * KP * 2 terms]
  Channel* chan = reinterpret_cast<Channel*>(smem);
  float* band = reinterpret_cast<float*>(chan + KP);
  float* terms = band + n_bands;
  fill_channels(chan, band, angles, periods, bands, n_bands, scales, offsets,
                n_offsets, angle_offsets, n_angle_offsets, half, P, D, KP);
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, n - row0);
  const float dnx = __fdiv_rn(2.0f, w), dny = __fdiv_rn(2.0f, h);
  for (int it = threadIdx.x; it < rows * KP; it += blockDim.x) {
    const int r = it / KP;
    const Channel ch = chan[it - r * KP];
    const float y = coords[2 * (row0 + r)];
    const float x = coords[2 * (row0 + r) + 1];
    float p, dpdy, dpdx;
    if (ch.code & 4) {
      const bool is_x = (ch.code & 1) == 0;
      p = is_x ? __fmul_rn(__fsub_rn(__fdiv_rn(x, w), 0.5f), 2.0f)
               : __fmul_rn(__fsub_rn(__fdiv_rn(y, h), 0.5f), 2.0f);
      dpdy = is_x ? 0.0f : dny;
      dpdx = is_x ? dnx : 0.0f;
    } else {
      float sp, cp;
      sincosf(phase_of(ch, y, x), &sp, &cp);
      const bool is_sin = (ch.code & 2) == 0;
      p = is_sin ? sp : cp;
      const float dproj = (is_sin ? cp : -sp) * __fdiv_rn(kTwoPi, ch.f);
      dpdy = dproj * ch.cth;
      dpdx = dproj * ch.sth;
    }
    const float* g = grad + (row0 + r) * KD + (ch.code >> 3);
    float dp = g[0];
    for (int b = 0; b < n_bands; ++b) {
      float sb, cb;
      sincosf(p * band[b], &sb, &cb);
      dp += band[b] * (g[(1 + 2 * b) * P] * cb - g[(2 + 2 * b) * P] * sb);
    }
    terms[2 * it] = dp * dpdy;
    terms[2 * it + 1] = dp * dpdx;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float sy = 0.0f, sx = 0.0f;
    for (int i = 0; i < KP; ++i) {
      sy += terms[2 * (r * KP + i)];
      sx += terms[2 * (r * KP + i) + 1];
    }
    dcoords[2 * (row0 + r)] = sy;
    dcoords[2 * (row0 + r) + 1] = sx;
  }
}

}  // namespace

namespace {

int launch_bwd(const float* grad, const float* coords, const float* angles,
               const float* periods, const float* bands, int n_bands,
               const float* scales, int n_scales, const float* offsets,
               int n_offsets, const float* angle_offsets, int n_angle_offsets,
               long long n, int k, float h, float w, const float* res, int nb,
               float* dcoords, void* stream) {
  if (n == 0) return 0;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const int P = 2 * (1 + n_scales * n_offsets * n_angle_offsets * 2);
  const int KP = k * P;
  // rows per block: at most two rounds of kMaxThreads items; threads split
  // the tile's items into equal rounds (15 rows of 66 items at K = 3: 2
  // rounds of 495 on 512 threads)
  const long long tile_rows = KP < 2 * kMaxThreads ? 2 * kMaxThreads / KP : 1;
  const long long items = tile_rows * KP;
  const long long rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = (int)(((items + rounds - 1) / rounds + 31) / 32 * 32);
  const size_t smem = (size_t)KP * sizeof(Channel) + n_bands * sizeof(float) +
                      (size_t)items * 2 * sizeof(float);
  if (smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + tile_rows - 1) / tile_rows;
  periodic_embed_bwd_kernel<<<dim3((unsigned)blocks, (unsigned)nb), threads,
                              smem, (cudaStream_t)stream>>>(
      grad, coords, angles, periods, bands, n_bands, scales, n_scales,
      offsets, n_offsets, angle_offsets, n_angle_offsets, n, k, h, w, res,
      (int)tile_rows, dcoords);
  return (int)cudaGetLastError();
}

int launch_fwd(const float* coords, const float* angles, const float* periods,
               const float* bands, int n_bands, const float* scales,
               int n_scales, const float* offsets, int n_offsets,
               const float* angle_offsets, int n_angle_offsets, long long n,
               int k, float h, float w, const float* res, int nb, void* out,
               int out_bf16, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define NPP_K1_ARGS                                                        \
  coords, angles, periods, bands, n_bands, scales, n_scales, offsets,      \
      n_offsets, angle_offsets, n_angle_offsets, n, k, h, w, res, nb
  const int status =
      out_bf16 ? launch(NPP_K1_ARGS, static_cast<__nv_bfloat16*>(out), st)
               : launch(NPP_K1_ARGS, static_cast<float*>(out), st);
#undef NPP_K1_ARGS
  return status;
}

}  // namespace

// dcoords (n, 2) float32: the gradient of the f32 embedding's loss in the
// coordinates, from grad (n, k * D) float32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int npp_periodic_embed_bwd(
    const float* grad, const float* coords, const float* angles,
    const float* periods, const float* bands, int n_bands,
    const float* scales, int n_scales, const float* offsets, int n_offsets,
    const float* angle_offsets, int n_angle_offsets, long long n, int k,
    float h, float w, float* dcoords, void* stream) {
  return launch_bwd(grad, coords, angles, periods, bands, n_bands, scales,
                    n_scales, offsets, n_offsets, angle_offsets,
                    n_angle_offsets, n, k, h, w, nullptr, 1, dcoords, stream);
}

// The batched backward: grad (nb, n, k * D), coords (nb, n, 2), angles and
// periods (nb, k, 2), res (nb, 2) = each image's (h, w), dcoords
// (nb, n, 2), all float32 on the card.
extern "C" int npp_periodic_embed_bwd_batched(
    const float* grad, const float* coords, const float* angles,
    const float* periods, const float* bands, int n_bands,
    const float* scales, int n_scales, const float* offsets, int n_offsets,
    const float* angle_offsets, int n_angle_offsets, const float* res,
    long long n, int k, int nb, float* dcoords, void* stream) {
  return launch_bwd(grad, coords, angles, periods, bands, n_bands, scales,
                    n_scales, offsets, n_offsets, angle_offsets,
                    n_angle_offsets, n, k, 0.0f, 0.0f, res, nb, dcoords,
                    stream);
}

// out: (n, k * D) float32 (out_bf16 = 0) or bfloat16 (out_bf16 = 1).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int npp_periodic_embed(
    const float* coords, const float* angles, const float* periods,
    const float* bands, int n_bands, const float* scales, int n_scales,
    const float* offsets, int n_offsets, const float* angle_offsets,
    int n_angle_offsets, long long n, int k, float h, float w, void* out,
    int out_bf16, void* stream) {
  return launch_fwd(coords, angles, periods, bands, n_bands, scales, n_scales,
                    offsets, n_offsets, angle_offsets, n_angle_offsets, n, k,
                    h, w, nullptr, 1, out, out_bf16, stream);
}

// The batched forward: coords (nb, n, 2), angles and periods (nb, k, 2),
// res (nb, 2) = each image's (h, w), out (nb, n, k * D); one launch.
extern "C" int npp_periodic_embed_batched(
    const float* coords, const float* angles, const float* periods,
    const float* bands, int n_bands, const float* scales, int n_scales,
    const float* offsets, int n_offsets, const float* angle_offsets,
    int n_angle_offsets, const float* res, long long n, int k, int nb,
    void* out, int out_bf16, void* stream) {
  return launch_fwd(coords, angles, periods, bands, n_bands, scales, n_scales,
                    offsets, n_offsets, angle_offsets, n_angle_offsets, n, k,
                    0.0f, 0.0f, res, nb, out, out_bf16, stream);
}
