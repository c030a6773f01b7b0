// K4 backward: gradient of the row-wise weighted Barron rho,
//
//   r[m] = sum_c w_c * rho(x[m, c], alpha_c, s_c),
//
// with respect to x, alpha and s, for the `loss_otherwise` branch of
// general_lossfun with its beta_safe / alpha_safe clamps. Replaces the
// XLA-fused backward of `nllfun`'s per-element rho
// (npp_tpu/losses/robust.py:63-81, 134-138). kernels/robust_rho.py::
// rho_bwd_plain is the same arithmetic in PyTorch, line by line.
//
// Bound: memory. x and g are read once and dx written once (78.6 MB at
// the LPIPS layer-1 shape 153,600 x 64); dalpha and ds are C values each.
// Design:
//  - the block walks its rows as one flat array, 256 threads x V values a
//    sweep, V = 4 (16-byte loads and stores) where C % 4 == 0, else 1. A
//    sweep covers whole rows (rows_per_sweep * C values), so every thread
//    sees the same V channels in every sweep and keeps their running
//    dalpha / ds sums in registers; the channels' constants are computed
//    once per block into shared memory. C = 3 runs 255 lanes.
//  - the grid is sized to fill the card once (as many blocks per SM as
//    fit, up to 8 of 256 threads) wherever M allows, with a whole number
//    of sweeps per block;
//  - per-channel sums are deterministic: registers, then one fixed-order
//    pass over shared memory, one f32 partial row per block, then a second
//    small kernel sums the partial rows in a fixed order. No atomics, no
//    float64, no reduction outside this file.
//  - wide rows (C above what one sweep holds: the style loss's flattened
//    Grams, 6 rows of up to 65,536): one thread per channel walks the M
//    rows, writes dx and sums dalpha and ds in registers in row order. No
//    partial buffer and no second kernel: (16 * SMs, C) partials would be
//    553 MB at C = 65,536.
//
// The alpha derivative in f32 without cancellation. With sq = (x/s)^2,
// beta = 2 - alpha, q = sq/beta, u = 1 + q, L = log1p(q), pw = u^(alpha/2):
//  - 0 < alpha < 1: with t = alpha L / 2 and phi(t) = t e^t - expm1(t),
//      drho/dalpha = 2 phi(t)/alpha^2 - L pw/2 + e q/2,   e = pw/u,
//    phi from its series sum_{n>=2} (n-1) t^n/n! for t < 0.5, so that
//    2 phi/alpha^2 = L^2/2 * poly(t) never divides by alpha^2;
//  - 1 <= alpha < 2: with e = pw/u = exp(-beta L/2),
//      drho/dalpha = (-e sq (2+alpha)/2 - 2 expm1(-beta L/2))/alpha^2
//                    + (beta + sq) e L/(2 alpha),
//    where the direct form's two terms of order q = sq/beta cancel;
//  - elsewhere (the clamps at alpha near 0 or 2, alpha outside (0, 2)):
//    the direct terms through beta_safe and alpha_safe, in f32.
// On both interior forms d rho/d sq = e/2, so dx = g w e z/s and
// ds = -g w e sq/s with z = x/s. Both interior forms take one expm1f, of
// t below alpha = 1 and of -beta L/2 above, so a warp over channels of
// both forms does not diverge on it; their one division, pw/u, is
// __fdividef's (2 ulp).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps
constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr int kFinishRows = 16;
constexpr int kUnroll = 4;   // sweeps whose loads are in flight together

// A channel's constants, as two float4 in shared memory:
// {alpha, beta_safe, 1/beta_safe, 1/alpha_safe}, {1/s, w, alpha/alpha_safe}.
__device__ __forceinline__ void channel_constants(const float* alpha,
                                                  const float* scale,
                                                  const float* w, int c,
                                                  float4& k0, float4& k1) {
  const float a = alpha[c];
  const float b = fmaxf(fabsf(a - 2.0f), kEps);
  const float asafe = (a >= 0.0f ? 1.0f : -1.0f) * fmaxf(fabsf(a), kEps);
  k0 = make_float4(a, b, 1.0f / b, 1.0f / asafe);
  // alpha/alpha_safe is 1 off the clamp
  k1 = make_float4(1.0f / scale[c], w[c], a / asafe, 0.0f);
}

// phi(t) / t^2 = sum_{n>=2} (n-1) t^(n-2) / n!, to 1e-8 relative at t < 0.5
__device__ __forceinline__ float phi_poly(float t) {
  float p = 1.0f / 403200.0f;
  p = fmaf(p, t, 1.0f / 45360.0f);
  p = fmaf(p, t, 1.0f / 5760.0f);
  p = fmaf(p, t, 1.0f / 840.0f);
  p = fmaf(p, t, 1.0f / 144.0f);
  p = fmaf(p, t, 1.0f / 30.0f);
  p = fmaf(p, t, 1.0f / 8.0f);
  p = fmaf(p, t, 1.0f / 3.0f);
  return fmaf(p, t, 0.5f);
}

// One element: returns dx, adds g w drho/dalpha and ds to the running sums.
__device__ __forceinline__ float element(float x, float g, float4 k0,
                                         float4 k1, float& acc_a,
                                         float& acc_s) {
  const float a = k0.x, b = k0.y, inv_b = k0.z, inv_a = k0.w;
  const float inv_s = k1.x, w = k1.y, a_over_asafe = k1.z;
  const float z = x * inv_s;
  const float sq = z * z;
  const float q = sq * inv_b;
  const float u = 1.0f + q;
  const float L = log1pf(q);
  float e, da;
  if (a > kEps && 2.0f - a > kEps) {
    // one expm1f for both forms, so that a warp over channels of either
    // form does not diverge on it
    const bool lo = a < 1.0f;
    const float t = 0.5f * a * L;
    const float em1 = expm1f(lo ? t : -0.5f * b * L);
    if (lo) {
      const float pw = 1.0f + em1;
      e = __fdividef(pw, u);
      const float two_phi_a2 = t < 0.5f
          ? 0.5f * L * L * phi_poly(t)
          : 2.0f * (t * pw - em1) * inv_a * inv_a;
      da = two_phi_a2 - 0.5f * L * pw + 0.5f * e * q;
    } else {
      e = 1.0f + em1;
      da = (-0.5f * e * sq * (2.0f + a) - 2.0f * em1) * inv_a * inv_a +
           (b + sq) * e * L * (0.5f * inv_a);
    }
  } else {   // the clamps, and alpha outside (0, 2): the direct terms
    const float em1 = expm1f(0.5f * a * L);
    const float pw = 1.0f + em1;
    e = pw / u;
    const float am2 = a - 2.0f;
    const float dbeta = am2 > kEps ? 1.0f : (am2 < -kEps ? -1.0f : 0.0f);
    const float dasafe = fabsf(a) > kEps ? 1.0f : 0.0f;
    const float dcoef = (dbeta * __frcp_rn(inv_a) - b * dasafe) *
                        inv_a * inv_a;
    const float dpw = pw * (0.5f * L - 0.5f * a * q * inv_b * dbeta / u);
    da = dcoef * em1 + b * inv_a * dpw;
  }
  const float gw = g * w;
  // g w d rho/d sq = g w (beta_safe/alpha_safe) (alpha/2) (pw/u)/beta_safe
  const float gsq2 = gw * a_over_asafe * e;   // twice that
  acc_a += gw * da;
  acc_s -= gsq2 * sq * inv_s;
  return gsq2 * z * inv_s;
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float get(const float& v, int) {
    return v;
  }
  static __device__ __forceinline__ void set(float& v, int, float f) {
    v = f;
  }
};
template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(float4& v, int i, float f) {
    if (i == 0) v.x = f; else if (i == 1) v.y = f;
    else if (i == 2) v.z = f; else v.w = f;
  }
};

// part: (2, gridDim.x, c) partial sums of dalpha and ds, one row per block.
// Three blocks per SM: at four (64 registers) the element's arithmetic
// spills, and the kernel ran slower at the LPIPS shapes on an H100
// (scripts/split_k4_bwd.py).
template <int V>
__global__ void __launch_bounds__(kThreads, 3)
rho_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
               const float* __restrict__ scale, const float* __restrict__ w,
               const float* __restrict__ g, float* __restrict__ dx,
               float* __restrict__ part, long long m, int c,
               long long rows_per_block) {
  using T = typename Vec<V>::type;
  __shared__ float sh_a[kThreads * V];
  __shared__ float sh_s[kThreads * V];
  extern __shared__ float4 consts[];   // 2 * c: see channel_constants
  const int rows_per_sweep = kThreads * V / c;
  const int lanes = rows_per_sweep * c / V;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_end = min(m, row0 + rows_per_block);

  for (int ch = tid; ch < c; ch += kThreads)
    channel_constants(alpha, scale, w, ch, consts[2 * ch], consts[2 * ch + 1]);
  __syncthreads();

  float acc_a[V], acc_s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc_a[v] = acc_s[v] = 0.0f;
  if (tid < lanes) {
    const int e0 = tid * V;          // this lane's offset within a sweep
    const int c0 = e0 % c;
    // kUnroll sweeps at a time: all their loads go out before their
    // arithmetic, so that enough bytes are in flight to cover the latency
    const long long step = (long long)rows_per_sweep * kUnroll;
    for (long long row = row0 + e0 / c; row < row_end; row += step) {
      T xv[kUnroll];
      float gv[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const long long r = row + (long long)i * rows_per_sweep;
        xv[i] = r < row_end ? *reinterpret_cast<const T*>(x + r * c + c0)
                            : T{};
        gv[i] = r < row_end ? g[r] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const long long r = row + (long long)i * rows_per_sweep;
        if (r >= row_end) break;
        T out;
#pragma unroll
        for (int v = 0; v < V; ++v)
          Vec<V>::set(out, v, element(Vec<V>::get(xv[i], v), gv[i],
                                      consts[2 * (c0 + v)],
                                      consts[2 * (c0 + v) + 1], acc_a[v],
                                      acc_s[v]));
        *reinterpret_cast<T*>(dx + r * c + c0) = out;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sh_a[e0 + v] = acc_a[v];
      sh_s[e0 + v] = acc_s[v];
    }
  }
  __syncthreads();
  // fixed order: channel ch sums its rows_per_sweep lane partials
  for (int ch = tid; ch < c; ch += kThreads) {
    float sa = 0.0f, ss = 0.0f;
    for (int r = 0; r < rows_per_sweep; ++r) {
      sa += sh_a[r * c + ch];
      ss += sh_s[r * c + ch];
    }
    part[(long long)blockIdx.x * c + ch] = sa;
    part[((long long)gridDim.x + blockIdx.x) * c + ch] = ss;
  }
}

// Sums the n_blocks partial rows per channel in a fixed order. Block
// (32, kFinishRows): lanes over 32 channels, rows of threads over blocks;
// blockIdx.y picks dalpha (0) or ds (1).
__global__ void rho_bwd_finish(const float* __restrict__ part, int n_blocks,
                               int c, float* __restrict__ da,
                               float* __restrict__ ds) {
  __shared__ float red[kFinishRows][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const float* src = part + (long long)blockIdx.y * n_blocks * c;
  float s = 0.0f;
  if (ch < c) {
    for (int b = threadIdx.y; b < n_blocks; b += kFinishRows)
      s += src[(long long)b * c + ch];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t = 0.0f;
    for (int r = 0; r < kFinishRows; ++r) t += red[r][threadIdx.x];
    (blockIdx.y == 0 ? da : ds)[ch] = t;
  }
}

// Wide rows: thread = channel; its M rows kUnroll at a time, their loads
// first. Coalesced across the warp (neighbouring channels).
__global__ void __launch_bounds__(kThreads)
rho_bwd_wide_kernel(const float* __restrict__ x,
                    const float* __restrict__ alpha,
                    const float* __restrict__ scale,
                    const float* __restrict__ w, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ da,
                    float* __restrict__ ds, long long m, int c) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  float4 k0, k1;
  channel_constants(alpha, scale, w, ch, k0, k1);
  float acc_a = 0.0f, acc_s = 0.0f;
  for (long long row = 0; row < m; row += kUnroll) {
    float xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long r = row + i;
      xv[i] = r < m ? __ldg(x + r * c + ch) : 0.0f;
      gv[i] = r < m ? __ldg(g + r) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long r = row + i;
      if (r < m) dx[r * c + ch] = element(xv[i], gv[i], k0, k1, acc_a, acc_s);
    }
  }
  da[ch] = acc_a;
  ds[ch] = acc_s;
}

// Resident blocks of rho_bwd_kernel<V> per SM, at most kMaxBlocksPerSm;
// asked of the runtime once per V and channel count (its shared memory).
template <int V>
int blocks_per_sm(int c) {
  static int cached[kThreads * 4 + 1] = {};
  int& n = cached[c];
  if (n == 0) {
    int got = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &got, rho_bwd_kernel<V>, kThreads, 2 * sizeof(float4) * c) !=
            cudaSuccess || got <= 0)
      got = 1;
    n = got < kMaxBlocksPerSm ? got : kMaxBlocksPerSm;
  }
  return n;
}

}  // namespace

// x, dx (m, c); alpha, scale, w, da, ds (c,); g (m,); part: scratch of at
// least 2 * 8 * sm_count * c floats where one sweep holds a whole row
// (c <= 1024 where c % 4 == 0 and x, dx are 16-byte aligned, else
// c <= 256); above that the wide kernel runs and part is not used (may be
// null). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int npp_robust_rho_bwd(const float* x, const float* alpha,
                                  const float* scale, const float* w,
                                  const float* g, float* dx, float* part,
                                  float* da, float* ds, long long m, int c,
                                  int sm_count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec4 = c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dx)) &
       15) == 0;
  const int V = vec4 ? 4 : 1;
  if (c <= 0 || m < 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  if (c > kThreads * V) {
    rho_bwd_wide_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        x, alpha, scale, w, g, dx, da, ds, m, c);
    return (int)cudaGetLastError();
  }
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float4) * c;
  const int per_sm = vec4 ? blocks_per_sm<4>(c) : blocks_per_sm<1>(c);
  const long long rows_per_sweep = kThreads * V / c;   // >= 1
  const long long sweeps = (m + rows_per_sweep - 1) / rows_per_sweep;
  const long long max_blocks = (long long)per_sm * sm_count;
  const long long per_block =
      (sweeps + max_blocks - 1) / max_blocks * rows_per_sweep;
  const int n_blocks =
      m == 0 ? 0 : (int)((m + per_block - 1) / per_block);
  if (n_blocks > 0) {
    if (vec4)
      rho_bwd_kernel<4><<<n_blocks, kThreads, smem, st>>>(
          x, alpha, scale, w, g, dx, part, m, c, per_block);
    else
      rho_bwd_kernel<1><<<n_blocks, kThreads, smem, st>>>(
          x, alpha, scale, w, g, dx, part, m, c, per_block);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  rho_bwd_finish<<<dim3((c + 31) / 32, 2), dim3(32, kFinishRows), 0, st>>>(
      part, n_blocks, c, da, ds);
  return (int)cudaGetLastError();
}
