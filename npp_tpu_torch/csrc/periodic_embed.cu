// K1: periodic warp + Fourier re-encode, one output row per coordinate.
//
// Replaces the XLA-fused `TaskEmbedder.embed` of npp_tpu/nn/embedder.py:87-162
// (periodic_warp -> fourier_encode, vmapped over the top-K proposals), which
// is also what the deleted Pallas kernel ops/fused_embed.py::_fused computed.
//
// Layout of one output row, D = P * (1 + 2F) per proposal, proposals major:
//   periodic channels p[0..P) = [norm_x, orient-0 (S*O*A*2), norm_y, orient-1]
//   with orient channels ordered scale -> offset -> angle offset -> (sin, cos);
//   then the Fourier layout [p, sin(f1 p), cos(f1 p), sin(f2 p), ...], each
//   block spanning all P channels (embedder.py:59-76,108-128,161-162).
//
// Bound: memory. Each thread reads 2 coordinates and writes 1 + 2F floats,
// so the output write (N * K * D * 4 bytes) is the whole cost: 1.09 GB for
// the 384x512 canvas table at K=3, F=10. Design: one thread per
// (row, proposal, periodic channel); the periodic channel is computed once
// in registers and its 2F Fourier values are written straight out, so no
// intermediate touches device memory. Neighbouring threads write
// neighbouring channels of one row.
//
// Numerics follow the plain version op by op: __f*_rn intrinsics stop nvcc
// from contracting into FMAs, the modulo is floored (p - f*floor(p/f), as
// jnp.mod; fmodf truncates and the projection is negative for angle 180),
// and sinf/cosf are the precise library functions, not __sinf.
#include <cuda_runtime.h>

namespace {

constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kTwoPi = 6.283185307179586f;

__global__ void periodic_embed_kernel(
    const float* __restrict__ coords, const float* __restrict__ angles,
    const float* __restrict__ periods, const float* __restrict__ bands,
    int n_bands, const float* __restrict__ scales, int n_scales,
    const float* __restrict__ offsets, int n_offsets,
    const float* __restrict__ angle_offsets, int n_angle_offsets,
    long long n, int k, float h, float w, float* __restrict__ out) {
  const int half = 1 + n_scales * n_offsets * n_angle_offsets * 2;
  const int P = 2 * half;
  const long long D = (long long)P * (1 + 2 * n_bands);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * k * P) return;
  const int c = (int)(t % P);
  const long long r = t / P;
  const int kk = (int)(r % k);
  const long long row = r / k;

  const float y = coords[2 * row];
  const float x = coords[2 * row + 1];
  const int orient = c < half ? 0 : 1;
  const int j = c - orient * half;
  float p;
  if (j == 0) {
    p = orient == 0 ? __fmul_rn(__fsub_rn(__fdiv_rn(x, w), 0.5f), 2.0f)
                    : __fmul_rn(__fsub_rn(__fdiv_rn(y, h), 0.5f), 2.0f);
  } else {
    int q = j - 1;
    const int fn = q & 1;
    q >>= 1;
    const int ia = q % n_angle_offsets;
    q /= n_angle_offsets;
    const int io = q % n_offsets;
    const int is = q / n_offsets;
    const float f = __fmul_rn(__fadd_rn(periods[2 * kk + orient], offsets[io]),
                              scales[is]);
    const float th = __fmul_rn(
        __fadd_rn(angles[2 * kk + orient], angle_offsets[ia]), kDeg2Rad);
    const float proj = __fadd_rn(__fmul_rn(y, cosf(th)), __fmul_rn(x, sinf(th)));
    const float m = __fsub_rn(proj, __fmul_rn(f, floorf(__fdiv_rn(proj, f))));
    const float phase = __fmul_rn(__fdiv_rn(m, f), kTwoPi);
    p = fn == 0 ? sinf(phase) : cosf(phase);
  }

  float* o = out + row * (D * k) + kk * D + c;
  o[0] = p;
  for (int b = 0; b < n_bands; ++b) {
    const float xf = __fmul_rn(p, bands[b]);
    o[(long long)(1 + 2 * b) * P] = sinf(xf);
    o[(long long)(2 + 2 * b) * P] = cosf(xf);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int npp_periodic_embed(
    const float* coords, const float* angles, const float* periods,
    const float* bands, int n_bands, const float* scales, int n_scales,
    const float* offsets, int n_offsets, const float* angle_offsets,
    int n_angle_offsets, long long n, int k, float h, float w, float* out,
    void* stream) {
  const int P = 2 * (1 + n_scales * n_offsets * n_angle_offsets * 2);
  const long long total = n * k * P;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  periodic_embed_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      coords, angles, periods, bands, n_bands, scales, n_scales, offsets,
      n_offsets, angle_offsets, n_angle_offsets, n, k, h, w, out);
  return (int)cudaGetLastError();
}
