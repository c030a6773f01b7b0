// K3: the contextual-loss (CX) similarity chain, forward and backward.
//
// For each sample n, rows p (source positions, xn) and columns q (target
// positions, yn), both mean-shifted and L2-normalised f32 rows of C values:
//
//   s_pq = xn_p . yn_q
//   d_pq = 1 - clamp(s_pq, 0, 1);  d_pq = 1e9 where fy_q = 0 (masked column)
//   m_p  = min_q d_pq
//   w_pq = exp((1 - d_pq / (m_p + 1e-5)) / h)
//   S_p  = sum_q w_pq
//   c_pq = w_pq / S_p
//   z_q  = max_p (fx_p * c_pq)
//
// with fx_p and fy_q one mask (feat_valid) read at row p and at column q
// (P = Q; both 1 without a mask).
//
// The output is z (N, Q). Replaces npp_tpu/losses/contextual.py:21-130, the
// cosine distance, relative distance, exp / row normalisation and masked
// column max that XLA fuses there (there is no pl.pallas_call in npp_tpu),
// and JAX's gradient of the same chain in xn and yn.
// kernels/cx_chain.py::cx_colmax_plain is the chain in PyTorch.
//
// Bound on an H100 SXM: operations. Each sweep below is one product of
// P x Q x C multiply-adds (2 N P Q C operations) against 495 TFLOP/s with
// TF32 tensor cores or 67 TFLOP/s in f32; the bytes the function must move
// are 2 N P C 4 in (xn, yn) and N Q 4 out, a few MB at the main paths'
// shapes. The chain's (N, P, Q) matrices, four of 61 MB at the flagship
// fit (6 x 1,600 x 1,600) and of 1.8 GB at the search's evaluation
// (3 x 12,288 x 12,288), are never written to device memory: each sweep
// recomputes its tile of s from xn and yn, which costs C = 256
// multiply-adds per element against the 16 bytes per element a stored
// matrix would move each way, and keeps a step's memory at its inputs.
//
// Design (simple first; wgmma and TMA are later work):
//  - a block of 4 warps owns a tile of 32 rows (or 32 columns) of one
//    sample, resident in shared memory, and streams the other operand's
//    32-row tiles through two cp.async buffers. The product's tile is
//    always 32 p x 32 q, each warp 16 x 16, and every tile of s starts at
//    a multiple of 32 in p and in q, so a given element s_pq is computed by
//    the same thread position with the same instructions in every sweep.
//  - blocks in flight: the flagship's 6 x 1,600 rows make only 300 blocks
//    of 32, about one wave at two blocks an SM (the shared memory, 100 KB a
//    block at C = 256, allows two). So `splits` blocks share a row's (or a
//    column's) streamed tiles, each over a contiguous part, and a small
//    kernel merges their partial terms in split order
//    (kernels/cx_chain.py::splits_for: 4 at the flagship, 1 at the
//    search's 3 x 12,288; it leaves no split without a tile, and a block
//    whose split is empty still waits for its own tile's copies before it
//    reuses the shared memory). The backward's products write partial
//    dxn / dyn that are summed in split order the same way.
//  - products: with TF32 on (torch.backends.cuda.matmul.allow_tf32 at the
//    forward's launch), mma.sync.m16n8k8 TF32 with the operands rounded by
//    cvt.rna; with it off, f32 FFMA tiles laid out like the mma fragments,
//    each element fmaf chains over chunks of 32 channels, added in order
//    (C is a multiple of 32). The backward
//    repeats the forward's precision (its recompute must give the
//    forward's values bit for bit). 3xTF32 (three TF32 products) was 1.45x
//    faster than the FFMA tiles but 3-4x further from float64 than the
//    plain f32 chain, so f32 keeps FFMA.
//  - the epilogue: w = ex2.approx(a0 - d rate) with a0 = log2(e) / h and the
//    row's rate = a0 / (m + 1e-5), and c = w times the row's 1 / S: one
//    fmaf and one MUFU op an element in place of two IEEE divisions and
//    expf. Its arithmetic is written with explicit fmaf / __fmul_rn /
//    __fadd_rn, never contracted, so d, w and c are the same bits in every
//    sweep.
//  - forward, three sweeps: (1) rows: m_p and l_p, the count of columns
//    tied at the min; (2) rows: S_p (the exponent depends on m_p
//    non-linearly, so (1) and (2) cannot merge online); (3) columns: z_q
//    and k_q, the count of rows tied at the max. Only m, l, S (N, P) and
//    z, k (N, Q) are stored.
//  - backward, given g = dL/dz, r_pq = [fx_p c_pq == z_q] g_q / k_q:
//      A_p = sum_q r c,  E_p = sum_q c d r,  F_p = sum_q c d  (valid q)
//      dL/dt_pq = -(fx_p / h) c_pq (r_pq - A_p)
//      B_p = dL/dm_p = fx_p (E_p - A_p F_p) / (h (m_p + 1e-5)^2)
//      dL/dd_pq = dL/dt_pq / (m_p + 1e-5) + [d_pq == m_p] B_p / l_p
//      G_pq = -dL/dd_pq [0 <= s_pq <= 1] [fy_q > 0]
//      dxn = G yn (rows own, q streamed), dyn = G^T xn (columns own)
//    one row sweep for A and B / l, then each product sweep recomputes its
//    tile of G into shared memory and multiplies it with the streamed tile
//    already there; dyn's sweep runs only when yn needs a gradient.
//
// What the design does about:
//  - exact ties: torch.amax / amin (and JAX's max / min) split the gradient
//    evenly among tied elements, and the fits' inputs (cx_pred * real_mask)
//    zero whole regions, so identical rows and columns are common. The
//    backward finds the ties by recomputing c and d and comparing them for
//    equality with the saved z and m, which the bit-identical sweeps above
//    make exact; l and k count the ties. m and z are exact min / max, S and
//    the backward's row sums are taken in a fixed order (registers in tile
//    order, a fixed shuffle tree, the two warps, then the splits in order):
//    no atomics anywhere, so a launch repeats bit for bit.
//  - masked samples: all columns masked gives d = 1e9 everywhere, m = 1e9,
//    t = 1, w = 1 (to a few ulp here), and with all rows masked z = 0, as
//    the plain chain gives;
//    a masked column is never the min of a partly valid row and its weight
//    exp(-huge) is exactly 0; a masked row's fx_p c_pq is 0 and wins no max
//    that a valid row's positive value takes.
//  - underflow: m_p = 0 makes t = d / 1e-5 and most w exactly 0; such
//    columns can have z_q = 0, where every row ties (k_q = P) and each gets
//    g_q / P, as amax's backward gives.
//  - ragged edges: P and Q need not be multiples of 32; tiles load zeros
//    past the edge (cp.async's zero fill) and the epilogues skip those rows
//    and columns. C is a multiple of 32 up to 512 (the wrapper checks);
//    dxn and dyn are written 256 columns a block.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // rows of an own or a streamed tile
constexpr int kThreads = 128;    // 4 warps, 2 x 2 over the 32 x 32 s tile
constexpr int kOutCols = 256;    // dxn / dyn columns of one block: 4 x 64
constexpr int kGld = kTile + 4;  // row stride of the G tile in shared memory
constexpr float kEps = 1e-5f;
constexpr float kMasked = 1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// the products' precision: f32 FFMA or TF32 tensor cores
enum Prec { kF32 = 0, kTF32 = 1 };

struct Chain {
  const float* x;    // (N, P, C) xn
  const float* y;    // (N, Q, C) yn
  const float* f;    // (N, P) mask of the rows and the columns, or null
  float* m;          // (N, P) row min of d
  int* l;            // (N, P) columns tied at the min
  float* s;          // (N, P) row sum of w
  float* z;          // (N, Q) column max of fx c
  int* k;            // (N, Q) rows tied at the max
  const float* g;    // (N, Q) dL/dz
  float* a;          // (N, P) A_p
  float* bl;         // (N, P) B_p / l_p
  float* dx;         // (N, P, C) or null
  float* dy;         // (N, Q, C) or null
  float* part;       // (splits, 3, N max(P, Q)) partial row / column terms
  int* partc;        // (splits, N max(P, Q)) partial counts
  float* gpart;      // (splits, N max(P, Q) C) partial dxn / dyn
  int n, p, q, c, splits;
  float h;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + kTile) of a (rows, C) matrix into shared memory with row
// stride C + 4; zeros past `rows`
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int C) {
  const int per_row = C / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * (C + 4) + 4 * v,
               ok ? src + static_cast<size_t>(r0 + r) * C + 4 * v : src, ok);
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores, the operands rounded to TF32
__device__ __forceinline__ void mma_step(float (&d)[4], const float (&a)[4],
                                         float b0, float b1) {
  const uint32_t ua[4] = {tf32(a[0]), tf32(a[1]), tf32(a[2]), tf32(a[3])};
  mma_tf32(d, ua, tf32(b0), tf32(b1));
}

// The thread's place in the 32 x 32 tile of s: warp (wr, wc) holds rows
// 16 wr + g + 8 i (i = 0, 1) and columns 16 wc + 8 j + 2 t + e (j, e = 0, 1)
// as acc[j][2 i + e], the layout of mma.m16n8k8's accumulators.
struct Lane {
  int g, t, r0, q0;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    r0 = (warp >> 1) * 16;
    q0 = (warp & 1) * 16;
  }
  __device__ __forceinline__ int row(int i) const { return r0 + g + 8 * i; }
  __device__ __forceinline__ int col(int j, int e) const {
    return q0 + 8 * j + 2 * t + e;
  }
};

// s of a 32 x 32 tile: xs holds its 32 xn rows, ys its 32 yn rows, each
// with stride ld; every element sums over c = 0 .. C-1 in the same order
// in every sweep
template <int PREC>
__device__ __forceinline__ void tile_product(float (&acc)[2][4],
                                             const float* xs, const float* ys,
                                             int ld, int C, const Lane& L) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  if constexpr (PREC == kTF32) {
    const float* ar = xs + (L.r0 + L.g) * ld + L.t;
    const float* b0r = ys + (L.q0 + L.g) * ld + L.t;
    const float* b1r = b0r + 8 * ld;
#pragma unroll 4
    for (int k0 = 0; k0 < C; k0 += 8) {
      const float a[4] = {ar[k0], ar[k0 + 8 * ld], ar[k0 + 4],
                          ar[k0 + 8 * ld + 4]};
      mma_step(acc[0], a, b0r[k0], b0r[k0 + 4]);
      mma_step(acc[1], a, b1r[k0], b1r[k0 + 4]);
    }
  } else {
    const float* a0 = xs + (L.r0 + L.g) * ld;
    const float* a1 = a0 + 8 * ld;
    const float* b00 = ys + (L.q0 + 2 * L.t) * ld;
    const float* b01 = b00 + ld;
    const float* b10 = b00 + 8 * ld;
    const float* b11 = b10 + ld;
    // chunks of 32 channels summed apart, then added: half the rounding
    // error of one chain over C, which at the search's 12,288 positions
    // had put z 1.9x further from float64 than the plain chain
    for (int k0 = 0; k0 < C; k0 += 32) {
      float part[2][4] = {};
      // two channels a load (8-byte shared loads, conflict-free at a
      // stride of C + 4), each element's fmaf still in channel order
#pragma unroll 4
      for (int k = k0; k < k0 + 32; k += 2) {
        const float2 u[2] = {*reinterpret_cast<const float2*>(a0 + k),
                             *reinterpret_cast<const float2*>(a1 + k)};
        const float2 v[4] = {*reinterpret_cast<const float2*>(b00 + k),
                             *reinterpret_cast<const float2*>(b01 + k),
                             *reinterpret_cast<const float2*>(b10 + k),
                             *reinterpret_cast<const float2*>(b11 + k)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float a = h ? u[i].y : u[i].x;
                const float b = h ? v[2 * j + e].y : v[2 * j + e].x;
                part[j][2 * i + e] = fmaf(a, b, part[j][2 * i + e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    }
  }
}

// out (32 rows x this warp's 64 of the block's 256 columns) += G (32 x 32,
// gs with stride kGld) times the streamed tile ms (32 rows of C, stride ld)
// at columns c0 + 64 warp ..
template <int PREC>
__device__ __forceinline__ void out_product(float (&o)[2][8][4],
                                            const float* gs, const float* ms,
                                            int ld, int C, int c0,
                                            const Lane& L) {
  const int cw = c0 + 64 * (threadIdx.x >> 5);
  if constexpr (PREC == kTF32) {
#pragma unroll
    for (int k0 = 0; k0 < kTile; k0 += 8) {
      float a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = gs + (16 * mi + L.g) * kGld + k0 + L.t;
        a[mi][0] = ar[0];
        a[mi][1] = ar[8 * kGld];
        a[mi][2] = ar[4];
        a[mi][3] = ar[8 * kGld + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (cw + 8 * ni < C) {
          const float* br = ms + (k0 + L.t) * ld + cw + 8 * ni + L.g;
          mma_step(o[0][ni], a[0], br[0], br[4 * ld]);
          mma_step(o[1][ni], a[1], br[0], br[4 * ld]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float u[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        u[mi][0] = gs[(16 * mi + L.g) * kGld + kk];
        u[mi][1] = gs[(16 * mi + L.g + 8) * kGld + kk];
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (cw + 8 * ni < C) {
          const float2 v = *reinterpret_cast<const float2*>(
              ms + kk * ld + cw + 8 * ni + 2 * L.t);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            o[mi][ni][0] = fmaf(u[mi][0], v.x, o[mi][ni][0]);
            o[mi][ni][1] = fmaf(u[mi][0], v.y, o[mi][ni][1]);
            o[mi][ni][2] = fmaf(u[mi][1], v.x, o[mi][ni][2]);
            o[mi][ni][3] = fmaf(u[mi][1], v.y, o[mi][ni][3]);
          }
        }
      }
    }
  }
}

// The chain's elementwise steps, the same bits in every sweep. A row's
// exponent is log2(e) (1 - d / (m + 1e-5)) / h = a0 - d rate with
// a0 = log2(e) / h and rate = a0 / (m + 1e-5), taken by one fmaf and
// ex2.approx; c = w / S is w times the row's 1 / S.
__device__ __forceinline__ float distance(float s, bool on) {
  return on ? __fsub_rn(1.0f, fminf(fmaxf(s, 0.0f), 1.0f)) : kMasked;
}

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float exponent_scale(float h) {
  return __fdiv_rn(kLog2e, h);
}

__device__ __forceinline__ float row_rate(float m, float a0) {
  return __fdiv_rn(a0, __fadd_rn(m, kEps));
}

__device__ __forceinline__ float weight(float d, float rate, float a0) {
  return exp2_approx(fmaf(-d, rate, a0));
}

__device__ __forceinline__ void merge_min(float& m, int& c, float m2,
                                          int c2) {
  const float lo = fminf(m, m2);
  c = (m == lo ? c : 0) + (m2 == lo ? c2 : 0);
  m = lo;
}

__device__ __forceinline__ void merge_max(float& m, int& c, float m2,
                                          int c2) {
  const float hi = fmaxf(m, m2);
  c = (m == hi ? c : 0) + (m2 == hi ? c2 : 0);
  m = hi;
}

// Row sweeps (a block owns 32 rows of xn and streams yn): kMin gives m and
// l; kSum gives S; kTerms gives A and B / l.
enum RowSweep { kMin = 0, kSum = 1, kTerms = 2 };

// The streamed tiles [t0, t1) of split blockIdx.z of nt tiles.
__device__ __forceinline__ void split_range(int nt, int splits, int& t0,
                                            int& t1) {
  const int per = (nt + splits - 1) / splits;
  t0 = min(nt, static_cast<int>(blockIdx.z) * per);
  t1 = min(nt, t0 + per);
}

// A row's sums (v0, v1, v2, cnt) made final: m and l, S, or A and B / l.
template <int MODE>
__device__ __forceinline__ void finish_row(const Chain& ch, size_t at,
                                           float v0, float v1, float v2,
                                           int cnt) {
  if (MODE == kMin) {
    ch.m[at] = v0;
    ch.l[at] = cnt;
  } else if (MODE == kSum) {
    ch.s[at] = v0;
  } else {
    const float me = __fadd_rn(ch.m[at], kEps);
    const float fr = ch.f ? ch.f[at] : 1.0f;
    const float B = fr * (v1 - v0 * v2) / (ch.h * me * me);
    ch.a[at] = v0;
    ch.bl[at] = B / static_cast<float>(ch.l[at]);
  }
}

template <int MODE, int PREC>
__global__ void __launch_bounds__(kThreads) row_sweep(Chain ch) {
  extern __shared__ __align__(16) float smem[];
  const int C = ch.c, ld = C + 4, P = ch.p, Q = ch.q, n = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  float* own = smem;
  float* buf[2] = {smem + kTile * ld, smem + 2 * kTile * ld};
  const float* X = ch.x + static_cast<size_t>(n) * P * C;
  const float* Y = ch.y + static_cast<size_t>(n) * Q * C;
  const float* fy = ch.f ? ch.f + static_cast<size_t>(n) * Q : nullptr;
  const Lane L;
  const float a0 = exponent_scale(ch.h);

  float rate[2] = {0.0f, 0.0f}, sinv[2] = {1.0f, 1.0f}, fr[2] = {1.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = p0 + L.row(i);
    if (MODE != kMin && p < P) {
      const size_t at = static_cast<size_t>(n) * P + p;
      rate[i] = row_rate(ch.m[at], a0);
      if (MODE == kTerms) {
        sinv[i] = __frcp_rn(ch.s[at]);
        if (ch.f) fr[i] = ch.f[at];
      }
    }
  }
  // kMin: (min, count); kSum: the sum; kTerms: A, E, F
  const float inf = __int_as_float(0x7f800000);
  float v0[2] = {MODE == kMin ? inf : 0.0f, MODE == kMin ? inf : 0.0f};
  float v1[2] = {0.0f, 0.0f}, v2[2] = {0.0f, 0.0f};
  int cnt[2] = {0, 0};

  const int nt = (Q + kTile - 1) / kTile;
  int t0, t1;
  split_range(nt, ch.splits, t0, t1);
  load_tile(own, X, p0, P, C);
  if (t0 < t1) load_tile(buf[0], Y, t0 * kTile, Q, C);
  cp_commit();
  for (int it = t0; it < t1; ++it) {
    const int b = (it - t0) & 1;
    if (it + 1 < t1) {
      load_tile(buf[b ^ 1], Y, (it + 1) * kTile, Q, C);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float acc[2][4];
    tile_product<PREC>(acc, own, buf[b], ld, C, L);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = it * kTile + L.col(j, e);
        if (q >= Q) continue;
        const bool on = fy == nullptr || fy[q] > 0.0f;
        if (MODE == kTerms && !on) continue;
        float zq = 0.0f, gk = 0.0f;
        if (MODE == kTerms) {
          const size_t at = static_cast<size_t>(n) * Q + q;
          zq = ch.z[at];
          gk = __fdiv_rn(ch.g[at], static_cast<float>(ch.k[at]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d = distance(acc[j][2 * i + e], on);
          if (MODE == kMin) {
            merge_min(v0[i], cnt[i], d, 1);
          } else if (MODE == kSum) {
            // compensated (Kahan) sum, v1 the lost low part: a row's S
            // adds a thread's 4 columns of every tile, 1,536 terms at
            // the search's 12,288 positions
            const float y = __fsub_rn(weight(d, rate[i], a0), v1[i]);
            const float t = __fadd_rn(v0[i], y);
            v1[i] = __fsub_rn(__fsub_rn(t, v0[i]), y);
            v0[i] = t;
          } else {
            const float c = __fmul_rn(weight(d, rate[i], a0), sinv[i]);
            const float r = __fmul_rn(fr[i], c) == zq ? gk : 0.0f;
            const float cd = __fmul_rn(c, d);
            v0[i] = __fadd_rn(v0[i], __fmul_rn(r, c));
            v1[i] = __fadd_rn(v1[i], __fmul_rn(cd, r));
            v2[i] = __fadd_rn(v2[i], cd);
          }
        }
      }
    }
    __syncthreads();
  }

  cp_wait<0>();   // an empty split's own tile may still be landing
  // the four lanes of a row (t), then the two warps of a row (wc), in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (MODE == kSum) {
      v0[i] = __fsub_rn(v0[i], v1[i]);
      v1[i] = 0.0f;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float o0 = __shfl_xor_sync(0xffffffffu, v0[i], off);
      if (MODE == kMin) {
        merge_min(v0[i], cnt[i], o0,
                  __shfl_xor_sync(0xffffffffu, cnt[i], off));
      } else {
        v0[i] = __fadd_rn(v0[i], o0);
        if (MODE == kTerms) {
          v1[i] = __fadd_rn(v1[i], __shfl_xor_sync(0xffffffffu, v1[i], off));
          v2[i] = __fadd_rn(v2[i], __shfl_xor_sync(0xffffffffu, v2[i], off));
        }
      }
    }
  }
  __syncthreads();
  float* red = smem;   // (3, 2, kTile) floats, then (2, kTile) ints
  int* redc = reinterpret_cast<int*>(smem + 6 * kTile);
  const int wc = (threadIdx.x >> 5) & 1;
  if (L.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = L.row(i);
      red[wc * kTile + r] = v0[i];
      red[(2 + wc) * kTile + r] = v1[i];
      red[(4 + wc) * kTile + r] = v2[i];
      redc[wc * kTile + r] = cnt[i];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kTile && p0 + r < P) {
    const size_t at = static_cast<size_t>(n) * P + p0 + r;
    float w0 = red[r], w1 = 0.0f, w2 = 0.0f;
    int c = redc[r];
    if (MODE == kMin) {
      merge_min(w0, c, red[kTile + r], redc[kTile + r]);
    } else {
      w0 = __fadd_rn(w0, red[kTile + r]);
      w1 = __fadd_rn(red[2 * kTile + r], red[3 * kTile + r]);
      w2 = __fadd_rn(red[4 * kTile + r], red[5 * kTile + r]);
    }
    if (ch.splits == 1) {
      finish_row<MODE>(ch, at, w0, w1, w2, c);
    } else {
      const size_t np = static_cast<size_t>(ch.n) * max(P, Q);
      float* part = ch.part + 3 * np * blockIdx.z;
      part[at] = w0;
      part[np + at] = w1;
      part[2 * np + at] = w2;
      ch.partc[np * blockIdx.z + at] = c;
    }
  }
}

// The column sweep (a block owns 32 columns of yn and streams xn): z, k.
template <int PREC>
__global__ void __launch_bounds__(kThreads) col_max(Chain ch) {
  extern __shared__ __align__(16) float smem[];
  const int C = ch.c, ld = C + 4, P = ch.p, Q = ch.q, n = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  float* own = smem;
  float* buf[2] = {smem + kTile * ld, smem + 2 * kTile * ld};
  const float* X = ch.x + static_cast<size_t>(n) * P * C;
  const float* Y = ch.y + static_cast<size_t>(n) * Q * C;
  const Lane L;
  const float a0 = exponent_scale(ch.h);

  bool on[2][2];
  float mx[2][2];
  int cnt[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + L.col(j, e);
      on[j][e] = q < Q && (ch.f == nullptr ||
                           ch.f[static_cast<size_t>(n) * Q + q] > 0.0f);
      mx[j][e] = -__int_as_float(0x7f800000);
      cnt[j][e] = 0;
    }

  const int nt = (P + kTile - 1) / kTile;
  int t0, t1;
  split_range(nt, ch.splits, t0, t1);
  load_tile(own, Y, q0, Q, C);
  if (t0 < t1) load_tile(buf[0], X, t0 * kTile, P, C);
  cp_commit();
  for (int it = t0; it < t1; ++it) {
    const int b = (it - t0) & 1;
    if (it + 1 < t1) {
      load_tile(buf[b ^ 1], X, (it + 1) * kTile, P, C);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float acc[2][4];
    tile_product<PREC>(acc, buf[b], own, ld, C, L);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = it * kTile + L.row(i);
      if (p >= P) continue;
      const size_t at = static_cast<size_t>(n) * P + p;
      const float rate = row_rate(ch.m[at], a0);
      const float sinv = __frcp_rn(ch.s[at]);
      const float fr = ch.f ? ch.f[at] : 1.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = distance(acc[j][2 * i + e], on[j][e]);
          const float c = __fmul_rn(weight(d, rate, a0), sinv);
          merge_max(mx[j][e], cnt[j][e], __fmul_rn(fr, c), 1);
        }
    }
    __syncthreads();
  }

  cp_wait<0>();   // an empty split's own tile may still be landing
  // the eight lanes of a column (g), then the two warps of a column (wr)
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off <= 16; off <<= 1)
        merge_max(mx[j][e], cnt[j][e],
                  __shfl_xor_sync(0xffffffffu, mx[j][e], off),
                  __shfl_xor_sync(0xffffffffu, cnt[j][e], off));
  __syncthreads();
  float* red = smem;
  int* redc = reinterpret_cast<int*>(smem + 2 * kTile);
  const int wr = threadIdx.x >> 6;
  if (L.g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[wr * kTile + L.col(j, e)] = mx[j][e];
        redc[wr * kTile + L.col(j, e)] = cnt[j][e];
      }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kTile && q0 + c < Q) {
    float hi = red[c];
    int k = redc[c];
    merge_max(hi, k, red[kTile + c], redc[kTile + c]);
    const size_t at = static_cast<size_t>(n) * Q + q0 + c;
    if (ch.splits == 1) {
      ch.z[at] = hi;
      ch.k[at] = k;
    } else {
      const size_t nq = static_cast<size_t>(ch.n) * max(P, Q);
      ch.part[3 * nq * blockIdx.z + at] = hi;
      ch.partc[nq * blockIdx.z + at] = k;
    }
  }
}

// The splits' partial rows (MODE of RowSweep) or columns (MODE = -1: max
// and count) merged in split order; one thread a row or column.
template <int MODE>
__global__ void merge_splits(Chain ch) {
  const size_t rows = static_cast<size_t>(ch.n) * (MODE < 0 ? ch.q : ch.p);
  const size_t at = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= rows) return;
  const size_t np = static_cast<size_t>(ch.n) * max(ch.p, ch.q);
  float v0 = ch.part[at], v1 = ch.part[np + at], v2 = ch.part[2 * np + at];
  int c = ch.partc[at];
  for (int z = 1; z < ch.splits; ++z) {
    const float* part = ch.part + 3 * np * z;
    const int cz = ch.partc[np * z + at];
    if (MODE < 0) {
      merge_max(v0, c, part[at], cz);
    } else if (MODE == kMin) {
      merge_min(v0, c, part[at], cz);
    } else {
      v0 = __fadd_rn(v0, part[at]);
      v1 = __fadd_rn(v1, part[np + at]);
      v2 = __fadd_rn(v2, part[2 * np + at]);
    }
  }
  if (MODE < 0) {
    ch.z[at] = v0;
    ch.k[at] = c;
  } else {
    finish_row<MODE>(ch, at, v0, v1, v2, c);
  }
}

// out[i] = sum over splits of gpart[z][i], in split order
__global__ void sum_splits(const float* gpart, float* out, size_t count,
                           int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = gpart[i];
  for (int z = 1; z < splits; ++z) v = __fadd_rn(v, gpart[count * z + i]);
  out[i] = v;
}

// One product sweep of the backward. OWN_ROWS: the block owns 32 rows of
// xn, streams yn and gives dxn = G yn; else it owns 32 columns of yn,
// streams xn and gives dyn = G^T xn. Each block makes 256 of the C
// columns (blockIdx.x's chunk) over its split of the streamed tiles.
template <bool OWN_ROWS, int PREC>
__global__ void __launch_bounds__(kThreads) grad_product(Chain ch,
                                                         int chunks) {
  extern __shared__ __align__(16) float smem[];
  const int C = ch.c, ld = C + 4, P = ch.p, Q = ch.q, n = blockIdx.y;
  const int o0 = (blockIdx.x / chunks) * kTile;
  const int c0 = (blockIdx.x % chunks) * kOutCols;
  float* own = smem;
  float* buf[2] = {smem + kTile * ld, smem + 2 * kTile * ld};
  float* gs = smem + 3 * kTile * ld;
  const float* X = ch.x + static_cast<size_t>(n) * P * C;
  const float* Y = ch.y + static_cast<size_t>(n) * Q * C;
  const Lane L;
  const float a0 = exponent_scale(ch.h);
  const float hinv = __frcp_rn(ch.h);

  // the rows' terms and the columns' (on, z, g / k); the own side's are
  // read once, the streamed side's every tile
  float rm[2], rrate[2], rsinv[2], rf[2], ra[2], rb[2], rk[2];
  bool con[2][2];
  float cz[2][2], cg[2][2];
  auto rows_at = [&](int base) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = base + L.row(i);
      rm[i] = -1.0f;   // marks a row past the edge
      if (p < P) {
        const size_t at = static_cast<size_t>(n) * P + p;
        rm[i] = ch.m[at];
        rrate[i] = row_rate(rm[i], a0);
        rsinv[i] = __frcp_rn(ch.s[at]);
        rf[i] = ch.f ? ch.f[at] : 1.0f;
        ra[i] = ch.a[at];
        rb[i] = ch.bl[at];
        // dL/dd = -(fx / h) c (r - A) / (m + 1e-5) + [d = m] B / l
        rk[i] = rf[i] * hinv / __fadd_rn(rm[i], kEps);
      }
    }
  };
  auto cols_at = [&](int base) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = base + L.col(j, e);
        const size_t at = static_cast<size_t>(n) * Q + q;
        con[j][e] = q < Q && (ch.f == nullptr || ch.f[at] > 0.0f);
        if (con[j][e]) {
          cz[j][e] = ch.z[at];
          cg[j][e] = __fdiv_rn(ch.g[at], static_cast<float>(ch.k[at]));
        }
      }
  };
  if (OWN_ROWS) rows_at(o0); else cols_at(o0);

  float o[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][ni][e] = 0.0f;

  const float* own_src = OWN_ROWS ? X : Y;
  const float* other = OWN_ROWS ? Y : X;
  const int own_rows = OWN_ROWS ? P : Q, other_rows = OWN_ROWS ? Q : P;
  const int nt = (other_rows + kTile - 1) / kTile;
  int t0, t1;
  split_range(nt, ch.splits, t0, t1);
  load_tile(own, own_src, o0, own_rows, C);
  if (t0 < t1) load_tile(buf[0], other, t0 * kTile, other_rows, C);
  cp_commit();
  for (int it = t0; it < t1; ++it) {
    const int b = (it - t0) & 1;
    if (it + 1 < t1) {
      load_tile(buf[b ^ 1], other, (it + 1) * kTile, other_rows, C);
      cp_commit();
    }
    if (OWN_ROWS) cols_at(it * kTile); else rows_at(it * kTile);
    if (it + 1 < t1) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();
    const float* cur = buf[b];
    float acc[2][4];
    tile_product<PREC>(acc, OWN_ROWS ? own : cur, OWN_ROWS ? cur : own, ld,
                       C, L);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = acc[j][2 * i + e];
          float gv = 0.0f;
          if (rm[i] >= 0.0f && con[j][e] && s >= 0.0f && s <= 1.0f) {
            const float d = distance(s, true);
            const float c = __fmul_rn(weight(d, rrate[i], a0), rsinv[i]);
            const float r = __fmul_rn(rf[i], c) == cz[j][e] ? cg[j][e] : 0.0f;
            gv = rk[i] * c * (r - ra[i]) - (d == rm[i] ? rb[i] : 0.0f);
          }
          const int pr = L.row(i), qc = L.col(j, e);
          gs[OWN_ROWS ? pr * kGld + qc : qc * kGld + pr] = gv;
        }
    __syncthreads();
    out_product<PREC>(o, gs, cur, ld, C, c0, L);
    __syncthreads();
  }

  cp_wait<0>();   // an empty split's own tile may still be landing
  const size_t count = static_cast<size_t>(ch.n) * own_rows * C;
  float* out = ch.splits == 1 ? (OWN_ROWS ? ch.dx : ch.dy)
                              : ch.gpart + count * blockIdx.z;
  out += static_cast<size_t>(n) * own_rows * C;
  const int cw = c0 + 64 * (threadIdx.x >> 5);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = o0 + 16 * mi + L.g + 8 * half;
      if (row >= own_rows) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = cw + 8 * ni + 2 * L.t;
        if (col < C)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * C +
                                     col) =
              make_float2(o[mi][ni][2 * half], o[mi][ni][2 * half + 1]);
      }
    }
}

size_t sweep_smem(int c) { return 3ull * kTile * (c + 4) * sizeof(float); }

int tiles(int rows) { return (rows + kTile - 1) / kTile; }

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t merge(const Chain& ch, cudaStream_t stream) {
  if (ch.splits == 1) return cudaSuccess;
  const int rows = ch.n * (MODE < 0 ? ch.q : ch.p);
  merge_splits<MODE><<<(rows + 255) / 256, 256, 0, stream>>>(ch);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t forward(const Chain& ch, cudaStream_t stream) {
  const size_t smem = sweep_smem(ch.c);
  const dim3 rows(tiles(ch.p), ch.n, ch.splits);
  cudaError_t err = launch(row_sweep<kMin, PREC>, rows, smem, stream, ch);
  if (err == cudaSuccess) err = merge<kMin>(ch, stream);
  if (err == cudaSuccess)
    err = launch(row_sweep<kSum, PREC>, rows, smem, stream, ch);
  if (err == cudaSuccess) err = merge<kSum>(ch, stream);
  if (err == cudaSuccess)
    err = launch(col_max<PREC>, dim3(tiles(ch.q), ch.n, ch.splits), smem,
                 stream, ch);
  if (err == cudaSuccess) err = merge<-1>(ch, stream);
  return err;
}

template <bool OWN_ROWS, int PREC>
cudaError_t product(const Chain& ch, cudaStream_t stream) {
  const size_t smem = sweep_smem(ch.c) + kTile * kGld * sizeof(float);
  const int chunks = (ch.c + kOutCols - 1) / kOutCols;
  const int own_rows = OWN_ROWS ? ch.p : ch.q;
  cudaError_t err = launch(grad_product<OWN_ROWS, PREC>,
                           dim3(tiles(own_rows) * chunks, ch.n, ch.splits),
                           smem, stream, ch, chunks);
  if (err != cudaSuccess || ch.splits == 1) return err;
  const size_t count = static_cast<size_t>(ch.n) * own_rows * ch.c;
  sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      ch.gpart, OWN_ROWS ? ch.dx : ch.dy, count, ch.splits);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t backward(const Chain& ch, cudaStream_t stream) {
  cudaError_t err = launch(row_sweep<kTerms, PREC>,
                           dim3(tiles(ch.p), ch.n, ch.splits),
                           sweep_smem(ch.c), stream, ch);
  if (err == cudaSuccess) err = merge<kTerms>(ch, stream);
  if (err == cudaSuccess && ch.dx) err = product<true, PREC>(ch, stream);
  if (err == cudaSuccess && ch.dy) err = product<false, PREC>(ch, stream);
  return err;
}

cudaError_t run(const Chain& ch, int prec, bool fwd, cudaStream_t stream) {
  if (prec == kTF32)
    return fwd ? forward<kTF32>(ch, stream) : backward<kTF32>(ch, stream);
  return fwd ? forward<kF32>(ch, stream) : backward<kF32>(ch, stream);
}

}  // namespace

extern "C" {

// z, k (N, Q) and m, l, s (N, P) of the chain; f may be null. prec:
// 0 f32, 1 TF32. With splits > 1, part (splits, 3, N max(P, Q))
// and partc (splits, N max(P, Q)) are scratch.
int npp_cx_chain_fwd(const float* x, const float* y, const float* f,
                     float* m, int* l, float* s, float* z,
                     int* k, float* part, int* partc, int n, int p, int q,
                     int c, int splits, float h, int prec, void* stream) {
  const Chain ch{x, y, f, m, l, s, z, k, nullptr, nullptr, nullptr,
                 nullptr, nullptr, part, partc, nullptr, n, p, q, c, splits,
                 h};
  return static_cast<int>(run(ch, prec, true,
                              static_cast<cudaStream_t>(stream)));
}

// dx (N, P, C) and dy (N, Q, C) from g = dL/dz (N, Q) and the forward's
// m, l, s, z, k (the same prec and splits); a, bl (N, P) are scratch, and
// with splits > 1 part, partc and gpart (splits, N max(P, Q) C); dx or dy
// may be null (not wanted).
int npp_cx_chain_bwd(const float* x, const float* y, const float* f,
                     float* m, int* l, float* s, float* z,
                     int* k, const float* g, float* a, float* bl, float* dx,
                     float* dy, float* part, int* partc, float* gpart, int n,
                     int p, int q, int c, int splits, float h, int prec,
                     void* stream) {
  const Chain ch{x, y, f, m, l, s, z, k, g, a, bl, dx, dy, part, partc,
                 gpart, n, p, q, c, splits, h};
  return static_cast<int>(run(ch, prec, false,
                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
