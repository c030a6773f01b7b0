// K3: the contextual-loss (CX) similarity chain, forward and backward.
//
// For each sample n, rows p (source positions, x) and columns q (target
// positions, y):
//
//   s_pq = x_p . y_q        (cosine, l2; l1: s_pq = x_p - y_q of the
//                            channel sums, no product)
//   d_pq = 1 - clamp(s_pq, 0, 1)               cosine (x, y normalised)
//          max(|y_q|^2 - 2 s_pq + |x_p|^2, 0)  l2
//          |s_pq|                              l1
//   d_pq = 1e9 where fy_q = 0 (masked column)
//   m_p  = min_q d_pq
//   w_pq = exp((1 - d_pq / (m_p + 1e-5)) / h)
//   S_p  = sum_q w_pq
//   c_pq = w_pq / S_p
//   z_q  = max_p (fx_p * c_pq)
//
// with fx_p and fy_q one mask (feat_valid) read at row p and at column q
// (P = Q; both 1 without a mask). The output is z (N, Q). Replaces
// npp_tpu/losses/contextual.py:21-130, the three distances, the relative
// distance, exp / row normalisation and masked column max that XLA fuses
// there (there is no pl.pallas_call in npp_tpu), and JAX's gradient of the
// chain. kernels/cx_chain.py holds the chain in PyTorch (the plain
// versions) and the wrapper that allocates every buffer named below.
//
// Bound on an H100 SXM: operations. The forward is one product of
// P x Q x C multiply-adds (2 N P Q C operations), the backward two, against
// 495 TFLOP/s with TF32 tensor cores or 67 TFLOP/s in f32; the bytes the
// function must move (x, y in, z out; the backward x, y, g in, dx, dy out)
// are a few MB at the main paths' shapes.
//
// Design: s once, in device memory.
//  - the forward computes s with one product into an f32 scratch of
//    N P ld floats (ld = Q rounded up to 32; 61 MB at the flagship fit's
//    6 x 1,600 x 1,600, 1.81 GB at the search's 3 x 12,288), then reads it
//    in three memory-bound passes: a warp a row for m_p and l_p (the
//    columns tied at the min), then S_p (the exponent depends on m_p
//    non-linearly, so the two cannot merge online: the row is read twice,
//    the second time mostly from L1 / L2); blocks of 64 rows x 256 columns
//    for the partial column maxima with their tie counts, merged in a
//    last pass. The wrapper keeps s for the backward only when x or y
//    needs a gradient.
//  - the backward reads the saved s: a warp a row for A_p, E_p, F_p, then
//    32 x 32 tiles that write G = dL/ds (and G^T through shared memory)
//    into two more N P ld scratches, then dx = G y and dy = G^T x as two
//    products. G is written to device memory, not formed in the
//    products' operand loads, because the TF32 wgmma takes K-major
//    operands only and G is the K-major A operand of both products in two
//    orientations (q contiguous for dx, p for dy); y and x enter as
//    transposed copies (N, C, ld) so that they are K-major B operands.
//  - products (gemm below, C = A B^T with both operands K-major): with
//    TF32 on (torch.backends.cuda.matmul.allow_tf32 at the forward's
//    launch), 128 x 128 tiles of two warpgroups, wgmma.m64n128k8 TF32 from
//    a ring of three 32-channel stages that TMA fills (128-byte swizzle,
//    zero fill past the edges), two blocks an SM. wgmma reads a TF32
//    operand by dropping an f32's low mantissa bits, so every operand is
//    rounded to TF32 (cvt.rna, as cuBLAS and the tests assume) once, in
//    the staged copies of x and y and in G as it is written: no cvt in an
//    inner loop. With TF32 off, FFMA tiles of 128 x 128 for 256 threads,
//    8 x 8 outputs a thread from 16-byte shared loads, each element summing
//    its chunks of 32 channels apart and adding them in order (the f32 z
//    met its float64 bar at 12,288 positions only so). The backward
//    repeats the forward's precision.
//  - the elementwise steps (distance, row_rate, weight below) are written
//    with explicit fmaf / __fmul_rn / __fadd_rn, never contracted, and
//    every pass reads the same stored bits of s, so d, w and c are the same
//    bits in every pass. w = ex2.approx(a0 - d rate) with a0 = log2(e) / h
//    and the row's rate = a0 / (m + 1e-5), c = w times the row's 1 / S.
//  - backward, given g = dL/dz, r_pq = [fx_p c_pq == z_q] g_q / k_q:
//      A_p = sum_q r c,  E_p = sum_q c d r,  F_p = sum_q c d  (valid q)
//      dL/dt_pq = -(fx_p / h) c_pq (r_pq - A_p)
//      B_p = dL/dm_p = fx_p (E_p - A_p F_p) / (h (m_p + 1e-5)^2)
//      dL/dd_pq = dL/dt_pq / (m_p + 1e-5) + [d_pq == m_p] B_p / l_p
//    then dL/ds = -dL/dd [0 <= s <= 1] (cosine), -2 dL/dd [raw >= 0]
//    (l2: the norm terms -x_p sum_q dL/ds and -y_q sum_p dL/ds are added by
//    the wrapper from the partial sums rsum / csum), and for l1 the
//    channel sums' gradients -sum_q dL/dd sgn s and sum_p dL/dd sgn s from
//    the same partial sums, with no product; the masks are torch.clamp's.
//
// What the design does about:
//  - exact ties: torch.amax / amin (and JAX's max / min) split the gradient
//    evenly among tied elements, and the fits' inputs (cx_pred * real_mask)
//    zero whole regions, so identical rows and columns are common. The
//    backward finds the ties by recomputing c and d from the stored s and
//    comparing them for equality with the saved z and m; l and k count the
//    ties. m and z are exact min / max, S and the backward's row sums are
//    taken in a fixed order (a lane's columns in order, a fixed butterfly
//    over the warp), the column maxima merge in chunk order: no atomics,
//    so a launch repeats bit for bit.
//  - masked samples: all columns masked gives d = 1e9 everywhere, m = 1e9,
//    t = 1, w = 1 (to a few ulp), and with all rows masked z = 0, as the
//    plain chain gives; a masked column is never the min of a partly valid
//    row and its weight exp(-huge) is exactly 0; a masked row's fx_p c_pq
//    is 0 and wins no max that a valid row's positive value takes.
//  - underflow: m_p = 0 makes t = d / 1e-5 and most w exactly 0; such
//    columns can have z_q = 0, where every row ties (k_q = P) and each gets
//    g_q / P, as amax's backward gives.
//  - ragged edges: P and Q need not be multiples of 32. TMA and the FFMA
//    loads fill zeros past the rows; the scratches' pitches ld and ldt are
//    Q and P rounded up to 32, and the columns between the edge and the
//    pitch of G, G^T and the transposed copies are written as zeros, so a
//    product's last chunk of channels reads zeros there. C is a multiple
//    of 32 up to 512 (the wrapper checks).
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

// mirrors kernels/cx_chain.py::_Args field for field (outside the
// unnamed namespace: the exported functions take it)
struct CxArgs {
  const float* x;    // (N, P, C) rows of x (xn; l2's raw rows); l1: (N, P)
  const float* y;    // (N, Q, C); l1: (N, Q) channel sums
  const float* xx;   // l2: (N, P) |x_p|^2, else null
  const float* yy;   // l2: (N, Q) |y_q|^2
  const float* f;    // (N, P) mask of the rows and the columns, or null
  float* xs;         // forward TF32: (N, P, C) x rounded; backward: (N, C,
                     // ldt) x^T (rounded with TF32); else null
  float* ys;         // forward TF32: (N, Q, C); backward: (N, C, ld) y^T
  float* s;          // (N, P, ld) s
  float* m;          // (N, P) row min of d
  int* l;            // (N, P) columns tied at the min
  float* sum;        // (N, P) row sum of w
  float* z;          // (N, Q) column max of fx c
  int* k;            // (N, Q) rows tied at the max
  float* cmax;       // (chunks, N, Q) partial column maxima
  int* ccnt;         // (chunks, N, Q) their tie counts
  const float* g;    // (N, Q) dL/dz
  float* a;          // (N, P) A_p
  float* bl;         // (N, P) B_p / l_p
  float* gx;         // (N, P, ld) G = dL/ds, or null
  float* gy;         // (N, Q, ldt) G^T, or null
  float* rsum;       // l2, l1: (N, P, ld / 32) partial row sums, else null
  float* csum;       // l2, l1: (N, Q, ldt / 32) partial column sums
  float* dx;         // (N, P, C) or null
  float* dy;         // (N, Q, C) or null
  int n, p, q, c, ld, ldt, mode, prec;
  float h;
};

namespace {

constexpr float kEps = 1e-5f;
constexpr float kMasked = 1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kColRows = 64;    // rows of s a block of the column pass reads
constexpr int kColThreads = 256;
constexpr int kRowWarps = 8;    // rows (a warp each) of a row-pass block
constexpr int kTile = 32;       // the G pass's and the transposes' tiles

// the products' tiles: 128 x 128 outputs, 32 channels a stage
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kBK * 4;
constexpr int kTmaSmem = kStages * kStageBytes + 1024 + 64;

enum Mode { kCosine = 0, kL2 = 1, kL1 = 2 };
enum Prec { kF32 = 0, kTF32 = 1 };


// ---- the chain's elementwise steps, the same bits in every pass

__device__ __forceinline__ float l2_raw(float s, float xx, float yy) {
  return __fadd_rn(__fsub_rn(yy, __fmul_rn(2.0f, s)), xx);
}

template <int MODE>
__device__ __forceinline__ float distance(float s, bool on, float xx,
                                          float yy) {
  if (!on) return kMasked;
  if (MODE == kCosine) return __fsub_rn(1.0f, fminf(fmaxf(s, 0.0f), 1.0f));
  if (MODE == kL2) return fmaxf(l2_raw(s, xx, yy), 0.0f);
  return fabsf(s);
}

// where the distance's clamp passes the gradient (torch.clamp's backward)
template <int MODE>
__device__ __forceinline__ bool passes(float s, float xx, float yy) {
  if (MODE == kCosine) return s >= 0.0f && s <= 1.0f;
  if (MODE == kL2) return l2_raw(s, xx, yy) >= 0.0f;
  return true;
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

__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---- staging: TF32 copies and transposed copies of the operands

// dst[i] = src[i] rounded to TF32, count a multiple of 4
__global__ void cx_round_copy(const float* src, float* dst, size_t count4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const float4 v = reinterpret_cast<const float4*>(src)[i];
  reinterpret_cast<float4*>(dst)[i] =
      make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                  tf32_round(v.w));
}

// dst (N, C, ldr) = src (N, R, C) transposed, zeros for r in [R, ldr),
// rounded to TF32 with `to_tf32`; block (32, 8), grid (ldr / 32, C / 32, N)
__global__ void cx_transpose(const float* src, float* dst, int R, int C,
                              int ldr, int to_tf32) {
  __shared__ float t[kTile][kTile + 1];
  const int n = blockIdx.z, r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const float* S = src + static_cast<size_t>(n) * R * C;
  float* D = dst + static_cast<size_t>(n) * C * ldr;
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int r = r0 + i;
    const float v = r < R ? S[static_cast<size_t>(r) * C + c0 + threadIdx.x]
                          : 0.0f;
    t[i][threadIdx.x] = to_tf32 ? tf32_round(v) : v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += 8)
    D[static_cast<size_t>(c0 + i) * ldr + r0 + threadIdx.x] =
        t[threadIdx.x][i];
}

// l1's s_pq = x_p - y_q; grid (ceil(Q / 256), P, N)
__global__ void cx_l1_fill(CxArgs a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.z, row = n * a.p + blockIdx.y;
  if (q >= a.q) return;
  a.s[static_cast<size_t>(row) * a.ld + q] =
      __fsub_rn(a.x[row], a.y[static_cast<size_t>(n) * a.q + q]);
}

// ---- products: out (batch, M, ldo) = A (batch, M, K) B (batch, Ncols, K)^T

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// a (32 channels x rows) box of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k0, int row0,
                                         int n) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k0),
      "r"(row0), "r"(n)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile written by TMA with
// the 128-byte swizzle: rows of 128 bytes (32 TF32 values), groups of 8
// rows 1,024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's rows) += A (64 x 8) B (128 x 8)^T in TF32
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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

// The TF32 product. Block: two warpgroups, rows [64 wg, 64 wg + 64) of
// the block's 128; thread 0 keeps the next stages' TMA loads in flight
// while both warpgroups run wgmma on the stage that has landed.
__global__ void __launch_bounds__(kGemmThreads, 2)
    cx_gemm_tf32(const __grid_constant__ CUtensorMap ma,
              const __grid_constant__ CUtensorMap mb, float* out, int M,
              int ncols, int K, int ldo) {
  extern __shared__ __align__(16) unsigned char raw[];
  // the 128-byte swizzle wants its tiles on 1,024-byte boundaries
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  const int n = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk = (K + kBK - 1) / kBK;
  auto stage_a = [&](int s) { return base + s * kStageBytes; };
  auto stage_b = [&](int s) { return base + s * kStageBytes + kBM * kBK * 4; };
  auto load_stage = [&](int s, int kt) {
    mbar_expect_tx(&full[s], kStageBytes);
    tma_load(stage_a(s), &ma, &full[s], kt * kBK, m0, n);
    tma_load(stage_b(s), &mb, &full[s], kt * kBK, n0, n);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < nk; ++s) load_stage(s, s);

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t a0 = smem_addr(stage_a(s)) + wg * 64 * kBK * 4;
    const uint32_t b0 = smem_addr(stage_b(s));
    acc_fence(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      wgmma_tf32(d, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    acc_fence(d);
    __syncthreads();   // both warpgroups are done with stage s
    if (tid == 0 && kt + kStages < nk) load_stage(s, kt + kStages);
  }

  // thread (warp w of the warpgroup, lane): rows 16 w + lane / 4 + 8 i,
  // columns 8 j + 2 (lane % 4) + e as d[4 j + 2 i + e]
  const int lane = tid & 31, w = (tid >> 5) & 3;
  float* O = out + static_cast<size_t>(n) * M * ldo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wg * 64 + 16 * w + (lane >> 2) + 8 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < ncols)
        *reinterpret_cast<float2*>(O + static_cast<size_t>(row) * ldo + col) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}

// The f32 product: 256 threads, thread (ty, tx) of 16 x 16 owns rows
// 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j. Each
// stage of 32 channels is summed apart and then added (chunks of 32).
__global__ void __launch_bounds__(kGemmThreads, 1)
    cx_gemm_f32(const float* A, const float* B, float* out, int M, int ncols,
             int K, int lda, int ldb, int ldo) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int n = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, kc = (tid >> 5) * 4;   // load: row lane + 32 i
  const float* Ab = A + static_cast<size_t>(n) * M * lda;
  const float* Bb = B + static_cast<size_t>(n) * ncols * ldb;
  const int nk = (K + kBK - 1) / kBK;
  float4 ra[4], rb[4];
  auto load = [&](int kt) {
    const int k = kt * kBK + kc;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane + 32 * i;
      ra[i] = (m0 + r < M && k < K)
                  ? *reinterpret_cast<const float4*>(
                        Ab + static_cast<size_t>(m0 + r) * lda + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rb[i] = (n0 + r < ncols && k < K)
                  ? *reinterpret_cast<const float4*>(
                        Bb + static_cast<size_t>(n0 + r) * ldb + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane + 32 * i;
      As[kc][r] = ra[i].x;
      As[kc + 1][r] = ra[i].y;
      As[kc + 2][r] = ra[i].z;
      As[kc + 3][r] = ra[i].w;
      Bs[kc][r] = rb[i].x;
      Bs[kc + 1][r] = rb[i].y;
      Bs[kc + 2][r] = rb[i].z;
      Bs[kc + 3][r] = rb[i].w;
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1);
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }
  float* O = out + static_cast<size_t>(n) * M * ldo;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      if (col < ncols)
        *reinterpret_cast<float4*>(O + static_cast<size_t>(row) * ldo + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---- the passes over s

// the column terms of one column: on, and l2's |y_q|^2
struct Col {
  bool on;
  float yy;
};

template <int MODE>
__device__ __forceinline__ Col column(const CxArgs& a, int n, int q) {
  const size_t at = static_cast<size_t>(n) * a.q + q;
  return Col{a.f == nullptr || a.f[at] > 0.0f,
             MODE == kL2 ? a.yy[at] : 0.0f};
}

// Forward rows, a warp a row: m, l, then S (compensated).
template <int MODE>
__global__ void __launch_bounds__(32 * kRowWarps) cx_row_stats(CxArgs a) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= a.n * a.p) return;
  const int lane = threadIdx.x & 31, n = row / a.p, Q = a.q;
  const float* sr = a.s + static_cast<size_t>(row) * a.ld;
  const float xx = MODE == kL2 ? a.xx[row] : 0.0f;
  const float a0 = exponent_scale(a.h);
  float mn = __int_as_float(0x7f800000);
  int cnt = 0;
  for (int q = lane; q < Q; q += 32) {
    const Col c = column<MODE>(a, n, q);
    merge_min(mn, cnt, distance<MODE>(sr[q], c.on, xx, c.yy), 1);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    merge_min(mn, cnt, __shfl_xor_sync(0xffffffffu, mn, off),
              __shfl_xor_sync(0xffffffffu, cnt, off));
  const float rate = row_rate(mn, a0);
  // compensated (Kahan) sum, lo the lost low part: a lane adds Q / 32
  // terms, 384 at the search's 12,288 positions
  float hi = 0.0f, lo = 0.0f;
  for (int q = lane; q < Q; q += 32) {
    const Col c = column<MODE>(a, n, q);
    const float v = __fsub_rn(
        weight(distance<MODE>(sr[q], c.on, xx, c.yy), rate, a0), lo);
    const float t = __fadd_rn(hi, v);
    lo = __fsub_rn(__fsub_rn(t, hi), v);
    hi = t;
  }
  const float S = warp_sum(__fsub_rn(hi, lo));
  if (lane == 0) {
    a.m[row] = mn;
    a.l[row] = cnt;
    a.sum[row] = S;
  }
}

// Partial column maxima: block (column block, chunk of kColRows rows, n).
template <int MODE>
__global__ void __launch_bounds__(kColThreads) cx_col_partial(CxArgs a) {
  __shared__ float srate[kColRows], ssinv[kColRows], sfr[kColRows],
      sxx[kColRows];
  const int n = blockIdx.z, p0 = blockIdx.y * kColRows;
  const int q = blockIdx.x * kColThreads + threadIdx.x;
  const int rows = min(kColRows, a.p - p0);
  const float a0 = exponent_scale(a.h);
  if (static_cast<int>(threadIdx.x) < rows) {
    const size_t at = static_cast<size_t>(n) * a.p + p0 + threadIdx.x;
    srate[threadIdx.x] = row_rate(a.m[at], a0);
    ssinv[threadIdx.x] = __frcp_rn(a.sum[at]);
    sfr[threadIdx.x] = a.f ? a.f[at] : 1.0f;
    sxx[threadIdx.x] = MODE == kL2 ? a.xx[at] : 0.0f;
  }
  __syncthreads();
  if (q >= a.q) return;
  const Col c = column<MODE>(a, n, q);
  const float* sc = a.s + (static_cast<size_t>(n) * a.p + p0) * a.ld + q;
  float mx = -__int_as_float(0x7f800000);
  int cnt = 0;
  for (int i = 0; i < rows; ++i) {
    const float d = distance<MODE>(sc[static_cast<size_t>(i) * a.ld], c.on,
                                   sxx[i], c.yy);
    const float cv = __fmul_rn(weight(d, srate[i], a0), ssinv[i]);
    merge_max(mx, cnt, __fmul_rn(sfr[i], cv), 1);
  }
  const size_t at = (static_cast<size_t>(blockIdx.y) * a.n + n) * a.q + q;
  a.cmax[at] = mx;
  a.ccnt[at] = cnt;
}

// z, k: the chunks' partial maxima merged in chunk order
__global__ void cx_col_merge(CxArgs a, int chunks) {
  const size_t nq = static_cast<size_t>(a.n) * a.q;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float mx = a.cmax[i];
  int cnt = a.ccnt[i];
  for (int ch = 1; ch < chunks; ++ch)
    merge_max(mx, cnt, a.cmax[nq * ch + i], a.ccnt[nq * ch + i]);
  a.z[i] = mx;
  a.k[i] = cnt;
}

// Backward rows, a warp a row: A, then B / l.
template <int MODE>
__global__ void __launch_bounds__(32 * kRowWarps) cx_row_terms(CxArgs a) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= a.n * a.p) return;
  const int lane = threadIdx.x & 31, n = row / a.p, Q = a.q;
  const float* sr = a.s + static_cast<size_t>(row) * a.ld;
  const float xx = MODE == kL2 ? a.xx[row] : 0.0f;
  const float a0 = exponent_scale(a.h);
  const float m = a.m[row];
  const float rate = row_rate(m, a0), sinv = __frcp_rn(a.sum[row]);
  const float fr = a.f ? a.f[row] : 1.0f;
  float A = 0.0f, E = 0.0f, F = 0.0f;
  for (int q = lane; q < Q; q += 32) {
    const Col c = column<MODE>(a, n, q);
    if (!c.on) continue;
    const size_t at = static_cast<size_t>(n) * Q + q;
    const float d = distance<MODE>(sr[q], true, xx, c.yy);
    const float cv = __fmul_rn(weight(d, rate, a0), sinv);
    const float r = __fmul_rn(fr, cv) == a.z[at]
                        ? __fdiv_rn(a.g[at], static_cast<float>(a.k[at]))
                        : 0.0f;
    const float cd = __fmul_rn(cv, d);
    A = __fadd_rn(A, __fmul_rn(r, cv));
    E = __fadd_rn(E, __fmul_rn(cd, r));
    F = __fadd_rn(F, cd);
  }
  A = warp_sum(A);
  E = warp_sum(E);
  F = warp_sum(F);
  if (lane == 0) {
    const float me = __fadd_rn(m, kEps);
    const float B = fr * (E - A * F) / (a.h * me * me);
    a.a[row] = A;
    a.bl[row] = B / static_cast<float>(a.l[row]);
  }
}

// G from s, a 32 x 32 tile a block (32, 8) of (p, q): G (q contiguous)
// and G^T (p contiguous), rounded to TF32 with it on, zeros between the
// edge and the pitch; l2 and l1 also write the tile's partial row and
// column sums (l2 of G, l1 of dL/dd sgn s, unrounded).
template <int MODE>
__global__ void __launch_bounds__(256) cx_grad_tiles(CxArgs a) {
  __shared__ float t[kTile][kTile + 1];
  __shared__ float rrate[kTile], rsinv[kTile], rf[kTile], ra[kTile],
      rbl[kTile], rk[kTile], rm[kTile], rxx[kTile];
  __shared__ float cz[kTile], cg[kTile], cyy[kTile];
  __shared__ int con[kTile];
  const int n = blockIdx.z, p0 = blockIdx.y * kTile, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int P = a.p, Q = a.q;
  const float a0 = exponent_scale(a.h);
  if (ty == 0) {
    const int p = p0 + tx;
    rm[tx] = -1.0f;   // marks a row past the edge
    if (p < P) {
      const size_t at = static_cast<size_t>(n) * P + p;
      const float m = a.m[at];
      rm[tx] = m;
      rrate[tx] = row_rate(m, a0);
      rsinv[tx] = __frcp_rn(a.sum[at]);
      rf[tx] = a.f ? a.f[at] : 1.0f;
      ra[tx] = a.a[at];
      rbl[tx] = a.bl[at];
      // dL/dd = -(fx / h) c (r - A) / (m + 1e-5) + [d = m] B / l
      rk[tx] = rf[tx] * __frcp_rn(a.h) / __fadd_rn(m, kEps);
      rxx[tx] = MODE == kL2 ? a.xx[at] : 0.0f;
    }
  } else if (ty == 1) {
    const int q = q0 + tx;
    con[tx] = 0;
    if (q < Q) {
      const Col c = column<MODE>(a, n, q);
      const size_t at = static_cast<size_t>(n) * Q + q;
      con[tx] = c.on;
      cyy[tx] = c.yy;
      cz[tx] = a.z[at];
      cg[tx] = __fdiv_rn(a.g[at], static_cast<float>(a.k[at]));
    }
  }
  __syncthreads();
  const bool tf32 = a.prec == kTF32;
  const int nqt = a.ld / kTile, npt = a.ldt / kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pr = ty + 8 * i, p = p0 + pr;
    float v = 0.0f;
    if (rm[pr] >= 0.0f && con[tx]) {
      const float sv = a.s[(static_cast<size_t>(n) * P + p) * a.ld + q0 + tx];
      if (passes<MODE>(sv, rxx[pr], cyy[tx])) {
        const float d = distance<MODE>(sv, true, rxx[pr], cyy[tx]);
        const float cv = __fmul_rn(weight(d, rrate[pr], a0), rsinv[pr]);
        const float r = __fmul_rn(rf[pr], cv) == cz[tx] ? cg[tx] : 0.0f;
        // -dL/dd
        const float gv = rk[pr] * cv * (r - ra[pr]) - (d == rm[pr] ? rbl[pr]
                                                                   : 0.0f);
        v = MODE == kCosine ? gv
            : MODE == kL2   ? 2.0f * gv
                            : (sv > 0.0f ? gv : sv < 0.0f ? -gv : 0.0f);
      }
    }
    if (a.gx && p < P)
      a.gx[(static_cast<size_t>(n) * P + p) * a.ld + q0 + tx] =
          tf32 ? tf32_round(v) : v;
    t[pr][tx] = v;
    if (MODE != kCosine) {
      const float rs = warp_sum(v);
      if (tx == 0 && p < P)
        a.rsum[(static_cast<size_t>(n) * P + p) * nqt + blockIdx.x] = rs;
    }
  }
  __syncthreads();
  if (a.gy) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 8 * i;
      if (q < Q) {
        const float v = t[tx][ty + 8 * i];
        a.gy[(static_cast<size_t>(n) * Q + q) * a.ldt + p0 + tx] =
            tf32 ? tf32_round(v) : v;
      }
    }
  }
  if (MODE != kCosine && ty == 0 && q0 + tx < Q) {
    float cs = 0.0f;
    for (int pr = 0; pr < kTile; ++pr) cs = __fadd_rn(cs, t[pr][tx]);
    a.csum[(static_cast<size_t>(n) * Q + q0 + tx) * npt + blockIdx.y] = cs;
  }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes of this file beside cudaError_t's
constexpr int kNoEncode = 900, kEncodeFailed = 901;

// (batch, rows, pitch) f32 with K = kdim valid channels a row, read in
// boxes of 32 channels x 128 rows
int tensor_map(CUtensorMap* map, const float* ptr, int kdim, int rows,
               int batch, int pitch) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return kNoEncode;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kdim),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(pitch) * 4,
      static_cast<cuuint64_t>(pitch) * 4 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// out (batch, M, ldo) = A (batch, M, lda)[:, :, :K] B (batch, ncols,
// ldb)[:, :, :K]^T, lda and ldb multiples of 4 (of 32 where K is not a
// multiple of 32, with zeros from K to the next multiple of 32)
int gemm(int prec, const float* A, const float* B, float* out, int batch,
         int M, int ncols, int K, int lda, int ldb, int ldo,
         cudaStream_t stream) {
  const dim3 grid((ncols + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  if (prec == kTF32) {
    CUtensorMap ma, mb;
    int err = tensor_map(&ma, A, K, M, batch, lda);
    if (err == 0) err = tensor_map(&mb, B, K, ncols, batch, ldb);
    if (err != 0) return err;
    static bool sized = false;
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          cx_gemm_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      sized = true;
    }
    cx_gemm_tf32<<<grid, kGemmThreads, kTmaSmem, stream>>>(ma, mb, out, M,
                                                         ncols, K, ldo);
  } else {
    cx_gemm_f32<<<grid, kGemmThreads, 0, stream>>>(A, B, out, M, ncols, K, lda,
                                                ldb, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

int round_operand(const float* src, float* dst, size_t count,
                  cudaStream_t stream) {
  const size_t c4 = count / 4;
  cx_round_copy<<<static_cast<unsigned>((c4 + 255) / 256), 256, 0, stream>>>(
      src, dst, c4);
  return static_cast<int>(cudaGetLastError());
}

int transpose_operand(const float* src, float* dst, int n, int rows, int c,
                      int ldr, int to_tf32, cudaStream_t stream) {
  cx_transpose<<<dim3(ldr / kTile, c / kTile, n), dim3(kTile, 8), 0,
                  stream>>>(src, dst, rows, c, ldr, to_tf32);
  return static_cast<int>(cudaGetLastError());
}

int col_chunks(int p) { return (p + kColRows - 1) / kColRows; }

template <int MODE>
int forward(const CxArgs& a, cudaStream_t stream) {
  int err = 0;
  if (MODE == kL1) {
    cx_l1_fill<<<dim3((a.q + 255) / 256, a.p, a.n), 256, 0, stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
  } else {
    const float* x = a.x;
    const float* y = a.y;
    if (a.prec == kTF32) {
      err = round_operand(a.x, a.xs, static_cast<size_t>(a.n) * a.p * a.c,
                          stream);
      if (err == 0)
        err = round_operand(a.y, a.ys, static_cast<size_t>(a.n) * a.q * a.c,
                            stream);
      x = a.xs;
      y = a.ys;
    }
    if (err == 0)
      err = gemm(a.prec, x, y, a.s, a.n, a.p, a.q, a.c, a.c, a.c, a.ld,
                 stream);
  }
  if (err != 0) return err;
  cx_row_stats<MODE><<<(a.n * a.p + kRowWarps - 1) / kRowWarps, 32 * kRowWarps,
                    0, stream>>>(a);
  const int chunks = col_chunks(a.p);
  cx_col_partial<MODE><<<dim3((a.q + kColThreads - 1) / kColThreads, chunks,
                           a.n),
                      kColThreads, 0, stream>>>(a);
  const size_t nq = static_cast<size_t>(a.n) * a.q;
  cx_col_merge<<<static_cast<unsigned>((nq + 255) / 256), 256, 0, stream>>>(
      a, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int backward(const CxArgs& a, cudaStream_t stream) {
  cx_row_terms<MODE><<<(a.n * a.p + kRowWarps - 1) / kRowWarps, 32 * kRowWarps,
                    0, stream>>>(a);
  cx_grad_tiles<MODE><<<dim3(a.ld / kTile, a.ldt / kTile, a.n), dim3(kTile, 8),
                     0, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (MODE == kL1 || err != 0) return err;
  const int to_tf32 = a.prec == kTF32;
  if (a.dx) {
    err = transpose_operand(a.y, a.ys, a.n, a.q, a.c, a.ld, to_tf32, stream);
    if (err == 0)
      err = gemm(a.prec, a.gx, a.ys, a.dx, a.n, a.p, a.c, a.q, a.ld, a.ld,
                 a.c, stream);
  }
  if (err == 0 && a.dy) {
    err = transpose_operand(a.x, a.xs, a.n, a.p, a.c, a.ldt, to_tf32,
                            stream);
    if (err == 0)
      err = gemm(a.prec, a.gy, a.xs, a.dy, a.n, a.q, a.c, a.p, a.ldt, a.ldt,
                 a.c, stream);
  }
  return err;
}

}  // namespace

extern "C" {

// z, k (N, Q) and m, l, sum (N, P) of the chain into the args' buffers,
// s kept in its scratch; mode 0 cosine, 1 l2, 2 l1; prec 0 f32, 1 TF32.
int npp_cx_chain_fwd(const CxArgs* args, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->mode) {
    case kCosine: return forward<kCosine>(*args, st);
    case kL2: return forward<kL2>(*args, st);
    default: return forward<kL1>(*args, st);
  }
}

// dx into args->dx and dy into args->dy (either null when not wanted;
// l2 without its norm terms), or for l1 only the partial sums rsum, csum,
// from g and the forward's s, m, l, sum, z, k.
int npp_cx_chain_bwd(const CxArgs* args, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->mode) {
    case kCosine: return backward<kCosine>(*args, st);
    case kL2: return backward<kL2>(*args, st);
    default: return backward<kL1>(*args, st);
  }
}

}  // extern "C"
