// Batched fp32 GEMM on Hopper's tensor cores, fp32-accurate by the 3xTF32
// split: the mainloop of ns_gemm_update and a_perp.
//
// Replaces, through those two kernels, the TPU kernels
// src/repro/kernels/ns_inverse.py gemm_update_batched_pallas (body
// _gemm_update_kernel; out = α·C + β·A B) and src/repro/kernels/
// brand_panel.py a_perp_batched_pallas (body _a_perp_kernel; A⊥ = A − U C).
// It takes the Problem of gemm_common.cuh, as gemm.cuh and sgemm_pipe.cuh
// do, for the product op(A) = A stored [M][K], op(B) = B stored [K][N]
// (the NN case of the other two mainloops); another NN kernel moves onto
// it by changing its instantiation.
//
// Bound on an H100.  3xTF32 runs three TF32 products for each fp32 one,
// at 495 TFLOP/s TF32: 165 TFLOP/s of fp32 work, 2.5× the FMA pipes' 67.
// ns_gemm_update at d = 2304, B = 2 (48.9 GFLOP, ~170 MB) stays bound by
// operations (0.296 ms); a_perp at fc0 (1.93 GFLOP, 48.9 MB) becomes bound
// by bytes (0.0146 ms against 0.0117 of operations).
//
// Arithmetic.  Each fp32 value x is split into big = tf32(x) and small =
// tf32(x − big), both rounded to nearest (ties away: add half a tf32 ulp
// to the bit pattern, then clear the 13 low bits), so each is exactly a
// tf32 value and the hardware's own reading of a tf32 operand (it ignores
// the 13 low bits) changes neither.  A B is summed as A_b·B_s + A_s·B_b +
// A_b·B_b; the products of tf32 values are exact in the tensor core, so
// the error is that of the operands' 22-bit representation, of the
// dropped A_s·B_s (up to 2^-22 of a product) and of the fp32 sums.
// - Where the whole contraction is one k-step (K ≤ 32: the NS buckets
//   d = 10 and 27) fp32's own result is within an ulp or so of exact,
//   and the dropped term alone puts the largest error past 4× an fp32
//   GEMM's against float64 on some inputs (tests/test_torch_tf32x3.py's
//   d = 10 case fails when its emulation drops the term).  There the
//   kernel issues the fourth product A_s·B_s too, at no cost that
//   matters.  Longer contractions sum enough fp32 roundings that the
//   term is far below them.
// - Within a 32-deep k-step the small terms are issued before the big
//   ones, into a fresh accumulator: they are summed while it is small, so
//   their rounding costs 2^-11 of the big terms' (CUTLASS's
//   OpMultiplyAddFastF32 orders its products the same way).
// - That k-step partial is added to the running fp32 sum by an ordinary,
//   round-to-nearest FADD once its wgmmas have finished: the tensor
//   core's own additions never see the whole running sum.  They do not
//   round to nearest: accumulating all of K in the wgmma accumulator
//   left errors several times cuBLAS's at d ≥ 512 in a trial on a
//   scratch copy (no committed script makes it, so no number is kept).
//
// Layout.  For .tf32, wgmma reads a shared-memory operand only K-major
// (the transpose flags exist only for 16-bit types), and here the right
// operand is always stored N-major ([K][N]: ns_gemm_update's X and T,
// a_perp's C).  The kernel therefore computes the transposed tile
//   Dᵀ = Bᵀ Aᵀ:
// wgmma's A operand is Bᵀ, taken from registers: a plain shared-memory
// read fills the fragment whatever the stored layout, and its 3xTF32
// split is two register operations, with no shared-memory plane.  wgmma's
// B operand is Aᵀ, which is K-major as stored ([M][K]), read from shared
// memory in core matrices of 8 rows × 16 bytes (no swizzle); its small
// half goes into a second plane of the same layout, computed by each
// thread from the elements it copied once its stage has landed (the big
// half is written back in place).  Transposing the N-major tile instead
// would need element-wise copies and a small plane for both operands.
// The epilogue stages the tile through shared memory, transposing it back,
// so that the addend read and the store coalesce along N.
//
// Tiles.  128 × 128 outputs per 256-thread block: two warpgroups, each
// wgmma m64n128k8 over 64 output columns and all 128 rows (64 fp32
// accumulators a thread, plus 64 for the k-step partial, plus the Bᵀ
// fragments of two k-steps: ~220 registers).  One block an SM (~164 KB of
// shared memory): ns_gemm_update at d = 2304, B = 2 is 648 tiles, 4.9
// waves.  a_perp at fc0 is 256 tiles; the two column tiles of a row
// stripe are neighbours in the grid (n fastest), run together, and read
// their U rows from HBM once.  C (235 KB) is re-read from L2 by every
// block.
//
// Pipeline.  Each k-step issues its wgmmas and, while they run, the
// block splits the next k-step (its own copied elements into the other
// small plane, the Bᵀ fragments into the other register set) and then
// issues the copies of the k-step three ahead; the next k-step first
// waits for these wgmmas and adds their partial to the sum.  Two barriers
// a k-step: the next stage has landed for every thread; the split stage
// is visible to wgmma.
//
// Loads.  A ring of STAGES = 4 k-steps filled by cp.async: the A tile
// (wgmma's B) straight into its core-matrix layout, the B tile [BK][N]
// with a padded row.  Each operand is copied as vectors of V floats, V =
// 4, 2 or 1 (16, 8 or 4 bytes) by the alignment of its pointer, row and
// batch strides, picked per launch as in sgemm_pipe.cuh.  TMA is not
// used: its tensor maps need 16-byte strides, and the path's U is the
// [..., :230] column slice of the (d, 486) Brand state, rows 1944 bytes
// apart, read in place by 8-byte copies.
//
// Edges.  Rows past M, columns past N and k past the split's end are
// zero-filled by cp.async's source size and masked on store; k8 slices
// wholly past the end are not issued (K = 230 runs as 232).  A batch
// stride of 0 shares one matrix.
//
// Split-K and determinism.  A small product whose tiles do not fill the
// card splits K over a thread-block cluster of `splits` ≤ 8 blocks
// (blockIdx.x).  Each block stages its partial tile in its own shared
// memory; after a cluster barrier block q sums rows strip q of the tile
// over the cluster's blocks in rank order, through distributed shared
// memory, and applies the epilogue — as sgemm_pipe.cuh's first stage, in
// one launch, with no float atomics and no workspace.  Unsplit, a block
// reads its own tile.  Every sum runs in a fixed order: the result is the
// same bits from launch to launch.  The wrapper picks `splits` per shape
// (_build.tc_split) from the card's cluster occupancy.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gemm_common.cuh"

namespace kfk {
namespace tc {

constexpr int BM = 128;         // output rows of a tile: wgmma's N
constexpr int BN = 128;         // output columns: 2 warpgroups × wgmma's M
constexpr int BK = 32;          // k-step
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int A_TILE = BM * BK;       // floats of an A stage (and a plane)
constexpr int LDB = BN + 8;           // row stride of a B stage (≡ 8 mod 32)
constexpr int B_TILE = BK * LDB;      // floats of a B stage
constexpr int LDC = BN + 4;           // row stride of the staged output
constexpr int SMEM_BYTES = (STAGES * (A_TILE + B_TILE) + 2 * A_TILE) * 4;
static_assert(BM * LDC <= STAGES * (A_TILE + B_TILE), "output fits the ring");
static_assert(BK == 32 && BM == 128 && BN == 128 && THREADS == 256,
              "the loaders and fragment maps assume these sizes");

namespace {

namespace cg = cooperative_groups;

template <int V> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

// Round to the nearest tf32 value (ties away from zero).
__device__ __forceinline__ float tf32_rn(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Shared-memory matrix descriptor of a K-major operand in core matrices of
// 8 rows × 16 bytes, no swizzle: the 16-byte K chunks of a core-matrix row
// are 128 bytes apart (leading byte offset), 8-row groups BK/4 · 128 bytes
// apart (stride byte offset).  A k8 slice is 256 bytes further on.
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile) {
  const uint64_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  constexpr uint64_t LBO = 128, SBO = (BK / 4) * 128;
  return ((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}
constexpr uint64_t DESC_SLICE = 256 >> 4;   // descriptor step of one k8

// D[64×128] (+)= A[64×8] B[8×128]: A from registers (tf32 fragment of
// m16n8k8's layout per warp), B K-major in shared memory; scale_d = 0
// ignores D's old value.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy shared-memory writes (cp.async, st.shared) before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pin registers that wgmma reads or writes asynchronously: the compiler
// must neither reuse them nor move their accesses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[i][q])::"memory");
}

// One BM × BK tile of A (stored [M][K], K contiguous) into the core-matrix
// layout ([BM/8][BK/4][8 rows][4 floats], which is linear in the copy
// unit): unit u = tid + THREADS·l holds floats V·u … V·u+V−1 of the tile,
// so every warp writes contiguous shared memory and reads 8 rows × 64
// bytes (V = 4) of global memory.  Pass l is 8·V rows below pass 0.
template <int V>
__device__ __forceinline__ void load_a(float* dst, const float* A,
                                       long long ld, int m0, int M, int k0,
                                       int kend) {
  const int e = V * threadIdx.x;
  const int core = e / 32;
  const int row = (core / (BK / 4)) * 8 + (e % 32) / 4;
  const int gk = k0 + (core % (BK / 4)) * 4 + e % 4;
  const int bytes = gk < kend ? min(V, kend - gk) * 4 : 0;
  const float* g = A + (long long)(m0 + row) * ld + gk;
#pragma unroll
  for (int l = 0; l < 16 / V; ++l) {
    const bool in = bytes && m0 + row + 8 * V * l < M;
    cp_async<V>(dst + e + V * THREADS * l, in ? g : A, in ? bytes : 0);
    g += 8 * V * ld;
  }
}

// The 3xTF32 split of this thread's own units of a landed A stage: big
// back in place, small into the plane (same offsets).
template <int V>
__device__ __forceinline__ void split_a(float* tile, float* small) {
  using T = typename VecOf<V>::T;
  union U {
    T v;
    float f[V];
  };
#pragma unroll
  for (int l = 0; l < 16 / V; ++l) {
    const int o = V * threadIdx.x + V * THREADS * l;
    U x, hi, lo;
    x.v = *reinterpret_cast<const T*>(tile + o);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      hi.f[q] = tf32_rn(x.f[q]);
      lo.f[q] = tf32_rn(x.f[q] - hi.f[q]);
    }
    *reinterpret_cast<T*>(tile + o) = hi.v;
    *reinterpret_cast<T*>(small + o) = lo.v;
  }
}

// One BK × BN tile of B (stored [K][N], N contiguous) into [BK][LDB],
// vectors of V floats along N.
template <int V>
__device__ __forceinline__ void load_b(float* dst, const float* B,
                                       long long ld, int n0, int N, int k0,
                                       int kend) {
  constexpr int PER_ROW = BN / V;
  constexpr int STEP = THREADS / PER_ROW;
  const int k = threadIdx.x / PER_ROW;
  const int n = (threadIdx.x % PER_ROW) * V;
  const int gn = n0 + n;
  const int bytes = gn < N ? min(V, N - gn) * 4 : 0;
  const float* g = B + (long long)(k0 + k) * ld + gn;
#pragma unroll
  for (int l = 0; l < BK / STEP; ++l) {
    const bool in = bytes && k0 + k + l * STEP < kend;
    cp_async<V>(dst + (k + l * STEP) * LDB + n, in ? g : B, in ? bytes : 0);
    g += STEP * ld;
  }
}

// VA / VB: copy width (floats) of A and of B.
// Grid: (splits, tiles_m · tiles_n with n fastest, batch); clusters of
// `splits` blocks along x.
template <int VA, int VB>
__global__ void __launch_bounds__(THREADS, 1)
    tc_gemm_kernel(const Problem p) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;                          // [STAGES][A_TILE]
  float* Bs = smem + STAGES * A_TILE;        // [STAGES][B_TILE]
  float* Ss = Bs + STAGES * B_TILE;          // small planes [2][A_TILE]
  const int tiles_n = (p.N + BN - 1) / BN;
  const int m0 = (blockIdx.y / tiles_n) * BM;
  const int n0 = (blockIdx.y % tiles_n) * BN;
  const int b = blockIdx.z;
  const int s = blockIdx.x;
  const int kchunk = ((p.K + p.splits - 1) / p.splits + BK - 1) / BK * BK;
  const int kbeg = min(p.K, s * kchunk);
  const int kend = min(p.K, kbeg + kchunk);
  const float* A = p.A.ptr + b * p.A.bstride;
  const float* B = p.B.ptr + b * p.B.bstride;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's fragment rows: output columns nf and nf + 8 of the tile
  const int nf = 64 * (warp / 4) + 16 * (warp % 4) + g;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  // Bᵀ fragments of a k-step's four k8 slices, big and small, double-
  // buffered: a0 (row nf, k t), a1 (nf + 8, t), a2 (nf, t + 4),
  // a3 (nf + 8, t + 4) of slice j
  uint32_t fb[2][BK / 8][4], fs[2][BK / 8][4];

  const int ktiles = (kend - kbeg + BK - 1) / BK;
  // the fourth product, A_s·B_s, only where the whole contraction is one
  // k-step (see the note)
  const bool small_small = p.K <= BK;
  auto load_stage = [&](int k) {  // k-step k into its ring slot
    load_a<VA>(As + (k % STAGES) * A_TILE, A, p.A.ld, m0, p.M,
               kbeg + k * BK, kend);
    load_b<VB>(Bs + (k % STAGES) * B_TILE, B, p.B.ld, n0, p.N,
               kbeg + k * BK, kend);
  };
  // Split k-step k (landed, and visible to all: after a barrier) into
  // plane `buf` and fragment set `buf`.
  auto prepare = [&](auto bufc, int k) {
    constexpr int buf = decltype(bufc)::value;
    split_a<VA>(As + (k % STAGES) * A_TILE, Ss + buf * A_TILE);
    const float* f = Bs + (k % STAGES) * B_TILE + t * LDB + nf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float x[4] = {f[8 * j * LDB], f[8 * j * LDB + 8],
                          f[(8 * j + 4) * LDB], f[(8 * j + 4) * LDB + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float hi = tf32_rn(x[q]);
        fb[buf][j][q] = __float_as_uint(hi);
        fs[buf][j][q] = __float_as_uint(tf32_rn(x[q] - hi));
      }
    }
    fence_proxy_async();  // the split tile, before wgmma reads it
  };
  // One k-step: wait for the previous k-step's wgmmas and add their
  // partial to the running sum, issue this k-step's (into a fresh
  // partial, smallest terms first: [A_s·B_s,] A_b·B_s, A_s·B_b, then
  // A_b·B_b), and prepare the next k-step while they run.
  auto step = [&](auto bufc, int kt) {
    constexpr int buf = decltype(bufc)::value;
    wgmma_wait_all();
    pin(part);
    pin(fb[0]);
    pin(fb[1]);
    pin(fs[0]);
    pin(fs[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    pin(part);
    wgmma_fence();
    const float* a = As + (kt % STAGES) * A_TILE;
    const uint64_t d_big = kmajor_desc(a);
    const uint64_t d_small = kmajor_desc(Ss + buf * A_TILE);
    // The first product issued starts the partial afresh (scale-d 0).  In
    // the last k-step of a split, k8 slices past its end hold only zeros
    // and are skipped (uniformly over the warpgroup, as wgmma needs);
    // every other k-step takes the branch-free path.
    const int kleft = kend - kbeg - kt * BK;
    auto issue = [&](auto fullc) {
      constexpr bool full = decltype(fullc)::value;
      if (small_small) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          if (full || 8 * j < kleft)
            wgmma_tf32(part, fs[buf][j], d_small + j * DESC_SLICE, j > 0);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        if (full || 8 * j < kleft)
          wgmma_tf32(part, fs[buf][j], d_big + j * DESC_SLICE,
                     j > 0 || small_small);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        if (full || 8 * j < kleft)
          wgmma_tf32(part, fb[buf][j], d_small + j * DESC_SLICE, 1);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        if (full || 8 * j < kleft)
          wgmma_tf32(part, fb[buf][j], d_big + j * DESC_SLICE, 1);
    };
    if (kleft >= BK)
      issue(std::true_type{});
    else
      issue(std::false_type{});
    wgmma_commit();
    if (kt + 1 < ktiles) {
      cp_async_wait<STAGES - 3>();  // this thread's part of k-step kt+1
      __syncthreads();  // everyone's; both warpgroups are past k-step
                        // kt − 1, whose slot and plane are free again
      prepare(std::integral_constant<int, buf ^ 1>{}, kt + 1);
      // the copies after the split, which they would otherwise delay in
      // the shared-memory queue
      if (kt + STAGES - 1 < ktiles) load_stage(kt + STAGES - 1);
      cp_async_commit();
      __syncthreads();  // k-step kt+1 is split and visible
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st);
    cp_async_commit();
  }
  if (ktiles > 0) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    prepare(std::integral_constant<int, 0>{}, 0);
    __syncthreads();
  }
  for (int kt = 0; kt < ktiles; kt += 2) {
    step(std::integral_constant<int, 0>{}, kt);
    if (kt + 1 < ktiles) step(std::integral_constant<int, 1>{}, kt + 1);
  }
  wgmma_wait_all();
  pin(part);
  pin(fb[0]);
  pin(fb[1]);
  pin(fs[0]);
  pin(fs[1]);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output tile

  // Dᵀ back to [m][n]: accumulator i of this thread is wgmma row
  // nf + 8·(i%4 / 2), column 8·(i/4) + 2t + i%2
  float* Cs = smem;  // [BM][LDC]
#pragma unroll
  for (int i = 0; i < 64; ++i)
    Cs[(8 * (i / 4) + 2 * t + (i & 1)) * LDC + nf + 8 * ((i >> 1) & 1)] =
        acc[i];

  const int cluster = p.splits;
  if (cluster == 1) {
    __syncthreads();
    for (int row = warp; row < min(BM, p.M - m0); row += THREADS / 32)
      store4(p, b, m0 + row, n0 + 4 * lane,
             *reinterpret_cast<const float4*>(Cs + row * LDC + 4 * lane));
    return;
  }
  // split-K: strip q of the tile summed over the cluster in rank order
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int q = (int)cl.block_rank();
  const int r1 = min((q + 1) * BM / cluster, p.M - m0);
  for (int row = q * BM / cluster + warp; row < r1; row += THREADS / 32) {
    const int off = row * LDC + 4 * lane;
    float4 v = *reinterpret_cast<const float4*>(cl.map_shared_rank(Cs, 0) +
                                                off);
    for (int r = 1; r < cluster; ++r)
      v = add4(v, *reinterpret_cast<const float4*>(
                      cl.map_shared_rank(Cs, r) + off));
    store4(p, b, m0 + row, n0 + 4 * lane, v);
  }
  cl.sync();  // no block leaves while another reads its tile
}

template <int VA, int VB>
cudaError_t launch(const Problem& p, cudaStream_t stream) {
  auto kernel = tc_gemm_kernel<VA, VB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const long long tiles =
      (long long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles > 65535 || p.batch > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (unsigned)tiles, p.batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int VA>
cudaError_t launch_vb(const Problem& p, cudaStream_t stream) {
  switch (vec_width(p.B)) {
    case 4: return launch<VA, 4>(p, stream);
    case 2: return launch<VA, 2>(p, stream);
    default: return launch<VA, 1>(p, stream);
  }
}

// Launch C = epilogue(A B) on `stream`; returns the first launch error
// (cudaSuccess if none).  p.splits (1 … 8) blocks share a tile's K, as one
// cluster; p.ws is not used.
inline cudaError_t tc_gemm(const Problem& p, cudaStream_t stream) {
  if (p.batch <= 0 || p.M <= 0 || p.N <= 0 || p.K <= 0 || p.splits < 1 ||
      p.splits > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  switch (vec_width(p.A)) {
    case 4: return launch_vb<4>(p, stream);
    case 2: return launch_vb<2>(p, stream);
    default: return launch_vb<1>(p, stream);
  }
}

// Blocks resident at once when launched in clusters of `cluster`
// (cudaOccupancyMaxActiveClusters × cluster; negative: a CUDA error).
// Every instantiation has the same block size and shared memory and one
// block an SM, so one stands for all.
inline int resident_blocks(int cluster) {
  auto kernel = tc_gemm_kernel<4, 4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n * cluster : -(int)err;
}

}  // namespace
}  // namespace tc
}  // namespace kfk
