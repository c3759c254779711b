// Batched fp32 GEMM on Hopper's tensor cores, fp32-accurate by the 3xTF32
// split: the mainloop of ns_gemm_update, a_perp, ea_syrk and syrk_tn.
//
// Replaces, through those four kernels, the TPU kernels
// src/repro/kernels/ns_inverse.py gemm_update_batched_pallas (body
// _gemm_update_kernel; out = α·C + β·A B), src/repro/kernels/
// brand_panel.py a_perp_batched_pallas (body _a_perp_kernel; A⊥ = A − U C),
// src/repro/kernels/ea_syrk.py ea_syrk_batched_pallas (body
// _ea_syrk_kernel; out = keep·M + coef·X Xᵀ) and src/repro/kernels/
// cholqr.py syrk_tn_batched_pallas (body _syrk_tn_kernel; G = AᵀA).  It
// takes the Problem of gemm_common.cuh, as gemm.cuh and sgemm_pipe.cuh do.
// Three template flags say how the stored matrices map onto the product
// (template flags, not run-time ones: as a run-time flag, the symmetric
// case slowed the other products of the 64×64 mainloop by 6–12 %):
//   AT = false: A stored [M][K];  AT = true: A stored [K][M]  (op = Aᵀ)
//   BT = false: B stored [K][N];  BT = true: B stored [N][K]  (op = Bᵀ)
//   SYM: op(A) op(B) is symmetric (M == N, A and B one stored matrix):
//        only the tiles on or above the diagonal are computed, and each
//        off-diagonal one is stored at both places.
// ns_gemm_update and a_perp are NN; ea_syrk (X Xᵀ) is BT + SYM; syrk_tn
// (AᵀA) is AT + SYM.
//
// Bound on an H100.  3xTF32 runs three TF32 products for each fp32 one,
// at 495 TFLOP/s TF32: 165 TFLOP/s of fp32 work, 2.5× the FMA pipes' 67.
// ns_gemm_update at d = 2304, B = 2 (48.9 GFLOP, ~170 MB) stays bound by
// operations (0.296 ms); a_perp at fc0 (1.93 GFLOP, 48.9 MB) becomes bound
// by bytes (0.0146 ms against 0.0117 of operations); ea_syrk at d = 2304,
// B = 2 (one triangle: 2.7 GFLOP against 89 MB) by bytes, 0.0268 ms;
// syrk_tn at fc0 (1.08 GFLOP against 17 MB) by operations, 0.0065 ms.
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
// (the transpose flags exist only for 16-bit types).  The kernel computes
// the transposed tile
//   Dᵀ = op(B)ᵀ op(A)ᵀ:
// wgmma's A operand is op(B)ᵀ, taken from registers: a plain shared-memory
// read fills the fragment whatever the stored layout, and its 3xTF32
// split is two register operations, with no shared-memory plane.  Its
// stage is [BK][N] as B is stored ([K][N], N contiguous; row stride ≡ 8
// mod 32 words), or under BT [N][BK] ([N][K], K contiguous; row stride
// BK + 4 ≡ 4 mod 32, so the fragment reads of a warp, rows g and columns
// t, fall in 32 distinct banks).  wgmma's B operand is op(A)ᵀ, read from
// shared memory in core matrices of 8 rows (of M) × 16 bytes (of K), no
// swizzle.  A stored [M][K] is K-major already: its stage is copied
// straight into that layout, and the split writes the big half back in
// place and the small half into a second plane of the same layout.  A
// stored [K][M] (AT) lands M-major, as a [BK][M] stage like B's; the split
// then reads it as 4 × 4 blocks (four 16-byte rows of M), transposes each
// in registers and writes both halves, big and small, into K-major planes
// of their own (16-byte stores whose order is XOR-permuted per thread, so
// the eight stores of a quarter-warp land in eight distinct bank groups).
//
// Epilogue.  The tile is staged through shared memory, transposed back, so
// that the addend read and the store coalesce along N; under SYM an
// off-diagonal tile is staged a second time beside it, untransposed, and
// stored at the mirrored place in the same pass, coalesced along M, each
// entry with its own addend (the addend need not be symmetric).  An
// unsplit tile is stored EPI_ROWS rows a warp at a time, every addend read
// of a batch issued before its stores (row by row, the compiler cannot
// hoist a row's read above the previous row's store, which may alias it,
// so every row pays the read's full latency).  C must not overlap the
// addend.
//
// Tiles.  128 × 128 outputs per 256-thread block: two warpgroups, each
// wgmma m64n128k8 over 64 output columns and all 128 rows (64 fp32
// accumulators a thread, plus 64 for the k-step partial, plus the Bᵀ
// fragments of two k-steps: ~220 registers).  One block an SM (164–200 KB
// of shared memory by the flags): ns_gemm_update at d = 2304, B = 2 is 648
// tiles, 4.9 waves; ea_syrk there is 342 triangle tiles, 2.6 waves.
// a_perp at fc0 is 256 tiles; the two column tiles of a row stripe are
// neighbours in the grid (n fastest), run together, and read their U rows
// from HBM once.  The triangle is walked row by row, so the tiles of one
// row of it are neighbours too.
//
// Pipeline.  Each k-step issues its wgmmas and, while they run, the
// block splits the next k-step (its own copied elements into the other
// planes, the fragments into the other register set) and then issues the
// copies of the k-step three ahead; the next k-step first waits for these
// wgmmas and adds their partial to the sum.  Two barriers a k-step: the
// next stage has landed for every thread; the split stage is visible to
// wgmma.
//
// Loads.  A ring of STAGES = 4 k-steps filled by cp.async.  Each operand
// is copied as vectors of V floats, V = 4, 2 or 1 (16, 8 or 4 bytes) by
// the alignment of its pointer, row and batch strides, picked per launch
// as in sgemm_pipe.cuh (under SYM one width serves both operands: they
// are one matrix).  TMA is not used: its tensor maps need 16-byte strides,
// and the path's U is the [..., :230] column slice of the (d, 486) Brand
// state, rows 1944 bytes apart, read in place by 8-byte copies.
//
// Edges.  Rows past M, columns past N and k past the split's end are
// zero-filled by cp.async's source size and masked on store; k8 slices
// wholly past the end are not issued (K = 230 runs as 232).  A batch
// stride of 0 shares one matrix.
//
// Split-K and determinism.  A product whose tiles do not fill the card
// splits K over `splits` blocks (blockIdx.x), in thread-block clusters of
// `cluster` ≤ 8.  Each block stages its partial tile in its own shared
// memory; after a cluster barrier block q sums rows strip q of the tile
// over the cluster's blocks in rank order, through distributed shared
// memory.  With one cluster a tile (splits = cluster) block q then applies
// the epilogue to its strip.  With G = splits / cluster > 1 (syrk_tn at
// fc0: 3 triangle tiles and 512 k-steps, 40 splits in clusters of 8)
// each cluster writes its strips to a workspace, and a per-(tile, strip)
// arrival counter (__threadfence, then atomicAdd on an int) picks the last
// block to arrive, which sums the G cluster partials in cluster order,
// applies the epilogue and resets the counter to 0 — as sgemm_pipe.cuh
// does, in one launch, with no float atomics.  Unsplit, a block reads its
// own tile.  Every sum runs in a fixed order: the result is the same bits
// from launch to launch.  The wrapper picks (splits, cluster) per shape
// (_build.tc_plan) from the card's cluster occupancy.
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
constexpr int A_TILE = BM * BK;       // floats of a core-matrix tile (plane)
constexpr int LDB = BN + 8;           // row stride of a [BK][N] stage
constexpr int LDT = BK + 4;           // row stride of an [N][BK] stage (BT)
constexpr int LDC = BN + 4;           // row stride of the staged output
constexpr int EPI_ROWS = 8;           // rows a warp stores a batch (epilogue)
static_assert(BK == 32 && BM == 128 && BN == 128 && THREADS == 256,
              "the loaders and fragment maps assume these sizes");
static_assert(BM % (EPI_ROWS * THREADS / 32) == 0, "epilogue batches");

// Shared memory by the layout flags: the ring of A and B stages, then the
// small planes [2][A_TILE] and, under AT, the big planes [2][A_TILE].
template <bool AT, bool BT>
struct Smem {
  static constexpr int A_STAGE = AT ? BK * LDB : A_TILE;
  static constexpr int B_STAGE = BT ? BN * LDT : BK * LDB;
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int PLANES = AT ? 4 : 2;
  static constexpr int BYTES = (RING + PLANES * A_TILE) * 4;
  static_assert(BM * LDC <= RING, "output fits the ring");
  static_assert(BYTES <= 227 * 1024, "one block an SM");
};

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

// Whether the epilogue runs on 16-byte vectors throughout: C's rows and
// the addend's (if any) 16-byte aligned, no scale vectors (every product
// of the paths but those with d = 10 or 27 columns).
__device__ __forceinline__ bool vec_epilogue(const Problem& p) {
  const Epilogue& e = p.epi;
  return (p.N & 3) == 0 && ((uintptr_t)p.C & 15) == 0 && !e.row_scale &&
         !e.col_scale &&
         (!e.addend || (((uintptr_t)e.addend & 15) == 0 &&
                        (e.addend_ld & 3) == 0 && (e.addend_b & 3) == 0));
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

// The 3xTF32 split of this thread's own units of a landed core-matrix A
// stage: big back in place, small into the plane (same offsets).
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

// The split of a landed [BK][LDB] stage of an AT operand (element (m, k)
// at k·LDB + m) into K-major core-matrix planes, big and small.  Thread
// (warp w, lane l) takes the 4 × 4 block k = 4w … 4w+3, m = 4l … 4l+3:
// four 16-byte reads along m (a quarter-warp reads 128 contiguous bytes),
// then four 16-byte stores along k to each plane, one for each m.  The
// 16 bytes of row m sit in bank group m mod 8 of their core matrix, so a
// quarter-warp storing the same m offset q would hit two groups; each
// thread stores m = 4l + (i ^ x) at turn i, x = (l / 2) mod 4, and then
// lanes 0 … 7 cover all eight groups at every turn.
__device__ __forceinline__ void split_at(const float* stage, float* big,
                                         float* small) {
  const int lane = threadIdx.x % 32, kq = threadIdx.x / 32;
  float c[4][4];  // c[q][j] = element (4·lane + q, 4·kq + j)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        stage + (4 * kq + j) * LDB + 4 * lane);
    c[0][j] = v.x;
    c[1][j] = v.y;
    c[2][j] = v.z;
    c[3][j] = v.w;
  }
  const int x = (lane >> 1) & 3;
  // c[i] ← c[i ^ x], by conditional swaps (no dynamic register index)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool s1 = x & 1, s2 = x & 2;
    float t;
    t = c[0][j]; c[0][j] = s1 ? c[1][j] : t; c[1][j] = s1 ? t : c[1][j];
    t = c[2][j]; c[2][j] = s1 ? c[3][j] : t; c[3][j] = s1 ? t : c[3][j];
    t = c[0][j]; c[0][j] = s2 ? c[2][j] : t; c[2][j] = s2 ? t : c[2][j];
    t = c[1][j]; c[1][j] = s2 ? c[3][j] : t; c[3][j] = s2 ? t : c[3][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * lane + (i ^ x);
    const int o = (m / 8) * (BK / 4) * 32 + kq * 32 + (m % 8) * 4;
    float4 hi, lo;
    hi.x = tf32_rn(c[i][0]);
    hi.y = tf32_rn(c[i][1]);
    hi.z = tf32_rn(c[i][2]);
    hi.w = tf32_rn(c[i][3]);
    lo.x = tf32_rn(c[i][0] - hi.x);
    lo.y = tf32_rn(c[i][1] - hi.y);
    lo.z = tf32_rn(c[i][2] - hi.z);
    lo.w = tf32_rn(c[i][3] - hi.w);
    *reinterpret_cast<float4*>(big + o) = hi;
    *reinterpret_cast<float4*>(small + o) = lo;
  }
}

// One BK × 128 tile of an operand stored [K][X] (X contiguous) into
// [BK][LDB], vectors of V floats along X: B in the NN case, A under AT.
template <int V>
__device__ __forceinline__ void load_kx(float* dst, const float* src,
                                        long long ld, int x0, int X, int k0,
                                        int kend) {
  constexpr int PER_ROW = BN / V;
  constexpr int STEP = THREADS / PER_ROW;
  const int k = threadIdx.x / PER_ROW;
  const int x = (threadIdx.x % PER_ROW) * V;
  const int gx = x0 + x;
  const int bytes = gx < X ? min(V, X - gx) * 4 : 0;
  const float* g = src + (long long)(k0 + k) * ld + gx;
#pragma unroll
  for (int l = 0; l < BK / STEP; ++l) {
    const bool in = bytes && k0 + k + l * STEP < kend;
    cp_async<V>(dst + (k + l * STEP) * LDB + x, in ? g : src,
                in ? bytes : 0);
    g += STEP * ld;
  }
}

// One 128 × BK tile of B stored [N][K] (K contiguous; BT) into [BN][LDT],
// vectors of V floats along K.
template <int V>
__device__ __forceinline__ void load_xk(float* dst, const float* src,
                                        long long ld, int x0, int X, int k0,
                                        int kend) {
  constexpr int PER_ROW = BK / V;
  constexpr int STEP = THREADS / PER_ROW;
  const int x = threadIdx.x / PER_ROW;
  const int k = (threadIdx.x % PER_ROW) * V;
  const int gk = k0 + k;
  const int bytes = gk < kend ? min(V, kend - gk) * 4 : 0;
  const float* g = src + (long long)(x0 + x) * ld + gk;
#pragma unroll
  for (int l = 0; l < BN / STEP; ++l) {
    const bool in = bytes && x0 + x + l * STEP < X;
    cp_async<V>(dst + (x + l * STEP) * LDT + k, in ? g : src,
                in ? bytes : 0);
    g += STEP * ld;
  }
}

// AT, BT, SYM: the layout flags (see the note); VA / VB: copy width
// (floats) of A and of B.
// Grid: (splits, tiles, batch) — tiles_m · tiles_n with n fastest, or
// under SYM the upper triangle row by row; clusters of `cluster` blocks
// along x.  `counters`: the arrival counters of a split over more than one
// cluster (p.ws its workspace), else unused.
template <bool AT, bool BT, bool SYM, int VA, int VB>
__global__ void __launch_bounds__(THREADS, 1)
    tc_gemm_kernel(const Problem p, int cluster, int* counters) {
  using SM = Smem<AT, BT>;
  static_assert(!SYM || 2 * BM * LDC <= SM::RING,
                "both stagings of a mirrored tile fit the ring");
  extern __shared__ __align__(128) float smem[];
  float* As = smem;                             // [STAGES][A_STAGE]
  float* Bs = smem + STAGES * SM::A_STAGE;      // [STAGES][B_STAGE]
  float* Ss = smem + SM::RING;                  // small planes [2][A_TILE]
  float* Ps = Ss + 2 * A_TILE;                  // big planes (AT) [2][A_TILE]
  int tm, tn;
  if constexpr (SYM) {  // blockIdx.y-th tile of the upper triangle
    const int tiles = (p.M + BM - 1) / BM;
    int t = blockIdx.y;
    tm = 0;
    while (t >= tiles - tm) t -= tiles - tm++;
    tn = tm + t;
  } else {
    const int tiles_n = (p.N + BN - 1) / BN;
    tm = blockIdx.y / tiles_n;
    tn = blockIdx.y % tiles_n;
  }
  const int m0 = tm * BM, n0 = tn * BN;
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
  // op(B)ᵀ fragments of a k-step's four k8 slices, big and small, double-
  // buffered: a0 (row nf, k t), a1 (nf + 8, t), a2 (nf, t + 4),
  // a3 (nf + 8, t + 4) of slice j
  uint32_t fb[2][BK / 8][4], fs[2][BK / 8][4];

  const int ktiles = (kend - kbeg + BK - 1) / BK;
  // the fourth product, A_s·B_s, only where the whole contraction is one
  // k-step (see the note)
  const bool small_small = p.K <= BK;
  auto load_stage = [&](int k) {  // k-step k into its ring slot
    float* a = As + (k % STAGES) * SM::A_STAGE;
    float* bs = Bs + (k % STAGES) * SM::B_STAGE;
    const int k0 = kbeg + k * BK;
    if constexpr (AT) load_kx<VA>(a, A, p.A.ld, m0, p.M, k0, kend);
    else load_a<VA>(a, A, p.A.ld, m0, p.M, k0, kend);
    if constexpr (BT) load_xk<VB>(bs, B, p.B.ld, n0, p.N, k0, kend);
    else load_kx<VB>(bs, B, p.B.ld, n0, p.N, k0, kend);
  };
  // Split k-step k (landed, and visible to all: after a barrier) into
  // planes `buf` and fragment set `buf`.
  auto prepare = [&](auto bufc, int k) {
    constexpr int buf = decltype(bufc)::value;
    float* a = As + (k % STAGES) * SM::A_STAGE;
    if constexpr (AT) split_at(a, Ps + buf * A_TILE, Ss + buf * A_TILE);
    else split_a<VA>(a, Ss + buf * A_TILE);
    const float* bs = Bs + (k % STAGES) * SM::B_STAGE;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float x[4];
      if constexpr (BT) {
        const float* f = bs + nf * LDT + t + 8 * j;
        x[0] = f[0];
        x[1] = f[8 * LDT];
        x[2] = f[4];
        x[3] = f[8 * LDT + 4];
      } else {
        const float* f = bs + (t + 8 * j) * LDB + nf;
        x[0] = f[0];
        x[1] = f[8];
        x[2] = f[4 * LDB];
        x[3] = f[4 * LDB + 8];
      }
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
    const float* a = AT ? Ps + buf * A_TILE : As + (kt % STAGES) * SM::A_STAGE;
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
                        // kt − 1, whose slot and planes are free again
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
  // under SYM an off-diagonal tile is stored at (n, m) too
  const bool mirror = SYM && tm != tn;

  if (cluster == 1) {
    float* Ct = Cs + BM * LDC;  // [BN][LDC]: the tile untransposed
    if (mirror) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        Ct[(nf + 8 * ((i >> 1) & 1)) * LDC + 8 * (i / 4) + 2 * t + (i & 1)] =
            acc[i];
    }
    __syncthreads();
    const int rows = mirror ? BM : min(BM, p.M - m0);
    if (!vec_epilogue(p)) {
      // store4 skips rows past the matrix (a mirrored tile's last rows n)
      for (int row = warp; row < rows; row += THREADS / 32) {
        store4(p, b, m0 + row, n0 + 4 * lane,
               *reinterpret_cast<const float4*>(Cs + row * LDC + 4 * lane));
        if (mirror)
          store4(p, b, n0 + row, m0 + 4 * lane,
                 *reinterpret_cast<const float4*>(Ct + row * LDC + 4 * lane));
      }
      return;
    }
    // EPI_ROWS rows a warp at a time (both orientations under SYM), all
    // their addend reads issued before any of their stores, so that the
    // loads' latency is paid once a batch and not once a row (C does not
    // overlap the addend)
    const Epilogue& e = p.epi;
    const float beta = e.beta_vec ? e.beta * e.beta_vec[b] : e.beta;
    const float* add = e.addend ? e.addend + b * e.addend_b : nullptr;
    float* C = p.C + (long long)b * p.M * p.N;
    constexpr int STEP = THREADS / 32;
    for (int r = warp; r < rows; r += STEP * EPI_ROWS) {
      float4 v[2][EPI_ROWS], a[2][EPI_ROWS];
#pragma unroll
      for (int u = 0; u < EPI_ROWS; ++u) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          if (o == 1 && !mirror) break;
          const int row = r + u * STEP;  // < BM: EPI_ROWS · STEP divides BM
          const int i = (o ? n0 : m0) + row, j = (o ? m0 : n0) + 4 * lane;
          v[o][u] = *reinterpret_cast<const float4*>((o ? Ct : Cs) +
                                                     row * LDC + 4 * lane);
          a[o][u] = add && i < p.M && j < p.N
                        ? *reinterpret_cast<const float4*>(
                              add + (long long)i * e.addend_ld + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < EPI_ROWS; ++u) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          if (o == 1 && !mirror) break;
          const int row = r + u * STEP;
          const int i = (o ? n0 : m0) + row, j = (o ? m0 : n0) + 4 * lane;
          if (i < p.M && j < p.N)
            *reinterpret_cast<float4*>(C + (long long)i * p.N + j) =
                make_float4(e.alpha * v[o][u].x + beta * a[o][u].x,
                            e.alpha * v[o][u].y + beta * a[o][u].y,
                            e.alpha * v[o][u].z + beta * a[o][u].z,
                            e.alpha * v[o][u].w + beta * a[o][u].w);
        }
      }
    }
    return;
  }

  // split-K: strip q of the tile summed over the cluster in rank order
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int q = (int)cl.block_rank();
  const int r0 = q * BM / cluster, r1 = (q + 1) * BM / cluster;
  const int G = p.splits / cluster;
  if (G == 1 && !mirror) {  // one cluster a tile: sum and store row by row
    for (int row = r0 + warp; row < min(r1, p.M - m0);
         row += THREADS / 32) {
      const int off = row * LDC + 4 * lane;
      float4 v = *reinterpret_cast<const float4*>(
          cl.map_shared_rank(Cs, 0) + off);
      for (int r = 1; r < cluster; ++r)
        v = add4(v, *reinterpret_cast<const float4*>(
                        cl.map_shared_rank(Cs, r) + off));
      store4(p, b, m0 + row, n0 + 4 * lane, v);
    }
    cl.sync();  // no block leaves while another reads its tile
    return;
  }
  // the strip held in registers past the barrier: for the workspace (G
  // clusters a tile) or the mirrored store
  const int nvec = (r1 - r0) * (BN / 4);
  constexpr int MAXV = BM * BN / 4 / 2 / THREADS;  // cluster ≥ 2
  float4 sum[MAXV];
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    const int off = (r0 + v / (BN / 4)) * LDC + (v % (BN / 4)) * 4;
    float4 in[MAX_CLUSTER];  // all loads in flight, then summed in order
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < cluster)
        in[r] = *reinterpret_cast<const float4*>(cl.map_shared_rank(Cs, r) +
                                                 off);
    sum[u] = in[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < cluster) sum[u] = add4(sum[u], in[r]);
  }
  cl.sync();  // no block leaves while another reads its tile

  if (G > 1) {
    // G clusters a tile: workspace [G][batch][tiles][BM][BN], then the
    // last block to arrive on this (tile, strip) sums the G partials in
    // order
    const long long tile_elems = (long long)BM * BN;
    const long long gstride = (long long)p.batch * gridDim.y * tile_elems;
    float* ws = p.ws + ((long long)b * gridDim.y + blockIdx.y) * tile_elems +
                r0 * BN;
    const int gi = s / cluster;
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int v = tid + u * THREADS;
      if (v >= nvec) break;
      __stcg(reinterpret_cast<float4*>(ws + gi * gstride + 4 * v), sum[u]);
    }
    __syncthreads();  // the block's strip is written …
    int* counter =
        counters + ((long long)b * gridDim.y + blockIdx.y) * cluster + q;
    // the block's verdict, in shared memory past the staged tile (no other
    // block reads this block's shared memory after the cluster barrier)
    int* last = reinterpret_cast<int*>(Cs + BM * LDC);
    if (tid == 0) {
      __threadfence();  // … and (cumulatively) visible before the arrival
      const int prior = atomicAdd(counter, 1);
      *last = prior == G - 1;
      if (*last) {
        *counter = 0;     // ready for the next launch
        __threadfence();  // the others' strips before our reads
      }
    }
    __syncthreads();
    if (!*last) return;
    // cluster partial 0, then 1 … G-1 added in order; each step's loads
    // are independent across u, so MAXV of them are in flight at once
#pragma unroll
    for (int u = 0; u < MAXV; ++u)
      if (tid + u * THREADS < nvec)
        sum[u] = __ldcg(
            reinterpret_cast<const float4*>(ws + 4 * (tid + u * THREADS)));
#pragma unroll 2
    for (int gg = 1; gg < G; ++gg) {
      const float* w = ws + gg * gstride;
#pragma unroll
      for (int u = 0; u < MAXV; ++u)
        if (tid + u * THREADS < nvec)
          sum[u] = add4(sum[u], __ldcg(reinterpret_cast<const float4*>(
                                    w + 4 * (tid + u * THREADS))));
    }
  }
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    store4(p, b, m0 + r0 + v / (BN / 4), n0 + (v % (BN / 4)) * 4, sum[u]);
  }
  if (!mirror) return;
  // the strip at the mirrored place: output rows n0 …, columns m0 + r0 …
  // m0 + r1, through this block's own tile buffer (no other block reads
  // it after the second cluster barrier)
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    *reinterpret_cast<float4*>(Cs + (r0 + v / (BN / 4)) * LDC +
                               (v % (BN / 4)) * 4) = sum[u];
  }
  __syncthreads();
  const int h = r1 - r0;
  for (int e = tid; e < BN * h; e += THREADS) {
    const int n = e / h, c = e % h;
    const int i = n0 + n, j = m0 + r0 + c;
    if (i < p.M && j < p.N)
      p.C[((long long)b * p.M + i) * p.N + j] =
          epilogue_value(p, b, i, j, Cs[(r0 + c) * LDC + n]);
  }
}

template <bool AT, bool BT, bool SYM, int VA, int VB>
cudaError_t launch(const Problem& p, int cluster, int* counters,
                   cudaStream_t stream) {
  auto kernel = tc_gemm_kernel<AT, BT, SYM, VA, VB>;
  constexpr int smem = Smem<AT, BT>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const long long tm = (p.M + BM - 1) / BM;
  const long long tiles = SYM ? tm * (tm + 1) / 2 : tm * ((p.N + BN - 1) / BN);
  if (tiles > 65535 || p.batch > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (unsigned)tiles, p.batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, cluster, counters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool AT, bool BT, bool SYM, int VA>
cudaError_t launch_vb(const Problem& p, int cluster, int* counters,
                      cudaStream_t stream) {
  switch (vec_width(p.B)) {
    case 4: return launch<AT, BT, SYM, VA, 4>(p, cluster, counters, stream);
    case 2: return launch<AT, BT, SYM, VA, 2>(p, cluster, counters, stream);
    default: return launch<AT, BT, SYM, VA, 1>(p, cluster, counters, stream);
  }
}

// Launch C = epilogue(op(A) op(B)) on `stream`; returns the first launch
// error (cudaSuccess if none).  splits > 1 needs 2 ≤ cluster ≤ 8 dividing
// splits; splits > cluster also needs the workspace p.ws (splits / cluster
// · batch · tiles · BM · BN floats) and `counters` (batch · tiles ·
// cluster ints, all 0).  Under SYM, A and B are one stored matrix, copied
// at one width (instantiations for three widths, not nine).
template <bool AT, bool BT, bool SYM>
inline cudaError_t tc_gemm(const Problem& p, int cluster, int* counters,
                           cudaStream_t stream) {
  if (p.batch <= 0 || p.M <= 0 || p.N <= 0 || p.K <= 0 || p.splits < 1 ||
      cluster < 1 || cluster > MAX_CLUSTER || p.splits % cluster != 0 ||
      (p.splits > 1 && cluster < 2) ||
      (p.splits > cluster && (!p.ws || !counters)) || (SYM && p.M != p.N))
    return cudaErrorInvalidValue;
  if constexpr (SYM) {
    const int v = min(vec_width(p.A), vec_width(p.B));
    switch (v) {
      case 4: return launch<AT, BT, SYM, 4, 4>(p, cluster, counters, stream);
      case 2: return launch<AT, BT, SYM, 2, 2>(p, cluster, counters, stream);
      default: return launch<AT, BT, SYM, 1, 1>(p, cluster, counters, stream);
    }
  } else {
    switch (vec_width(p.A)) {
      case 4: return launch_vb<AT, BT, SYM, 4>(p, cluster, counters, stream);
      case 2: return launch_vb<AT, BT, SYM, 2>(p, cluster, counters, stream);
      default: return launch_vb<AT, BT, SYM, 1>(p, cluster, counters, stream);
    }
  }
}

}  // namespace
}  // namespace tc
}  // namespace kfk
