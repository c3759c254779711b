// Batched, tiled fp32 GEMM with a fused epilogue: the simple 64×64 SIMT
// mainloop.  Only lowrank_apply runs on it now; ut_a and rinv_apply run on
// the pipelined 128×128 SIMT mainloop of sgemm_pipe.cuh, ns_gemm_update,
// a_perp, ea_syrk, syrk_tn and both precond_fused passes on the 3xTF32
// tensor-core mainloop of tc_gemm.cuh.  All three take the same Problem
// (gemm_common.cuh), so a kernel moves by changing its instantiation.
//
// The problem (operands, strides, epilogue) is described in
// gemm_common.cuh.  A is stored [M][K]; the template flag says how B maps
// onto the product:
//   BT = false: B stored [K][N];  BT = true: B stored [N][K]  (op = Bᵀ)
//
// Design (the simple version): 64×64 output tile per 256-thread block,
// 4×4 outputs per thread in registers, 16-deep K steps staged through shared
// memory.  Each tile loader walks the stored matrix along its contiguous
// axis so global reads coalesce whatever the layout.  Ragged edges (r = 230,
// w = 486, d = 10 or 27) are masked on load (zero fill) and on store.
//
// Cross-block reductions: a product whose output has few tiles but a long K
// (lowrank_apply's X U under Alg 8: a 256 × 486 output contracted over
// d = 16384) splits K over `splits` blocks.  Each writes its partial
// tile to the workspace, and a second pass sums the partials in split
// order and applies the epilogue — no float atomics, so the result is the
// same from run to run.
//
// Bound on an H100: fp32 FMA throughput (67 TFLOP/s) for the large
// products.  This mainloop reaches 18–31 % of it: each thread reads 8
// scalars from shared memory for 16 FMAs, and no global load is in flight
// while the tile is computed.  sgemm_pipe.cuh is the redesign.
#pragma once

#include "gemm_common.cuh"

namespace kfk {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;

namespace {

template <bool BT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Problem p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tile_m = blockIdx.y, tile_n = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  const int b = blockIdx.z / p.splits;
  const int s = blockIdx.z % p.splits;
  const int kchunk = ((p.K + p.splits - 1) / p.splits + BK - 1) / BK * BK;
  const int kbeg = s * kchunk;
  const int kend = min(p.K, kbeg + kchunk);
  const float* A = p.A.ptr + b * p.A.bstride;
  const float* B = p.B.ptr + b * p.B.bstride;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int mm = idx / BK;
      const int kk = idx % BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gm < p.M && gk < kend) v = A[(long long)gm * p.A.ld + gk];
      As[kk][mm] = v;
    }
#pragma unroll
    for (int l = 0; l < (BN * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int nn = BT ? idx / BK : idx % BN;
      const int kk = BT ? idx % BK : idx / BN;
      const int gn = n0 + nn;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gn < p.N && gk < kend)
        v = BT ? B[(long long)gn * p.B.ld + gk] : B[(long long)gk * p.B.ld + gn];
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = m0 + ty + 16 * i;
    if (gi >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx + 16 * j;
      if (gj >= p.N) continue;
      const long long off = ((long long)b * p.M + gi) * p.N + gj;
      if (p.splits == 1) {
        p.C[off] = epilogue_value(p, b, gi, gj, acc[i][j]);
      } else {
        p.ws[(long long)s * p.batch * p.M * p.N + off] = acc[i][j];
      }
    }
  }
}

// Second pass of a split-K product: sum the partial tiles in split order,
// then apply the epilogue.
__global__ void splitk_reduce_kernel(const Problem p) {
  const long long total = (long long)p.batch * p.M * p.N;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % p.N);
    const long long t = idx / p.N;
    const int i = (int)(t % p.M);
    const int b = (int)(t / p.M);
    float acc = 0.f;
    for (int s = 0; s < p.splits; ++s) acc += p.ws[s * total + idx];
    p.C[idx] = epilogue_value(p, b, i, j, acc);
  }
}

// Launch on `stream`; returns the first launch error (cudaSuccess if none).
template <bool BT>
inline cudaError_t gemm(const Problem& p, cudaStream_t stream) {
  if (p.batch <= 0 || p.M <= 0 || p.N <= 0 || p.splits < 1)
    return cudaErrorInvalidValue;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch * p.splits);
  gemm_kernel<BT><<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long total = (long long)p.batch * p.M * p.N;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kfk
