// Pipelined fp32 SIMT GEMM for Hopper: the mainloop of ut_a and
// rinv_apply.
//
// Replaces, through those two kernels, the TPU kernels
// src/repro/kernels/brand_panel.py ut_a_batched_pallas (body _ut_a_kernel;
// C = UᵀA, contracted over d) and src/repro/kernels/cholqr.py
// rinv_apply_batched_pallas (body _rinv_apply_kernel; Q = A B).  It takes
// the Problem of gemm_common.cuh, as tc_gemm.cuh does, so a kernel moves
// between the two by changing its instantiation.
//
// Bound on an H100: fp32 FMA throughput, 67 TFLOP/s (full fp32: no TF32,
// no tensor cores).  At fc0 ut_a is 1.9 GFLOP against 33 MB and
// rinv_apply 2.1 GFLOP against 34 MB, 60–65 FLOP per byte, above the fp32
// ridge of 20.
//
// Design.
// - Tiles: 128×128 outputs per 256-thread block, 16-deep K steps.  Each
//   thread keeps 8×8 outputs in registers as two groups of 4 rows (32
//   apart) by two groups of 4 columns (16 apart), as CUTLASS's SIMT GEMMs
//   do: a warp covers 64×32, and every fragment read is one 16-byte
//   shared-memory load with no bank conflict — 4 loads feed 64 FMAs per
//   k-step (a 64×64 tile with 4×4 outputs a thread reads 8 scalars for
//   16).
//   Fragments are double-buffered in registers across the k-steps.
//   __launch_bounds__(256, 2): two blocks per SM, at most 128 registers.
// - Loads: a ring of STAGES = 4 tiles in dynamic shared memory (67.6 KB),
//   filled by cp.async: while tile s is computed, tiles s+1 … s+3 are in
//   flight.  Both operands sit in shared memory k-major ([BK][128 + 4]).
//   An operand stored k-major in global memory (ut_a's U and A, stored
//   [d][r] and [d][n]; rinv_apply's B) is copied as vectors of V floats:
//   V = 4 (16-byte cp.async.cg) when its base pointer, row stride and
//   batch stride are all 16-byte aligned, else 8 or 4 bytes (cp.async.ca).
//   The width is a template parameter picked per launch; no operand is
//   copied or padded to make it aligned.  TMA is not used: its tensor
//   maps need 16-byte global strides, and the path's U is a column slice
//   of a (d, 486) state (row stride 1944 bytes).  An operand stored with
//   K contiguous (rinv_apply's A, [d][n]) is copied element by element
//   (4-byte cp.async) into its transposed place.
// - Ragged edges (r = 230, n = 240, d = 10 … 16384) are zero-filled by
//   cp.async's source size and masked on store.  A batch stride of 0
//   shares one matrix across the stack.
// - Split-K in one launch, deterministic.  A product with few output tiles
//   and a long K (UᵀA over d = 16384 into 230×256: 4 tiles) splits K over
//   `splits` blocks, blockIdx.x.  Consecutive splits form a thread-block
//   cluster of `cluster` ≤ 8 blocks: each block leaves its partial tile in
//   its own shared memory, and after a cluster barrier block q sums strip
//   q of the tile (BM / cluster rows) over the cluster's blocks in rank
//   order, reading their shared memory (distributed shared memory).  With
//   more than one cluster per tile (splits = G · cluster), each cluster
//   writes its strips to the workspace, and a per-(tile, strip) arrival
//   counter (__threadfence, then atomicAdd on an int) picks the last block
//   to arrive, which sums the G cluster partials in cluster order, applies
//   the epilogue and resets the counter to 0.  The counters are zeroed
//   once, when the wrapper allocates them.  Every sum runs in a fixed
//   order, so the result is bitwise the same from run to run.  The
//   cluster stage spreads the reduction over the cluster's blocks: one
//   last block summing all 28 partial tiles of fc0's ut_a would read
//   1.8 MB alone, a block of a 4-cluster reads 64 KB of distributed shared
//   memory and, if last, 7 strips of 16 KB.
// - The wrapper picks (splits, cluster) per shape from the card's cluster
//   occupancy (_build.pipe_split): a cluster sits within one GPC, so
//   clusters of 3 or more reach only ~120 of the 132 SMs, and a launch
//   with more clusters than fit at once, or that puts two blocks on some
//   SMs and one on others, takes up to twice as long.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_common.cuh"

namespace kfk {
namespace pipe {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int LD = BM + 4;             // shared row stride of a k-major tile
constexpr int TILE = BK * LD;          // floats of one operand, one stage
constexpr int CS_LD = BN + 4;          // row stride of the staged partial
constexpr int SMEM_BYTES = STAGES * 2 * TILE * 4;
static_assert(BM == BN, "both operands share the k-major tile layout");
static_assert(BM * CS_LD <= STAGES * 2 * TILE, "partial tile fits the ring");

namespace {

namespace cg = cooperative_groups;

// One BK × 128 tile of an operand stored k-major ([K][X], X contiguous)
// into dst[k][x]: vectors of V floats.  A thread's column is the same in
// every pass; its row steps by THREADS / (BM / V).
template <int V>
__device__ __forceinline__ void load_kmajor(float* dst, const float* src,
                                            long long ld, int x0, int X,
                                            int k0, int kend) {
  constexpr int PER_ROW = BM / V;
  constexpr int STEP = THREADS / PER_ROW;
  const int k = threadIdx.x / PER_ROW;
  const int x = (threadIdx.x % PER_ROW) * V;
  const int gx = x0 + x;
  const int bytes = gx < X ? min(V, X - gx) * 4 : 0;
  const float* g = src + (long long)(k0 + k) * ld + gx;
#pragma unroll
  for (int l = 0; l < BK / STEP; ++l) {
    const bool in = bytes && k0 + k + l * STEP < kend;
    cp_async<V>(dst + (k + l * STEP) * LD + x, in ? g : src, in ? bytes : 0);
    g += STEP * ld;
  }
}

// One 128 × BK tile of an operand stored x-major ([X][K], K contiguous)
// into dst[k][x], element by element (consecutive threads walk K, so the
// global reads coalesce along the stored rows).
__device__ __forceinline__ void load_xmajor(float* dst, const float* src,
                                            long long ld, int x0, int X,
                                            int k0, int kend) {
  constexpr int STEP = THREADS / BK;
  const int k = threadIdx.x % BK;
  const int x = threadIdx.x / BK;
  const bool kin = k0 + k < kend;
  const float* g = src + (long long)(x0 + x) * ld + k0 + k;
#pragma unroll
  for (int l = 0; l < BM / STEP; ++l) {
    const bool in = kin && x0 + x + l * STEP < X;
    cp_async<1>(dst + k * LD + x + l * STEP, in ? g : src, in ? 4 : 0);
    g += STEP * ld;
  }
}

// AT/BT as in tc_gemm.cuh (A stored [K][M], B stored [N][K]); VA/VB: copy
// width (floats) of a k-major operand.
// Grid: (splits, tiles_m · tiles_n, batch), clusters of `cluster` along x.
template <bool AT, bool BT, int VA, int VB>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_pipe_kernel(const Problem p, int cluster, int* counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_flag;
  float* As = smem;                      // [STAGES][BK][LD]
  float* Bs = smem + STAGES * TILE;      // [STAGES][BK][LD]
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
  const int ra = (warp / 4) * 64 + (lane / 4) * 4;  // rows ra+0..3, ra+32..35
  const int cb = (warp % 4) * 32 + (lane % 4) * 4;  // cols cb+0..3, cb+16..19

  auto load_stage = [&](int slot, int k0) {
    float* a = As + slot * TILE;
    float* bs = Bs + slot * TILE;
    if constexpr (AT) load_kmajor<VA>(a, A, p.A.ld, m0, p.M, k0, kend);
    else load_xmajor(a, A, p.A.ld, m0, p.M, k0, kend);
    if constexpr (BT) load_xmajor(bs, B, p.B.ld, n0, p.N, k0, kend);
    else load_kmajor<VB>(bs, B, p.B.ld, n0, p.N, k0, kend);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, kbeg + st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // … everyone's; slot kt-1 is free again
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_stage(nk % STAGES, kbeg + nk * BK);
    cp_async_commit();
    const float* a = As + (kt % STAGES) * TILE;
    const float* bs = Bs + (kt % STAGES) * TILE;
    float4 fa[2][2], fb[2][2];
    fa[0][0] = *reinterpret_cast<const float4*>(a + ra);
    fa[0][1] = *reinterpret_cast<const float4*>(a + ra + 32);
    fb[0][0] = *reinterpret_cast<const float4*>(bs + cb);
    fb[0][1] = *reinterpret_cast<const float4*>(bs + cb + 16);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < BK) {
        const float* an = a + (kk + 1) * LD;
        const float* bn = bs + (kk + 1) * LD;
        fa[cur ^ 1][0] = *reinterpret_cast<const float4*>(an + ra);
        fa[cur ^ 1][1] = *reinterpret_cast<const float4*>(an + ra + 32);
        fb[cur ^ 1][0] = *reinterpret_cast<const float4*>(bn + cb);
        fb[cur ^ 1][1] = *reinterpret_cast<const float4*>(bn + cb + 16);
      }
      const float av[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z,
                           fa[cur][0].w, fa[cur][1].x, fa[cur][1].y,
                           fa[cur][1].z, fa[cur][1].w};
      const float bv[8] = {fb[cur][0].x, fb[cur][0].y, fb[cur][0].z,
                           fb[cur][0].w, fb[cur][1].x, fb[cur][1].y,
                           fb[cur][1].z, fb[cur][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile

  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gi = m0 + ra + (i < 4 ? i : 28 + i);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(p, b, gi, n0 + cb + 16 * h,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
    return;
  }

  // split-K: stage the partial tile, then sum strip q over the cluster
  float* Cs = smem;  // [BM][CS_LD]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = Cs + (ra + (i < 4 ? i : 28 + i)) * CS_LD + cb;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(row + 16 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int q = (int)cl.block_rank();
  const int r0 = q * BM / cluster, r1 = (q + 1) * BM / cluster;
  const int nvec = (r1 - r0) * (BN / 4);
  constexpr int MAXV = BM * BN / 4 / 2 / THREADS;  // cluster ≥ 2
  float4 sum[MAXV];
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    const int off = (r0 + v / (BN / 4)) * CS_LD + (v % (BN / 4)) * 4;
    float4 part[MAX_CLUSTER];  // all loads in flight, then summed in order
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < cluster)
        part[r] = *reinterpret_cast<const float4*>(
            cl.map_shared_rank(Cs, r) + off);
    sum[u] = part[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < cluster) sum[u] = add4(sum[u], part[r]);
  }
  cl.sync();  // no block leaves while another reads its partial

  const int G = p.splits / cluster;
  if (G == 1) {
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int v = tid + u * THREADS;
      if (v >= nvec) break;
      store4(p, b, m0 + r0 + v / (BN / 4), n0 + (v % (BN / 4)) * 4, sum[u]);
    }
    return;
  }

  // G clusters per tile: workspace [G][batch][tiles][BM][BN], then the last
  // block to arrive on this (tile, strip) sums the G partials in order
  const long long tile_elems = (long long)BM * BN;
  const long long gstride = (long long)p.batch * gridDim.y * tile_elems;
  float* ws = p.ws + ((long long)b * gridDim.y + blockIdx.y) * tile_elems +
              r0 * BN;
  const int g = s / cluster;
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    __stcg(reinterpret_cast<float4*>(ws + g * gstride + 4 * v), sum[u]);
  }
  __syncthreads();  // the block's strip is written …
  int* counter =
      counters + ((long long)b * gridDim.y + blockIdx.y) * cluster + q;
  if (tid == 0) {
    __threadfence();  // … and (cumulatively) visible before the arrival
    const int prior = atomicAdd(counter, 1);
    last_flag = prior == G - 1;
    if (last_flag) {
      *counter = 0;     // ready for the next launch
      __threadfence();  // the others' strips before our reads
    }
  }
  __syncthreads();
  if (!last_flag) return;
  // cluster partial 0, then 1 … G-1 added in order; each step's loads are
  // independent across u, so MAXV of them are in flight at once
#pragma unroll
  for (int u = 0; u < MAXV; ++u)
    if (tid + u * THREADS < nvec)
      sum[u] = __ldcg(reinterpret_cast<const float4*>(ws + 4 * (tid + u * THREADS)));
#pragma unroll 2
  for (int gg = 1; gg < G; ++gg) {
    const float* w = ws + gg * gstride;
#pragma unroll
    for (int u = 0; u < MAXV; ++u)
      if (tid + u * THREADS < nvec)
        sum[u] = add4(sum[u], __ldcg(reinterpret_cast<const float4*>(
                                  w + 4 * (tid + u * THREADS))));
  }
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = tid + u * THREADS;
    if (v >= nvec) break;
    store4(p, b, m0 + r0 + v / (BN / 4), n0 + (v % (BN / 4)) * 4, sum[u]);
  }
}

// Blocks that can be resident at once when launched in clusters of
// `cluster` (cudaOccupancyMaxActiveClusters × cluster), with two blocks an
// SM (per_sm = 2, the kernel's own footprint) or one (per_sm = 1: asked
// with more than half an SM's shared memory, so the count says how many
// SMs clusters of that size can spread over).  Every instantiation has
// the same block size and shared memory, and ptxas gives each at most 128
// registers (__launch_bounds__), so one stands for all.
inline int resident_blocks(int cluster, int per_sm) {
  auto kernel = gemm_pipe_kernel<true, false, 4, 4>;
  const int smem = per_sm == 1 ? 116 * 1024 : SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  const cudaError_t reset = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess) err = reset;
  return err == cudaSuccess ? n * cluster : -(int)err;
}

template <bool AT, bool BT, int VA, int VB>
cudaError_t launch(const Problem& p, int cluster, int* counters,
                   cudaStream_t stream) {
  auto kernel = gemm_pipe_kernel<AT, BT, VA, VB>;
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
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, cluster, counters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool AT, bool BT, int VA>
cudaError_t launch_vb(const Problem& p, int cluster, int* counters,
                      cudaStream_t stream) {
  if constexpr (BT) {
    return launch<AT, BT, VA, 1>(p, cluster, counters, stream);
  } else {
    switch (vec_width(p.B)) {
      case 4: return launch<AT, BT, VA, 4>(p, cluster, counters, stream);
      case 2: return launch<AT, BT, VA, 2>(p, cluster, counters, stream);
      default: return launch<AT, BT, VA, 1>(p, cluster, counters, stream);
    }
  }
}

}  // namespace

// Launch on `stream`; returns the first launch error (cudaSuccess if none).
// splits > 1 needs 2 ≤ cluster ≤ 8 dividing splits; splits > cluster also
// needs the workspace p.ws (splits / cluster · batch · tiles · BM · BN
// floats) and `counters` (batch · tiles · cluster ints, all 0).
template <bool AT, bool BT>
inline cudaError_t gemm_pipe(const Problem& p, int cluster, int* counters,
                             cudaStream_t stream) {
  if (p.batch <= 0 || p.M <= 0 || p.N <= 0 || p.K <= 0 || p.splits < 1 ||
      cluster < 1 || cluster > MAX_CLUSTER || p.splits % cluster != 0 ||
      (p.splits > 1 && cluster < 2) ||
      (p.splits > cluster && (!p.ws || !counters)))
    return cudaErrorInvalidValue;
  if constexpr (!AT) {
    return launch_vb<AT, BT, 1>(p, cluster, counters, stream);
  } else {
    switch (vec_width(p.A)) {
      case 4: return launch_vb<AT, BT, 4>(p, cluster, counters, stream);
      case 2: return launch_vb<AT, BT, 2>(p, cluster, counters, stream);
      default: return launch_vb<AT, BT, 1>(p, cluster, counters, stream);
    }
  }
}

}  // namespace pipe
}  // namespace kfk
