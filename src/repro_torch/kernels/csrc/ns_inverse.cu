// Batched GEMM with a scale-and-add epilogue:  out = α·C + β·A B
// — the building block of the Newton–Schulz inverse refinement (Mode.NS).
// One step X ← 2X − X(M̂X) is two launches:
//   T  = M̂ X        (α = 0, β = 1: C is a null pointer and never read)
//   X' = 2·X − X T   (α = 2, β = −1, C = X)
//
// Replaces the TPU kernel src/repro/kernels/ns_inverse.py,
// gemm_update_batched_pallas (body _gemm_update_kernel).  The TPU kernel
// reads C on the α = 0 launch too; here a null addend skips it.
//
// Bound on an H100: operations.  At the largest bucket of the paper VGG
// under nskfac (d = 2304, B = 2) a launch is 2·B·d³ ≈ 49 GFLOP against
// 4·4·B·d² ≈ 170 MB: 0.296 ms of 3xTF32 tensor-core work at 495 TFLOP/s
// (0.73 ms of fp32 FMA at 67 TFLOP/s), 0.05 ms of memory.
//
// Design: the 3xTF32 wgmma mainloop of tc_gemm.cuh — β is the epilogue's
// product scale `alpha`, α the addend's `beta` — so C and the output make
// one round trip.  128×128 tiles: 648 blocks at d = 2304, B = 2, one an
// SM, no split.  The smaller buckets (d = 10 … 2048) split K over a
// cluster of up to 8 blocks when their tiles leave SMs idle
// (_build.tc_plan), summed in one launch in a fixed order.  It is a
// general product: X·T is not symmetric in floating point.
#include "tc_gemm.cuh"

extern "C" int kfk_ns_gemm_update(const float* C, long long ldC, long long sC,
                                  const float* A, long long ldA, long long sA,
                                  const float* B, long long ldB, long long sB,
                                  float* out, int batch, int m, int n, int k,
                                  float alpha, float beta, float* ws,
                                  int* counters, int splits, int cluster,
                                  void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = m;
  p.N = n;
  p.K = k;
  p.A = {A, ldA, sA};
  p.B = {B, ldB, sB};
  p.C = out;
  p.epi.alpha = beta;
  if (alpha != 0.f) {
    p.epi.addend = C;
    p.epi.addend_ld = ldC;
    p.epi.addend_b = sC;
    p.epi.beta = alpha;
  }
  p.splits = splits;
  p.ws = ws;
  // X, M̂ and T are (B, d, d) on the path: 16-byte copies, 8-byte at
  // d = 10, 4-byte at d = 27
  using kfk::tc::Widths;
  return (int)kfk::tc::tc_gemm<false, false, false>(
      p, cluster, counters, (cudaStream_t)stream, Widths<4, 4>{},
      Widths<2, 2>{}, Widths<1, 1>{});
}

// Blocks of the tensor-core GEMM resident at once in clusters of
// `cluster` (cudaOccupancyMaxActiveClusters × cluster; negative: a CUDA
// error); the wrappers size split-K by them.  Every instantiation has the
// same block size and one block an SM (its shared memory, 164–200 KB by
// the layout flags, leaves no room for a second), so this file's NN one
// stands for all.
extern "C" int kfk_tc_resident_blocks(int cluster) {
  using namespace kfk::tc;
  auto kernel = tc_gemm_kernel<false, false, false, 4, 4>;
  constexpr int smem = Smem<false, false>::BYTES;
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
  return err == cudaSuccess ? n * cluster : -(int)err;
}
