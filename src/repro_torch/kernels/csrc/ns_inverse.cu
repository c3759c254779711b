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
// 4·4·B·d² ≈ 170 MB: 0.73 ms of fp32 FMA at 67 TFLOP/s, 0.05 ms of
// memory.  Design: the shared tiled GEMM (gemm.cuh) as it is — β is the
// epilogue's product scale `alpha`, α the addend's `beta` — so C and the
// output make one round trip.  It is a general product: X·T is not
// symmetric in floating point, so the SYM instantiation is not used.
#include "gemm.cuh"

extern "C" int kfk_ns_gemm_update(const float* C, long long ldC, long long sC,
                                  const float* A, long long ldA, long long sA,
                                  const float* B, long long ldB, long long sB,
                                  float* out, float* ws, int batch, int m,
                                  int n, int k, float alpha, float beta,
                                  int splits, void* stream) {
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
  return (int)kfk::gemm<false, false>(p, (cudaStream_t)stream);
}
