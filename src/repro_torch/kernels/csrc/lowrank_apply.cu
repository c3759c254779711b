// Low-rank inverse application  Y = (X U) diag(s) Uᵀ + X/λ  with
// per-element 1/λ, as two passes:
//   stage A:  T = (X U) diag(s)        (p, w)  workspace
//   stage B:  Y = T Uᵀ + (1/λ)[b]·X    (p, d)
//
// Replaces the TPU kernel src/repro/kernels/lowrank_apply.py,
// lowrank_apply_batched_pallas: its first pallas_call (body _xu_kernel)
// and its second (body _tut_kernel).
//
// Bound on an H100: operations.  At fc0 under nskfac (X 2048×16384,
// w = 486) the application is 4·p·d·w ≈ 65 GFLOP — about 1 ms of fp32
// FMA at 67 TFLOP/s — against ~330 MB of compulsory traffic (0.1 ms at
// 3.35 TB/s).
//
// Design: as on the TPU, T goes to memory between the stages (it is
// p·w, small next to X).  Stage A is the shared tiled GEMM with s as the
// column scale of its epilogue; it contracts over d into a (p, w)
// output, which at the Alg-8 shapes (p = 256 stats rows) has only 32
// tiles, so the wrapper may split d over blocks (split-K, summed in a
// second pass in split order).  Stage B is the shared GEMM with U read
// transposed (BT) and the X/λ term fused into its epilogue (X is the
// addend, 1/λ the per-batch beta_vec), so X is read once more and Y
// written once.  Ragged w = 486 and d = 10 are masked in the GEMM.
#include "gemm.cuh"

extern "C" int kfk_lowrank_apply(const float* X, long long ldX, long long sX,
                                 const float* U, long long ldU, long long sU,
                                 const float* s, long long s_s,
                                 const float* ilam, float* T, float* ws,
                                 float* Y, int batch, int p_rows, int d,
                                 int w, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // T = (X U) diag(s)
  kfk::Problem a;
  a.batch = batch;
  a.M = p_rows;
  a.N = w;
  a.K = d;
  a.A = {X, ldX, sX};  // stored [p][d] = [M][K]
  a.B = {U, ldU, sU};  // stored [d][w] = [K][N]
  a.C = T;
  a.epi.col_scale = s;
  a.epi.col_scale_b = s_s;
  a.splits = splits;
  a.ws = ws;
  cudaError_t err = kfk::gemm<false>(a, st);
  if (err != cudaSuccess) return (int)err;
  // Y = T Uᵀ + X/λ
  kfk::Problem b;
  b.batch = batch;
  b.M = p_rows;
  b.N = d;
  b.K = w;
  b.A = {T, w, (long long)p_rows * w};
  b.B = {U, ldU, sU};  // stored [d][w] = [N][K]
  b.C = Y;
  b.epi.addend = X;
  b.epi.addend_ld = ldX;
  b.epi.addend_b = sX;
  b.epi.beta = 1.f;
  b.epi.beta_vec = ilam;
  return (int)kfk::gemm<true>(b, st);
}
