// EA K-factor SYRK update:  out = keep·M + coef·X Xᵀ   (paper eq. 5).
//
// Replaces the TPU kernel src/repro/kernels/ea_syrk.py,
// ea_syrk_batched_pallas (body _ea_syrk_kernel).
//
// Bound on an H100: at the path's shapes (d ≤ 256, n = 256) the symmetric
// product needs n·d·(d+1) FLOP against 4·(2d² + d·n) bytes, about 20 FLOP
// per byte — at the fp32 ridge (67 TFLOP/s ÷ 3.35 TB/s = 20), and at these
// small sizes launch latency dominates in practice.  Design: one tiled GEMM
// (X stored [d][n] is both the non-transposed A and the transposed B) with
// the EA decay fused into the store, so M is read once and the result
// written once — the same single round-trip the TPU kernel's epilogue
// gives.  X Xᵀ is symmetric: only the tiles on or above the diagonal are
// computed, each off-diagonal one stored at both places with its own M
// entry.
#include "gemm.cuh"

extern "C" int kfk_ea_syrk(const float* M, long long ldM, long long sM,
                           const float* X, long long ldX, long long sX,
                           float* out, float* ws, int batch, int d, int n,
                           float keep, float coef, int splits, void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = d;
  p.N = d;
  p.K = n;
  p.A = {X, ldX, sX};
  p.B = {X, ldX, sX};
  p.C = out;
  p.epi.alpha = coef;
  p.epi.addend = M;
  p.epi.addend_ld = ldM;
  p.epi.addend_b = sM;
  p.epi.beta = keep;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::gemm<false, true, true>(p, (cudaStream_t)stream);
}
