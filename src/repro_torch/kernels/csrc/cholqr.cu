// The two O(d·n²) passes of CholeskyQR2 (tall-skinny QR of A⊥ in the Brand
// update, and the RSVD range finder's re-orthonormalisation):
//   syrk_tn:     G = Aᵀ A      (n, n) fp32, contracted over d
//   rinv_apply:  Q = A B       (d, n), B the (n, n) clamped inverse root
// The (n, n) eigh between them stays in torch.linalg.eigh, as the
// reference leaves it to XLA outside Pallas.
//
// Replaces the TPU kernels src/repro/kernels/cholqr.py,
// syrk_tn_batched_pallas (body _syrk_tn_kernel) and
// rinv_apply_batched_pallas (body _rinv_apply_kernel), orchestrated by
// cholqr2_batched_pallas.
//
// Bound on an H100: operations.  At fc0's A⊥ (d = 16384, n = 256) each
// pass needs 1.1 GFLOP (syrk_tn, one triangle of the Gram) or 2.1 GFLOP
// (rinv_apply) against 17 MB or 34 MB, 60–65 FLOP per byte, above the
// fp32 ridge of 20.
//
// Mainloops: rinv_apply runs on the pipelined 128×128 mainloop of
// sgemm_pipe.cuh; syrk_tn stays on the 64×64 one of gemm.cuh.
//
// Design: syrk_tn reduces over d into a 256×256 Gram (16 output tiles per
// panel), so the wrapper splits d over blocks and the shared GEMM sums the
// partials in a deterministic second pass (no atomics).  The Gram is
// symmetric: only the 10 tiles on or above the diagonal of its 4×4 tile
// grid are computed, and each off-diagonal one is stored twice.
// rinv_apply is row-parallel (d/128 row blocks × 2 column blocks); a
// small stack splits its short K (n = 256) as well, to fill the card.  A
// is stored with K contiguous and is copied element by element
// into the k-major shared tile, B (256 KB) is re-read by every row block
// from L2 by 16-byte cp.async.
#include "gemm.cuh"
#include "sgemm_pipe.cuh"

extern "C" int kfk_syrk_tn(const float* A, long long ldA, long long sA,
                           float* G, float* ws, int batch, int d, int n,
                           int splits, void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = n;
  p.N = n;
  p.K = d;
  p.A = {A, ldA, sA};  // stored [d][n] = [K][M]
  p.B = {A, ldA, sA};  // stored [d][n] = [K][N]
  p.C = G;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::gemm<true, false, true>(p, (cudaStream_t)stream);
}

extern "C" int kfk_rinv_apply(const float* A, long long ldA, long long sA,
                              const float* B, long long ldB, long long sB,
                              float* Q, float* ws, int* counters, int batch,
                              int d, int n, int splits, int cluster,
                              void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = d;
  p.N = n;
  p.K = n;
  p.A = {A, ldA, sA};  // stored [d][n] = [M][K]
  p.B = {B, ldB, sB};  // stored [n][n] = [K][N]
  p.C = Q;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::pipe::gemm_pipe<false, false>(p, cluster, counters,
                                                 (cudaStream_t)stream);
}
