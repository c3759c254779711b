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
// Bound on an H100: operations.  At fc0's A⊥ (d = 16384, n = 256)
// syrk_tn needs 1.08 GFLOP (one triangle of the Gram) against 17 MB:
// 0.0065 ms of 3xTF32 work on the tensor cores (0.0051 ms of bytes);
// rinv_apply 2.1 GFLOP against 34 MB, 60 FLOP per byte, above the fp32
// ridge of 20: 0.032 ms on the FMA pipes.
//
// Mainloops: syrk_tn runs on the 3xTF32 wgmma mainloop of tc_gemm.cuh,
// rinv_apply on the pipelined 128×128 SIMT mainloop of sgemm_pipe.cuh.
//
// Design: syrk_tn contracts over A's stored rows: op(A) = Aᵀ with A
// stored [d][n] = [K][M] (AT: its stage lands along M and the split
// transposes it into wgmma's K-major planes), op(B) = A as stored
// ([K][N]).  The Gram is symmetric (SYM): only the 3 tiles of 128 on or
// above the diagonal of its 2 × 2 tile grid are computed, and the
// off-diagonal one is stored twice.  Three tiles cannot fill 132 SMs, so
// the wrapper splits d over 40 blocks at fc0, 5 clusters of 8 a tile
// (_build.tc_plan): each cluster sums its partials in distributed shared
// memory and the last cluster to arrive sums the 5 cluster partials in
// order through a workspace, in one launch, with no float atomics.
// rinv_apply is row-parallel (d/128 row blocks × 2 column blocks); a
// small stack splits its short K (n = 256) as well, to fill the card.  A
// is stored with K contiguous and is copied element by element
// into the k-major shared tile, B (256 KB) is re-read by every row block
// from L2 by 16-byte cp.async.
#include "sgemm_pipe.cuh"
#include "tc_gemm.cuh"

extern "C" int kfk_syrk_tn(const float* A, long long ldA, long long sA,
                           float* G, float* ws, int* counters, int batch,
                           int d, int n, int splits, int cluster,
                           void* stream) {
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
  // A⊥ is (B, d, 256) and the RSVD panel (2, 256, 240): 16-byte copies
  using kfk::tc::Widths;
  return (int)kfk::tc::tc_gemm<true, false, true>(
      p, cluster, counters, (cudaStream_t)stream, Widths<4, 4>{},
      Widths<1, 1>{});
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
