// The O(d·r·n) panel of Brand's symmetric update, as two launches:
//   ut_a:    C  = Uᵀ A        (r, n), contracted over d
//   a_perp:  A⊥ = A − U C     (d, n)
//
// Replaces the TPU kernels src/repro/kernels/brand_panel.py,
// ut_a_batched_pallas (body _ut_a_kernel) and a_perp_batched_pallas (body
// _a_perp_kernel), composed there by brand_panel_batched_pallas.
//
// Bound on an H100, at fc0 (d = 16384, r = 230, n = 256), each launch 1.9
// GFLOP: ut_a by operations (fp32 FMA, 0.029 ms; ~33 MB of traffic);
// a_perp, on the tensor cores, by bytes: it reads A (16.8 MB) and U
// (15.1 MB) and writes A⊥ (16.8 MB), 0.0146 ms at 3.35 TB/s against
// 0.0117 ms of 3xTF32 work.
//
// Mainloops: ut_a runs on the pipelined 128×128 SIMT mainloop of
// sgemm_pipe.cuh; a_perp on the 3xTF32 wgmma mainloop of tc_gemm.cuh.
//
// Design: ut_a reduces over d into a small 230×256 output — only 4 output
// tiles of 128×128 per factor, far too few blocks for 132 SMs.  The wrapper
// therefore splits d across blocks (split-K: 28 splits in clusters of 4 at
// fc0, one block on each of 112 SMs), and the mainloop sums the partials
// in one launch, in a fixed order (sgemm_pipe.cuh).  U arrives as the
// column slice [:, :230] of the (d, 486) Brand state, whose rows are
// 8-byte aligned: both kernels read it by 8-byte cp.async, in place.
// a_perp has d/128 row stripes of two 128-column tiles; the two tiles of
// a stripe are neighbours in the grid, so U is read from HBM once, and
// its K = 230 runs as 232 (zero-filled).  Its epilogue fuses the subtraction
// (alpha = −1, addend A, read as 16-byte vectors), so A⊥ is written once.
// C (230×256 fp32, 235 KB) is re-read by every block and stays in the
// 50 MB L2.  Small buckets split K over a cluster (_build.tc_plan).
#include "sgemm_pipe.cuh"
#include "tc_gemm.cuh"

extern "C" int kfk_ut_a(const float* U, long long ldU, long long sU,
                        const float* A, long long ldA, long long sA,
                        float* C, float* ws, int* counters, int batch, int d,
                        int r, int n, int splits, int cluster, void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = r;
  p.N = n;
  p.K = d;
  p.A = {U, ldU, sU};  // stored [d][r] = [K][M]
  p.B = {A, ldA, sA};  // stored [d][n] = [K][N]
  p.C = C;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::pipe::gemm_pipe<true, false>(p, cluster, counters,
                                                (cudaStream_t)stream);
}

extern "C" int kfk_a_perp(const float* A, long long ldA, long long sA,
                          const float* U, long long ldU, long long sU,
                          const float* C, long long ldC, long long sC,
                          float* P, float* ws, int* counters, int batch,
                          int d, int r, int n, int splits, int cluster,
                          void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = d;
  p.N = n;
  p.K = r;
  p.A = {U, ldU, sU};  // stored [d][r] = [M][K]
  p.B = {C, ldC, sC};  // stored [r][n] = [K][N]
  p.C = P;
  p.epi.alpha = -1.f;
  p.epi.addend = A;
  p.epi.addend_ld = ldA;
  p.epi.addend_b = sA;
  p.epi.beta = 1.f;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::tc::tc_gemm<false, false, false>(p, cluster, counters,
                                                    (cudaStream_t)stream);
}

// Blocks of the pipelined GEMM resident at once in clusters of `cluster`,
// two or one an SM (negative: a CUDA error); the wrappers size split-K by
// them.
extern "C" int kfk_pipe_resident_blocks(int cluster, int per_sm) {
  return kfk::pipe::resident_blocks(cluster, per_sm);
}
