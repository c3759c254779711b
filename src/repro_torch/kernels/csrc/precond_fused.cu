// Two-sided K-FAC preconditioning
//   S = (U_g diag(s_g) U_gᵀ + I/λ_g) J (U_a diag(s_a) U_aᵀ + I/λ_a)
// with per-element λ, as a panel pass and an apply pass:
//   panel:  Cg = diag(s_g) (U_gᵀ J)                      (w_g, d)
//   apply:  W  = U_g Cg + J/λ_g                          (p, d)  workspace
//           Tw = (W U_a) diag(s_a)                       (p, w_a) workspace
//           S  = Tw U_aᵀ + W/λ_a                         (p, d)
//
// Replaces the TPU kernel src/repro/kernels/precond_fused.py,
// precond_fused_pallas: its first pallas_call (body _panel_kernel) and its
// second (body _apply_kernel).
//
// Bound on an H100: operations.  At fc0 in parameter layout (J 16384×2048,
// w_g = w_a = 486) the whole application is 4·p·d·w ≈ 65 GFLOP — about
// 1 ms of fp32 FMA at 67 TFLOP/s — against ~330 MB of compulsory traffic
// (0.1 ms at 3.35 TB/s).
//
// Design: the TPU kernel keeps a (bm, d) W stripe in VMEM and sweeps it
// twice.  fc0's stripe is 8 KB per row, so a useful bm does not fit the
// 227 KB of shared memory; here W and Tw go to workspaces the wrapper
// allocates, and the apply pass is three launches of the shared tiled GEMM
// (each with its epilogue fused: the J/λ_g and W/λ_a terms and the s_a
// column scale never take a separate pass).  Every shape of the path is
// taken as is: ragged w = 486, d = 10 and p = 27 are masked in the GEMM.
// The panel pass contracts over p into a (w_g, d) output, which for small
// buckets has few tiles, so the wrapper may split p over blocks.
#include "gemm.cuh"

extern "C" int kfk_precond_panel(const float* Ug, long long ldUg, long long sUg,
                                 const float* J, long long ldJ, long long sJ,
                                 const float* sg, long long s_sg,
                                 float* Cg, float* ws, int batch, int p_rows,
                                 int d, int wg, int splits, void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = wg;
  p.N = d;
  p.K = p_rows;
  p.A = {Ug, ldUg, sUg};  // stored [p][w_g] = [K][M]
  p.B = {J, ldJ, sJ};     // stored [p][d]   = [K][N]
  p.C = Cg;
  p.epi.row_scale = sg;
  p.epi.row_scale_b = s_sg;
  p.splits = splits;
  p.ws = ws;
  return (int)kfk::gemm<true, false>(p, (cudaStream_t)stream);
}

extern "C" int kfk_precond_apply(const float* J, long long ldJ, long long sJ,
                                 const float* Ug, long long ldUg, long long sUg,
                                 const float* Cg, long long ldCg, long long sCg,
                                 const float* Ua, long long ldUa, long long sUa,
                                 const float* sa, long long s_sa,
                                 const float* ilam_g, const float* ilam_a,
                                 float* W, float* Tw, float* S, int batch,
                                 int p_rows, int d, int wg, int wa,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // W = U_g Cg + J/λ_g
  kfk::Problem w;
  w.batch = batch;
  w.M = p_rows;
  w.N = d;
  w.K = wg;
  w.A = {Ug, ldUg, sUg};
  w.B = {Cg, ldCg, sCg};
  w.C = W;
  w.epi.addend = J;
  w.epi.addend_ld = ldJ;
  w.epi.addend_b = sJ;
  w.epi.beta = 1.f;
  w.epi.beta_vec = ilam_g;
  cudaError_t err = kfk::gemm<false, false>(w, st);
  if (err != cudaSuccess) return (int)err;
  // Tw = (W U_a) diag(s_a)
  const long long pd = (long long)p_rows * d;
  kfk::Problem t;
  t.batch = batch;
  t.M = p_rows;
  t.N = wa;
  t.K = d;
  t.A = {W, d, pd};
  t.B = {Ua, ldUa, sUa};
  t.C = Tw;
  t.epi.col_scale = sa;
  t.epi.col_scale_b = s_sa;
  err = kfk::gemm<false, false>(t, st);
  if (err != cudaSuccess) return (int)err;
  // S = Tw U_aᵀ + W/λ_a
  kfk::Problem s;
  s.batch = batch;
  s.M = p_rows;
  s.N = d;
  s.K = wa;
  s.A = {Tw, wa, (long long)p_rows * wa};
  s.B = {Ua, ldUa, sUa};  // stored [d][w_a] = [N][K]
  s.C = S;
  s.epi.addend = W;
  s.epi.addend_ld = d;
  s.epi.addend_b = pd;
  s.epi.beta = 1.f;
  s.epi.beta_vec = ilam_a;
  return (int)kfk::gemm<false, true>(s, st);
}
