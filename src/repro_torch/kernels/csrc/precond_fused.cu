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
// w_g = w_a = 486) the panel is 2·p·d·w_g = 32.6 GFLOP against 170 MB and
// the apply three times that against ~308 MB: on the tensor cores at 3
// TF32 products an fp32 one, 0.198 and 0.593 ms (bytes 0.051 and 0.092
// ms; fp32 FMA would take 0.487 and 1.460 ms).
//
// Mainloop: all four products run on the 3xTF32 wgmma mainloop of
// tc_gemm.cuh, each with its epilogue fused, so the J/λ_g and W/λ_a terms
// and the s_g and s_a scales never take a pass of their own:
//   panel  AT: U_g stored [p][w_g] = [K][M] (it lands along M and the split
//          writes K-major planes, as syrk_tn's A), J stored [K][N]; s_g is
//          the row scale.  Few output tiles (64 at fc0) over a long K
//          (p = 16384): the wrapper splits p over a cluster
//          (_build.tc_plan; 2 at fc0, 128 blocks).
//   W      NN: U_g [M][K], Cg [K][N]; addend J, beta_vec 1/λ_g.
//   Tw     NN: W [M][K], U_a stored [d][w_a] = [K][N]; column scale s_a.
//   S      BT: Tw [M][K], U_a read as [N][K] (ea_syrk's stage layout);
//          addend W, beta_vec 1/λ_a.
// W and S (p·d each, 33.5 M entries at fc0) keep the vectorised epilogue
// (an addend with a per-batch beta, no scale); Cg and Tw, small beside
// them, take the row-by-row one that applies a scale.
//
// Design: the TPU kernel keeps a (bm, d) W stripe in VMEM and sweeps it
// twice.  fc0's stripe is 8 KB per row, so a useful bm does not fit the
// 227 KB of shared memory; here W and Tw go to workspaces the wrapper
// allocates (W's write and two reads are ~0.12 ms of HBM at fc0, under
// the apply's operations bound).  The path's w = 486 puts the rows of U_g,
// U_a and Tw 1944 bytes apart: they are copied at 8 bytes.  Every shape of
// the path is taken as is: ragged w = 486, d = 10 and p = 27 are masked in
// the mainloop, and K ≤ 32 (conv0_0's p and w_g = 27) issues the fourth
// split product.
//
// Products: the three layouts are shared with lowrank_apply.cu and
// defined once, with their copy-width pairs, in tc_products.cu.
#include "tc_products.cuh"

using kfk::tc_products::at_gemm;
using kfk::tc_products::bt_gemm;
using kfk::tc_products::nn_gemm;

extern "C" int kfk_precond_panel(const float* Ug, long long ldUg, long long sUg,
                                 const float* J, long long ldJ, long long sJ,
                                 const float* sg, long long s_sg, float* Cg,
                                 float* ws, int* counters, int batch,
                                 int p_rows, int d, int wg, int splits,
                                 int cluster, void* stream) {
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
  return (int)at_gemm(p, cluster, counters, (cudaStream_t)stream);
}

// plan: (ws, counters, splits, cluster) of each of the three products, in
// the order W, Tw, S (_build.tc_launch_args).
extern "C" int kfk_precond_apply(
    const float* J, long long ldJ, long long sJ, const float* Ug,
    long long ldUg, long long sUg, const float* Cg, long long ldCg,
    long long sCg, const float* Ua, long long ldUa, long long sUa,
    const float* sa, long long s_sa, const float* ilam_g,
    const float* ilam_a, float* W, float* Tw, float* S,
    float* ws_w, int* cnt_w, int splits_w, int cluster_w, float* ws_t,
    int* cnt_t, int splits_t, int cluster_t, float* ws_s, int* cnt_s,
    int splits_s, int cluster_s, int batch, int p_rows, int d, int wg, int wa,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long pd = (long long)p_rows * d;
  // W = U_g Cg + J/λ_g
  kfk::Problem w;
  w.batch = batch;
  w.M = p_rows;
  w.N = d;
  w.K = wg;
  w.A = {Ug, ldUg, sUg};  // stored [p][w_g] = [M][K]
  w.B = {Cg, ldCg, sCg};  // stored [w_g][d] = [K][N]
  w.C = W;
  w.epi.addend = J;
  w.epi.addend_ld = ldJ;
  w.epi.addend_b = sJ;
  w.epi.beta = 1.f;
  w.epi.beta_vec = ilam_g;
  w.splits = splits_w;
  w.ws = ws_w;
  cudaError_t err = nn_gemm(w, cluster_w, cnt_w, st);
  if (err != cudaSuccess) return (int)err;
  // Tw = (W U_a) diag(s_a)
  kfk::Problem t;
  t.batch = batch;
  t.M = p_rows;
  t.N = wa;
  t.K = d;
  t.A = {W, d, pd};       // [p][d] = [M][K]
  t.B = {Ua, ldUa, sUa};  // stored [d][w_a] = [K][N]
  t.C = Tw;
  t.epi.col_scale = sa;
  t.epi.col_scale_b = s_sa;
  t.splits = splits_t;
  t.ws = ws_t;
  err = nn_gemm(t, cluster_t, cnt_t, st);
  if (err != cudaSuccess) return (int)err;
  // S = Tw U_aᵀ + W/λ_a
  kfk::Problem s;
  s.batch = batch;
  s.M = p_rows;
  s.N = d;
  s.K = wa;
  s.A = {Tw, wa, (long long)p_rows * wa};  // [p][w_a] = [M][K]
  s.B = {Ua, ldUa, sUa};  // stored [d][w_a] = [N][K]
  s.C = S;
  s.epi.addend = W;
  s.epi.addend_ld = d;
  s.epi.addend_b = pd;
  s.epi.beta = 1.f;
  s.epi.beta_vec = ilam_a;
  s.splits = splits_s;
  s.ws = ws_s;
  return (int)bt_gemm(s, cluster_s, cnt_s, st);
}
