// Low-rank inverse application  Y = (X U) diag(s) Uᵀ + X/λ  with
// per-element 1/λ, as two products on the 3xTF32 tensor-core mainloop
// (tc_gemm.cuh), in one of two layouts:
//   rows form (X stored (p, d), rows contiguous):
//     T  = (X U) diag(s)          (p, w)  workspace   nn_gemm, column scale
//     Y  = T Uᵀ + (1/λ)[b]·X      (p, d)              bt_gemm, addend X
//   columns form (X = Zᵀ, Z stored (d, p), rows contiguous — the left
//   application's transposed view):
//     C  = diag(s) Uᵀ Z           (w, p)  workspace   at_gemm, row scale
//     Yᵀ = U C + (1/λ)[b]·Z       (d, p)              nn_gemm, addend Z
//
// Replaces the TPU kernel src/repro/kernels/lowrank_apply.py,
// lowrank_apply_batched_pallas: its first pallas_call (body _xu_kernel)
// and its second (body _tut_kernel).
//
// Bound on an H100: operations.  At fc0 under nskfac (X 2048×16384,
// w = 486) the application is 4·p·d·w = 65.2 GFLOP: on the tensor cores
// at 3 TF32 products an fp32 one, 0.395 ms at 495 TFLOP/s (fp32 FMA would
// take 0.974 ms) against ~300 MB of compulsory traffic (0.09 ms at 3.35
// TB/s).
//
// Design: as on the TPU, the small product (p·w or w·p entries) goes to
// memory between the two launches.  The two forms are the same products
// as precond_fused's: the rows form its Tw and S products, the columns
// form its panel and its W product.  The columns form takes the left
// application's operand as it lies: Zᵀ's rows are Z's columns, so a
// rows-form launch would need Z copied to contiguous rows (0.28 ms at
// fc0); instead C lands along p as the panel's Cg does, Z is read K-major
// for the AT product and as the addend of the second, and Yᵀ is written
// contiguous (d, p), which the caller views as Y.  Each product takes its
// (splits, cluster) from the wrapper (_build.tc_plan): the Alg-8 shapes
// (p = 256 stats rows) give the first product only 8 output tiles over
// K = d = 16384, split 16 ways in clusters of 2.  Ragged w = 486 and
// d = 10 are masked in the mainloop; K = w = 10 issues the fourth split
// product.  The products and their copy-width pairs are tc_products.cu's,
// shared with precond_fused.cu: this source instantiates no tc_gemm.
#include "tc_products.cuh"

using kfk::tc_products::at_gemm;
using kfk::tc_products::bt_gemm;
using kfk::tc_products::nn_gemm;

// X: the operand as stored — (p, d) in the rows form, Z (d, p) in the
// columns form (cols != 0).  T: the (p, w) or (w, p) workspace.  Y: (p, d)
// or Yᵀ (d, p), contiguous.  plan: (ws, counters, splits, cluster) of the
// first product, then of the second (_build.tc_launch_args).
extern "C" int kfk_lowrank_apply(const float* X, long long ldX, long long sX,
                                 const float* U, long long ldU, long long sU,
                                 const float* s, long long s_s,
                                 const float* ilam, int cols, float* T,
                                 float* Y, float* ws_a, int* cnt_a,
                                 int splits_a, int cluster_a, float* ws_b,
                                 int* cnt_b, int splits_b, int cluster_b,
                                 int batch, int p_rows, int d, int w,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long pw = (long long)p_rows * w;
  kfk::Problem a;
  a.batch = batch;
  a.K = d;
  a.C = T;
  a.splits = splits_a;
  a.ws = ws_a;
  kfk::Problem b;
  b.batch = batch;
  b.K = w;
  b.C = Y;
  b.epi.addend = X;
  b.epi.addend_ld = ldX;
  b.epi.addend_b = sX;
  b.epi.beta = 1.f;
  b.epi.beta_vec = ilam;
  b.splits = splits_b;
  b.ws = ws_b;
  cudaError_t err;
  if (cols) {
    // C = diag(s) Uᵀ Z
    a.M = w;
    a.N = p_rows;
    a.A = {U, ldU, sU};  // stored [d][w] = [K][M]
    a.B = {X, ldX, sX};  // Z stored [d][p] = [K][N]
    a.epi.row_scale = s;
    a.epi.row_scale_b = s_s;
    err = at_gemm(a, cluster_a, cnt_a, st);
    if (err != cudaSuccess) return (int)err;
    // Yᵀ = U C + Z/λ
    b.M = d;
    b.N = p_rows;
    b.A = {U, ldU, sU};    // stored [d][w] = [M][K]
    b.B = {T, p_rows, pw}; // [w][p] = [K][N]
    return (int)nn_gemm(b, cluster_b, cnt_b, st);
  }
  // T = (X U) diag(s)
  a.M = p_rows;
  a.N = w;
  a.A = {X, ldX, sX};  // stored [p][d] = [M][K]
  a.B = {U, ldU, sU};  // stored [d][w] = [K][N]
  a.epi.col_scale = s;
  a.epi.col_scale_b = s_s;
  err = nn_gemm(a, cluster_a, cnt_a, st);
  if (err != cudaSuccess) return (int)err;
  // Y = T Uᵀ + X/λ
  b.M = p_rows;
  b.N = d;
  b.A = {T, w, pw};    // [p][w] = [M][K]
  b.B = {U, ldU, sU};  // stored [d][w] = [N][K]
  return (int)bt_gemm(b, cluster_b, cnt_b, st);
}
