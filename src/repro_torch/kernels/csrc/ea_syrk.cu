// EA K-factor SYRK update:  out = keep·M + coef·X Xᵀ   (paper eq. 5).
//
// Replaces the TPU kernel src/repro/kernels/ea_syrk.py,
// ea_syrk_batched_pallas (body _ea_syrk_kernel).
//
// Bound on an H100, counting one triangle of X Xᵀ (n·d·(d+1) FLOP) and
// the traffic of reading M and X once and writing the output once: at
// NS-KFAC's largest bucket (d = 2304, n = 256, B = 2; 2.7 GFLOP against
// 89 MB) bytes, 0.0268 ms at 3.35 TB/s against 0.0165 ms of 3xTF32 work;
// at B-KFAC's dense buckets (d ≤ 256) bytes too, under a microsecond, so
// the launch and the wrapper's host work set the time.
//
// Mainloop: the 3xTF32 wgmma mainloop of tc_gemm.cuh, with op(A) = X
// stored [d][n] (K-major as wgmma's shared-memory operand wants) and
// op(B) = Xᵀ, the same X read as [N][K] (BT).  X Xᵀ is symmetric (SYM):
// only the 128 × 128 tiles on or above the diagonal are computed (342 of
// 648 at d = 2304, B = 2: 2.6 waves, unsplit), and each off-diagonal one
// is stored at both places, each entry with its own M entry.  The EA decay
// is fused into the store (alpha = coef, addend M, beta = keep), so M is
// read once and the result written once — the same single round trip the
// TPU kernel's epilogue gives.  The small buckets split K = n over a
// cluster (_build.tc_plan), summed in one launch in a fixed order.
#include "tc_gemm.cuh"

extern "C" int kfk_ea_syrk(const float* M, long long ldM, long long sM,
                           const float* X, long long ldX, long long sX,
                           float* out, float* ws, int* counters, int batch,
                           int d, int n, float keep, float coef, int splits,
                           int cluster, void* stream) {
  kfk::Problem p;
  p.batch = batch;
  p.M = d;
  p.N = d;
  p.K = n;
  p.A = {X, ldX, sX};  // stored [d][n] = [M][K]
  p.B = {X, ldX, sX};  // stored [d][n] = [N][K]
  p.C = out;
  p.epi.alpha = coef;
  p.epi.addend = M;
  p.epi.addend_ld = ldM;
  p.epi.addend_b = sM;
  p.epi.beta = keep;
  p.splits = splits;
  p.ws = ws;
  // X is (B, d, 256) on the path: 16-byte copies
  using kfk::tc::Widths;
  return (int)kfk::tc::tc_gemm<false, true, true>(
      p, cluster, counters, (cudaStream_t)stream, Widths<4, 4>{},
      Widths<1, 1>{});
}
