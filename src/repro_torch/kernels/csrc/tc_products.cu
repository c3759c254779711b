// The products of precond_fused.cu and lowrank_apply.cu on the 3xTF32
// tensor-core mainloop (tc_gemm.cuh), one definition each (declared in
// tc_products.cuh).  The two sources launch the same layouts with the same
// operands' alignments, so sharing one instantiation of each saves its
// compile time in a second source.
//
// Instantiations: the copy-width pairs (A, B), in floats, that the paths'
// operands give, then (1, 1) for any other layout (tc_gemm).  The paths'
// w = 486 puts the rows of U_g, U_a, U (lowrank_apply) and the workspaces
// Tw and T 1944 bytes apart: they are copied at 8 bytes.
#include "tc_products.cuh"

#include "tc_gemm.cuh"

namespace kfk {
namespace tc_products {

using tc::Widths;

cudaError_t at_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st) {
  // precond panel (U_g, J): w_g = 486 (8-byte rows) or 27 (4-byte), d = 10
  // (8-byte); lowrank_apply's columns form C = diag(s) Uᵀ Z (U, Z): w = 486
  // and p = 2048 or 512 (16-byte)
  return tc::tc_gemm<true, false, false>(p, cluster, counters, st,
                                         Widths<2, 4>{}, Widths<2, 2>{},
                                         Widths<1, 4>{}, Widths<1, 1>{});
}

cudaError_t nn_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st) {
  // precond W = U_g Cg: (2, 4), (1, 4) at conv0_0, (2, 2) at d = 10;
  // precond Tw = W U_a: (4, 2) (U_a's w_a = 486 or 230; 64 and 128 take it
  // too), (2, 2) at d = 10;
  // lowrank_apply's rows form T = X U: (4, 2), (2, 2) at d = 10; its
  // columns form Yᵀ = U C: (2, 4)
  return tc::tc_gemm<false, false, false>(
      p, cluster, counters, st, Widths<4, 2>{}, Widths<2, 4>{},
      Widths<2, 2>{}, Widths<1, 4>{}, Widths<1, 1>{});
}

cudaError_t bt_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st) {
  // precond S = Tw U_aᵀ, both w_a wide: 16-byte rows at w_a = 128 and 64,
  // 8-byte at 486, 230 and 10; lowrank_apply's rows form Y = T Uᵀ, both w
  // wide: 8-byte at w = 486 and 10
  return tc::tc_gemm<false, true, false>(p, cluster, counters, st,
                                         Widths<4, 4>{}, Widths<2, 2>{},
                                         Widths<1, 1>{});
}

}  // namespace tc_products
}  // namespace kfk
