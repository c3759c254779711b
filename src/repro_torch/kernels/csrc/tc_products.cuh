// The three layouts of 3xTF32 tensor-core product (tc_gemm.cuh) that
// precond_fused.cu and lowrank_apply.cu launch, declared once here and
// defined once in tc_products.cu: each instantiates only the copy-width
// pairs its callers' operands give, and none of them is compiled twice.
//
//   at_gemm:  op(A) = Aᵀ, A stored [K][M];  B stored [K][N]
//   nn_gemm:  A stored [M][K];              B stored [K][N]
//   bt_gemm:  A stored [M][K];              op(B) = Bᵀ, B stored [N][K]
//
// Each takes the Problem of gemm_common.cuh and tc_gemm's (cluster,
// counters); it returns the first launch error (cudaSuccess if none).
#pragma once

#include <cuda_runtime.h>

#include "gemm_common.cuh"

namespace kfk {
namespace tc_products {

cudaError_t at_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st);
cudaError_t nn_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st);
cudaError_t bt_gemm(const Problem& p, int cluster, int* counters,
                    cudaStream_t st);

}  // namespace tc_products
}  // namespace kfk
