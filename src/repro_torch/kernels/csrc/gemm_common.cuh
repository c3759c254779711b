// The problem description shared by the package's two GEMM mainloops
// (gemm.cuh, the 64×64 SIMT GEMM; sgemm_pipe.cuh, the pipelined 128×128
// one):
//
//   C[b] = epilogue(op(A[b]) @ op(B[b]))
//   epilogue(acc)[i, j] = alpha * row_scale[b, i] * col_scale[b, j] * acc
//                         + beta * beta_vec[b] * addend[b, i, j]
//
// Every scale term is optional (null pointer = 1, null addend = no term).
// Each operand is a stack of row-major matrices with its own row stride
// (`ld`, so column slices of a wider matrix need no copy) and batch stride
// (0 = one matrix shared by the whole stack).
#pragma once

#include <cuda_runtime.h>

namespace kfk {

struct Operand {
  const float* ptr;
  long long ld;       // row stride of the stored matrix, in elements
  long long bstride;  // batch stride, in elements (0 = shared)
};

struct Epilogue {
  float alpha = 1.f;
  const float* row_scale = nullptr;  // (batch, M), batch stride row_scale_b
  long long row_scale_b = 0;
  const float* col_scale = nullptr;  // (batch, N), batch stride col_scale_b
  long long col_scale_b = 0;
  const float* addend = nullptr;     // (batch, M, N) row-major
  long long addend_ld = 0;
  long long addend_b = 0;
  float beta = 0.f;
  const float* beta_vec = nullptr;   // (batch,) per-element beta multiplier
};

struct Problem {
  int batch = 0, M = 0, N = 0, K = 0;
  Operand A{}, B{};
  float* C = nullptr;                // (batch, M, N) row-major, contiguous
  Epilogue epi{};
  int splits = 1;                    // > 1: K split over blocks
  int sym = 0;                       // set by gemm<…, SYM> for the reduce
  float* ws = nullptr;               // split-K partial sums
};

// Internal linkage for the kernels and their launchers: every .cu of the
// library includes these headers, and one library links them all.
namespace {

__device__ __forceinline__ float epilogue_value(const Problem& p, int b,
                                                int i, int j, float acc) {
  const Epilogue& e = p.epi;
  float v = e.alpha * acc;
  if (e.row_scale) v *= e.row_scale[b * e.row_scale_b + i];
  if (e.col_scale) v *= e.col_scale[b * e.col_scale_b + j];
  if (e.addend) {
    float beta = e.beta;
    if (e.beta_vec) beta *= e.beta_vec[b];
    v += beta * e.addend[b * e.addend_b + (long long)i * e.addend_ld + j];
  }
  return v;
}

}  // namespace
}  // namespace kfk
