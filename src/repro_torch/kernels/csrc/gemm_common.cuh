// The problem description shared by the package's two GEMM mainloops
// (sgemm_pipe.cuh, the pipelined 128×128 SIMT one; tc_gemm.cuh, the
// 3xTF32 tensor-core one), and the copy and store helpers of both:
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

#include <cstdint>

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

// Copy V floats (4, 8 or 16 bytes) global → shared; the bytes past
// `src_bytes` are zero-filled (src_bytes = 0: nothing is read).
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(V * 4), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy width (floats) at which every row of an operand is aligned.
inline int vec_width(const Operand& o) {
  auto aligned = [&](long long bytes) {
    return (uintptr_t)o.ptr % bytes == 0 && (o.ld * 4) % bytes == 0 &&
           (o.bstride * 4) % bytes == 0;
  };
  return aligned(16) ? 4 : aligned(8) ? 2 : 1;
}

// Store four consecutive outputs (i, j … j+3) through the epilogue; the
// addend is read as one 16-byte vector when its rows allow it.
__device__ __forceinline__ void store4(const Problem& p, int b, int i, int j,
                                       float4 v) {
  if (i >= p.M) return;
  float* c = p.C + ((long long)b * p.M + i) * p.N + j;
  const Epilogue& e = p.epi;
  if (j + 3 < p.N && (p.N & 3) == 0 && ((uintptr_t)p.C & 15) == 0) {
    if (e.addend && !e.row_scale && !e.col_scale &&
        ((uintptr_t)e.addend & 15) == 0 && (e.addend_ld & 3) == 0 &&
        (e.addend_b & 3) == 0) {
      const float4 a = *reinterpret_cast<const float4*>(
          e.addend + b * e.addend_b + (long long)i * e.addend_ld + j);
      const float beta = e.beta_vec ? e.beta * e.beta_vec[b] : e.beta;
      *reinterpret_cast<float4*>(c) = make_float4(
          e.alpha * v.x + beta * a.x, e.alpha * v.y + beta * a.y,
          e.alpha * v.z + beta * a.z, e.alpha * v.w + beta * a.w);
      return;
    }
    *reinterpret_cast<float4*>(c) =
        make_float4(epilogue_value(p, b, i, j, v.x),
                    epilogue_value(p, b, i, j + 1, v.y),
                    epilogue_value(p, b, i, j + 2, v.z),
                    epilogue_value(p, b, i, j + 3, v.w));
    return;
  }
  const float t4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (j + t < p.N) c[t] = epilogue_value(p, b, i, j + t, t4[t]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

}  // namespace
}  // namespace kfk
