// chol_common: the device functions of the batched Cholesky factorization
// and its two substitution sweeps, shared by csrc/chol.cu (the four K8
// kernels) and csrc/pdip_fused.cu (the fused interior-point kernel).
//
// A panel is a matrix in shared memory with an odd leading dimension (see
// chol.cu), row-major or, with CM, column-major.  factor() is one block's
// in-place lower Cholesky with the TPU bodies' numerics (pivot
// max(A_jj, 1e-30), column scaled by 1 / sqrt(d)); sweep_forward() and
// sweep_backward() are one warp's L y = b and L' x = y with the right-hand
// side in registers, RPL rows per lane.  Of the n x n part of a panel only
// the lower triangle is read or written.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RPL = 8;   // rows per lane of a sweep: n <= 256
constexpr int MAX_NT = 256;  // threads per block

__host__ __device__ inline int odd(int v) { return v | 1; }

// Element (i, j) of a panel: row-major A[i ld + j] or column-major
// A[j ld + i].
template <bool CM>
__device__ __forceinline__ int at(int i, int j, int ld) {
  return CM ? j * ld + i : i * ld + j;
}

// In-place lower Cholesky of the n leading columns of a [rows][n] panel
// (rows >= n).  The strictly-lower part of column j ends in place, sqrt(d_j)
// in dg[j] and its reciprocal in dginv[j]; the diagonal of the panel is left
// as the last trailing update wrote it.  Rows n.. are right-hand sides
// riding on the factorization: row n + c ends as (L^-1 b_c)'.  The caller
// synchronizes the block before the call; the panel is final on return.
template <bool CM>
__device__ inline void factor(float* A, float* dg, float* dginv, int n,
                              int rows, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < n; ++j) {
    const float d = fmaxf(A[at<CM>(j, j, ld)], 1e-30f);
    const float inv = 1.0f / sqrtf(d);
    for (int i = j + 1 + tid; i < rows; i += nt) A[at<CM>(i, j, ld)] *= inv;
    if (tid == 0) {
      dg[j] = sqrtf(d);
      dginv[j] = inv;
    }
    __syncthreads();
    for (int i = j + 1 + tid; i < rows; i += nt) {
      const float lij = A[at<CM>(i, j, ld)];
      const int lmax = i < n ? i : n - 1;
      for (int l = j + 1; l <= lmax; ++l)
        A[at<CM>(i, l, ld)] -= lij * A[at<CM>(l, j, ld)];
    }
    __syncthreads();
  }
}

// L y = b by a column sweep in one warp: lane l holds rows l + 32 s of b
// in b[s] on entry and of y on exit; each pivot is broadcast from its
// owner lane.
template <bool CM, int RPL>
__device__ __forceinline__ void sweep_forward(const float* A,
                                              const float* dginv, int n,
                                              int ld, int lane,
                                              float (&b)[RPL]) {
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = 32 * s + jj;
      if (j >= n) break;
      const float yj = __shfl_sync(0xffffffffu, b[s], jj) * dginv[j];
      if (lane == jj) b[s] = yj;
#pragma unroll
      for (int t = s; t < RPL; ++t) {
        const int r = lane + 32 * t;
        if (r > j && r < n) b[t] -= A[at<CM>(r, j, ld)] * yj;
      }
    }
  }
}

// L' x = y by a column sweep from the bottom: rows i < j take L[j][i] x_j.
template <bool CM, int RPL>
__device__ __forceinline__ void sweep_backward(const float* A,
                                               const float* dginv, int n,
                                               int ld, int lane,
                                               float (&b)[RPL]) {
#pragma unroll
  for (int s = RPL - 1; s >= 0; --s) {
    for (int jj = 31; jj >= 0; --jj) {
      const int j = 32 * s + jj;
      if (j >= n) continue;
      const float xj = __shfl_sync(0xffffffffu, b[s], jj) * dginv[j];
      if (lane == jj) b[s] = xj;
#pragma unroll
      for (int t = 0; t <= s; ++t) {
        const int r = lane + 32 * t;
        if (r < j) b[t] -= A[at<CM>(j, r, ld)] * xj;
      }
    }
  }
}

}  // namespace
