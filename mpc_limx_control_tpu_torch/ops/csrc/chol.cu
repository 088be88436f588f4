// chol: batched Cholesky factorization and SPD solves of small dense
// matrices, one matrix per thread block.
//
// Replaces the four kernels of mpc_limx_control_tpu/ops/chol_pallas.py:
//
//   cholesky           _chol_kernel :125 (pallas_call :144)
//                      M [B,n,n] SPD -> lower L [B,n,n], strict upper zero
//   chol_solve         _chol_solve_kernel :156 (pallas_call :172)
//                      L [B,n,n], rhs [B,n,k] -> (L L')^-1 rhs
//   posdef_solve       _posdef_solve_kernel :119 (pallas_call :293)
//                      M, rhs -> M^-1 rhs, factor + both sweeps in one launch
//   posdef_solve_fast  _posdef_fast_kernel :188 (pallas_call :263)
//                      the same function on a column-major factor
//
// They are the hot operations of the batched interior-point solver
// (ops/qp.py: one factorization and two solves per Newton step, one fused
// solve for the cold start) and the factorization of the dense ADMM.
//
// Numerics as the TPU bodies define them: pivot d = max(A_jj, 1e-30), the
// column scaled by 1 / sqrt(d), sqrt(d) on the diagonal, the diagonal
// clamped at 1e-30 in both substitutions (applied as its reciprocal, formed
// once per matrix), strict upper triangle of L written as zero.  Only the
// lower triangle of M is read (posdef_solve_fast reads it as the upper one
// of the symmetric M, row j as column j).
//
// Design.  One block per matrix, any batch size, no padding and no
// batch-last layout: the matrix lives in dynamic shared memory with an odd
// leading dimension, so that a walk down a column (the pivot column of the
// factorization, the forward sweep) and a walk along a row (the backward
// sweep) both hit 32 different banks.  The factorization is n
// barrier-separated pivot steps, the block's threads one row of the
// trailing update each.  A substitution runs in one warp per right-hand
// side, the right-hand side in registers (RPL >= ceil(n / 32) rows per
// lane) and each pivot broadcast by a warp shuffle, so a substitution step
// costs no block barrier (the scheme of mpc_core.cuh's chol_solve_warp).
//
// posdef_solve keeps the factor row-major and runs both sweeps after the
// factorization.  posdef_solve_fast keeps it column-major -- the pivot
// column, the scaled column and every trailing-update access are
// contiguous in shared memory -- with the right-hand sides appended as k
// extra rows of the panel: the factorization's own trailing update then
// performs the forward substitution (row n + c of the factor of
// [[M, b], [b', .]] is (L^-1 b_c)'), on all threads instead of one warp, and
// only the backward sweep is left.  Same arithmetic in the same order as
// posdef_solve; another schedule.
//
// What bounds them on this card: bytes by the roofline (n^2 floats in and,
// for cholesky, out, against n^3 / 3 operations: 0.035 ms of HBM traffic
// against 0.004 ms of f32 work at B = 4096, n = 60), latency in fact: n
// dependent pivot steps with two block barriers each and 2 n dependent
// shuffle steps per solve.  Throughput comes from many resident blocks
// (14.9 KB of shared memory per block at n = 60, 58.6 KB at n = 120).
//
// Limits: n (n | 1) + 2 n floats of shared memory (posdef_solve_fast:
// n ((n + k) | 1) + 2 n) within the 232448 bytes a block can opt in to,
// and n <= 256 (eight rows per lane); the Python wrappers raise beyond.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// each call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

// Host and device share this layout; ops/chol_cuda.py mirrors it.  (Not in
// the unnamed namespace: a C entry point whose parameter type has internal
// linkage is not exported.)
struct CholParams {
  int n;  // matrix order
  int k;  // right-hand sides (cholesky ignores it)
};

#include "chol_common.cuh"

namespace {

// Rows [0, n) of a row-major [n][n] global matrix into a row-major panel.
__device__ inline void load_rows(float* A, const float* __restrict__ G,
                                 int n, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) A[i * ld + j] = G[i * n + j];
}

__host__ __device__ inline int panel_floats(int n, int rows_or_cols) {
  return n * odd(rows_or_cols) + 2 * n;
}

// ---- cholesky --------------------------------------------------------------
__global__ void __launch_bounds__(MAX_NT)
cholesky_kernel(const float* __restrict__ M, float* __restrict__ Lout,
                int n) {
  extern __shared__ float sm[];
  const int ld = odd(n);
  float* A = sm;
  float* dg = A + n * ld;
  float* dginv = dg + n;
  const size_t off = (size_t)blockIdx.x * n * n;
  load_rows(A, M + off, n, ld);
  __syncthreads();
  factor<false>(A, dg, dginv, n, n, ld);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* Lb = Lout + off;
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32)
      Lb[i * n + j] = j < i ? A[i * ld + j] : (j == i ? dg[i] : 0.0f);
}

// ---- the three solves ------------------------------------------------------
enum Mode {
  GIVEN_FACTOR,  // chol_solve: the matrix argument is L
  FACTOR_ROWS,   // posdef_solve: factor row-major, then both sweeps
  FACTOR_COLS    // posdef_solve_fast: column-major panel, rhs rows appended
};

template <int MODE, int RPL>
__global__ void __launch_bounds__(MAX_NT)
solve_kernel(const float* __restrict__ Min, const float* __restrict__ rhs,
             float* __restrict__ X, int n, int k) {
  extern __shared__ float sm[];
  constexpr bool CM = MODE == FACTOR_COLS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int rows = CM ? n + k : n;
  const int ld = CM ? odd(rows) : odd(n);
  float* A = sm;
  float* dg = A + n * ld;
  float* dginv = dg + n;
  const float* Mb = Min + (size_t)blockIdx.x * n * n;
  const float* rb = rhs + (size_t)blockIdx.x * n * k;
  float* Xb = X + (size_t)blockIdx.x * n * k;

  if constexpr (CM) {
    // M is symmetric: its row j is column j of the panel
    for (int j = warp; j < n; j += nw)
      for (int i = lane; i < n; i += 32) A[j * ld + i] = Mb[j * n + i];
    for (int idx = tid; idx < n * k; idx += nt) {
      const int j = idx / k, c = idx - k * (idx / k);
      A[j * ld + n + c] = rb[idx];
    }
  } else {
    load_rows(A, Mb, n, ld);
  }
  __syncthreads();
  if constexpr (MODE == GIVEN_FACTOR) {
    for (int j = tid; j < n; j += nt)
      dginv[j] = 1.0f / fmaxf(A[j * ld + j], 1e-30f);
    __syncthreads();
  } else {
    factor<CM>(A, dg, dginv, n, rows, ld);
  }

  for (int c = warp; c < k; c += nw) {
    float b[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int r = lane + 32 * s;
      if constexpr (CM) b[s] = r < n ? A[r * ld + n + c] : 0.0f;
      else b[s] = r < n ? rb[r * k + c] : 0.0f;
    }
    if constexpr (!CM) sweep_forward<CM, RPL>(A, dginv, n, ld, lane, b);
    sweep_backward<CM, RPL>(A, dginv, n, ld, lane, b);
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int r = lane + 32 * s;
      if (r < n) Xb[r * k + c] = b[s];
    }
  }
}

using SolveFn = void (*)(const float*, const float*, float*, int, int);

// The instantiation whose rows per lane (1, 2, 4 or 8) cover n; nullptr
// beyond n = 256.  Four sizes and not eight keep the build short: a sweep
// masks the rows beyond n anyway.
template <int MODE>
SolveFn solve_fn(int n) {
  const int rpl = (n + 31) / 32;
  if (rpl <= 1) return solve_kernel<MODE, 1>;
  if (rpl <= 2) return solve_kernel<MODE, 2>;
  if (rpl <= 4) return solve_kernel<MODE, 4>;
  if (rpl <= MAX_RPL) return solve_kernel<MODE, 8>;
  return nullptr;
}

inline int threads_for(int rows) {
  int nt = 32 * ((rows + 31) / 32);
  if (nt < 64) nt = 64;
  return nt > MAX_NT ? MAX_NT : nt;
}

template <int MODE>
int solve_smem_bytes(int n, int k) {
  return (int)(panel_floats(n, MODE == FACTOR_COLS ? n + k : n)
               * sizeof(float));
}

template <int MODE>
int launch_solve(const CholParams* prm, const void* M, const void* rhs,
                 void* X, int B, void* stream) {
  const int n = prm->n, k = prm->k;
  if (B <= 0) return 0;
  SolveFn fn = n >= 1 && k >= 1 ? solve_fn<MODE>(n) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = solve_smem_bytes<MODE>(n, k);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = MODE == FACTOR_COLS ? n + k : n;
  fn<<<B, threads_for(rows), bytes, (cudaStream_t)stream>>>(
      (const float*)M, (const float*)rhs, (float*)X, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_params_bytes() { return (int)sizeof(CholParams); }

// dynamic shared memory per block
extern "C" int cholesky_smem_bytes(int n, int k) {
  (void)k;
  return (int)(panel_floats(n, n) * sizeof(float));
}

extern "C" int chol_solve_smem_bytes(int n, int k) {
  return solve_smem_bytes<GIVEN_FACTOR>(n, k);
}

extern "C" int posdef_solve_smem_bytes(int n, int k) {
  return solve_smem_bytes<FACTOR_ROWS>(n, k);
}

extern "C" int posdef_solve_fast_smem_bytes(int n, int k) {
  return solve_smem_bytes<FACTOR_COLS>(n, k);
}

extern "C" int cholesky(const CholParams* prm, const void* M, void* L, int B,
                        void* stream) {
  const int n = prm->n;
  if (B <= 0) return 0;
  if (n < 1 || n > 32 * MAX_RPL) return (int)cudaErrorInvalidValue;
  const int bytes = cholesky_smem_bytes(n, 0);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cholesky_kernel<<<B, threads_for(n), bytes, (cudaStream_t)stream>>>(
      (const float*)M, (float*)L, n);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve(const CholParams* prm, const void* L,
                          const void* rhs, void* X, int B, void* stream) {
  return launch_solve<GIVEN_FACTOR>(prm, L, rhs, X, B, stream);
}

extern "C" int posdef_solve(const CholParams* prm, const void* M,
                            const void* rhs, void* X, int B, void* stream) {
  return launch_solve<FACTOR_ROWS>(prm, M, rhs, X, B, stream);
}

extern "C" int posdef_solve_fast(const CholParams* prm, const void* M,
                                 const void* rhs, void* X, int B,
                                 void* stream) {
  return launch_solve<FACTOR_COLS>(prm, M, rhs, X, B, stream);
}
