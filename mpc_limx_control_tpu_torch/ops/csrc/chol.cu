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
//                      the same function, the forward sweep inside the
//                      factorization
//
// They are the hot operations of the batched interior-point solver
// (ops/qp.py: one factorization and two solves per Newton step, one fused
// solve for the cold start) and the factorization of the dense ADMM.
//
// Numerics as the TPU bodies define them: pivot d = max(A_jj, 1e-30), the
// column scaled by 1 / sqrt(d), sqrt(d) on the diagonal, the diagonal
// clamped at 1e-30 in both substitutions (applied as its reciprocal), strict
// upper triangle of L written as zero.  Only the lower triangle of M or L
// is read.
//
// Design.  One block per matrix, any batch size, no padding and no
// batch-last layout.  Every kernel brings its triangle into dynamic shared
// memory with 4-byte cp.async copies, tens in flight per thread, and reads
// nothing above the diagonal.
//
// cholesky, posdef_solve: L's lower triangle packed row by row in shared
// memory (row i at i (i + 1) / 2: n (n + 1) / 2 floats, 29 KB at n = 120,
// seven blocks an SM where a square panel fits three), factored by
// chol_common.cuh's factor(): 8-column panels, a row a thread within the
// panel (one barrier a column), then the panel's rank-1 terms on the rest
// of the triangle in 4 x 4 register tiles over the whole block (one
// barrier a panel), every element's chain of fused multiply-adds in the
// column-by-column order, so the factor is the column-by-column one bit for
// bit.  128 threads from n = 65 on, else 64 (measured at n = 120: 0.73 ms
// against 1.06 for a square odd-stride panel on 256 threads, three blocks
// an SM).  cholesky writes L from the unscaled panel (L[i][j] = A[i][j] /
// sqrt(d_j) as it stores, with 16-byte stores when n % 4 == 0), zeros and
// diagonal included.  posdef_solve then runs both sweeps in one warp per
// right-hand side (registers, shuffles, no barrier).  posdef_solve_fast
// appends the k right-hand sides to the packed triangle as k full rows of
// n floats (row n + c at n (n + 1) / 2 + c n: chol_common.cuh's PACKED_RHS),
// so that the factorization's own updates perform the forward substitution
// (row n + c of the factor of [[M, b], [b', .]] is (L^-1 b_c)') and only
// the backward sweep is left; its threads as posdef_solve's.  Its X equals
// posdef_solve's bit for bit: row n + c takes -y_j L[l][j] one fused
// multiply-add at a time, j ascending, then 1 / sqrt(d_l), as the forward
// sweep does.
//
// chol_solve: L's lower triangle packed likewise (half the bytes of the
// square), copied in one cp.async group per 32 rows.  The forward sweep runs
// row block by row block as the groups arrive: lane r takes -L[r][j] y_j for
// the solved rows j above its block (y_j broadcast by shuffle from the
// lane that holds it), then the block's 32 x 32 triangle by the column
// sweep, every row's chain in the column sweep's order (the same y, bit for
// bit).  The backward column sweep reads the packed triangle along rows.
// One warp per right-hand side; with k = 1 the other warps only copy.  In
// the packed layout a 32-aligned block of rows read at one column hits 32
// banks (the triangular numbers of 0..31 are distinct mod 32).
//
// What bounds them on this card: bytes by the roofline (the triangle in
// and, for cholesky, n^2 out, against n^3 / 3 operations), latency in fact:
// n dependent pivot steps with a block barrier each (an IEEE sqrt and
// division on the chain) and 2 n dependent shuffle steps per solve,
// hidden by as many resident blocks as the shared memory allows.  At
// B = 4096 on an H100 (700 W, tools/time_chol_kernels.py, device time of
// graph-replayed launches): cholesky 0.732 ms at n = 120 against a bound
// of 0.106 (bytes), 0.193 at n = 60 against 0.027; chol_solve 0.151
// against 0.037 and 0.050 against 0.0095; posdef_solve 0.773 / 0.210.
// PERF.md section 6 has the rest, posdef_solve_fast's among them.
//
// Limits: shared memory (the triangle and 2 n floats; chol_solve the
// triangle; posdef_solve_fast the triangle, k n and 2 n floats) within the
// 232448 bytes a block can opt in to, and n <= 256 (eight rows per lane);
// the Python wrappers raise beyond.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// each call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include <cstdint>

// Host and device share this layout; ops/chol_cuda.py mirrors it.  (Not in
// the unnamed namespace: a C entry point whose parameter type has internal
// linkage is not exported.)
struct CholParams {
  int n;  // matrix order
  int k;  // right-hand sides (cholesky ignores it)
};

#include "chol_common.cuh"

namespace {

// The lower triangle of a row-major [n][n] global matrix into a packed
// panel, a warp per row; one cp.async group, not waited for.
__device__ inline void copy_lower_packed(float* A, const float* G, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j <= i; j += 32)
      cp_async4(A + at<PACKED>(i, j, 0), G + (size_t)i * n + j);
  cp_async_commit();
}

__host__ __device__ inline int packed_floats(int n) {
  return n * (n + 1) / 2;
}

// ---- cholesky --------------------------------------------------------------
__device__ __forceinline__ float l_value(const float* A, const float* dg,
                                         const float* dginv, int i, int j) {
  return j < i ? A[at<PACKED>(i, j, 0)] * dginv[j] : (j == i ? dg[i] : 0.0f);
}

__global__ void __launch_bounds__(MAX_NT)
cholesky_kernel(const float* __restrict__ M, float* __restrict__ Lout,
                int n) {
  extern __shared__ float sm[];
  float* A = sm;  // packed lower triangle
  float* dg = A + packed_floats(n);
  float* dginv = dg + n;
  const size_t off = (size_t)blockIdx.x * n * n;
  copy_lower_packed(A, M + off, n);
  cp_async_wait<0>();
  __syncthreads();
  factor<PACKED, false>(A, dg, dginv, n, n, 0);
  float* Lb = Lout + off;
  const int tid = threadIdx.x, nt = blockDim.x;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(Lout) & 15) == 0) {
    // four elements of one row a store: n % 4 == 0 keeps each row aligned
    const int q4 = n * n / 4;
    for (int e = tid; e < q4; e += nt) {
      const int i = (4 * e) / n, j = 4 * e - i * n;
      reinterpret_cast<float4*>(Lb)[e] = make_float4(
          l_value(A, dg, dginv, i, j), l_value(A, dg, dginv, i, j + 1),
          l_value(A, dg, dginv, i, j + 2), l_value(A, dg, dginv, i, j + 3));
    }
  } else {
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n;
      Lb[e] = l_value(A, dg, dginv, i, e - i * n);
    }
  }
}

// ---- chol_solve ------------------------------------------------------------
template <int RPL>
__global__ void __launch_bounds__(MAX_NT)
chol_solve_kernel(const float* __restrict__ Lg, const float* __restrict__ rhs,
                  float* __restrict__ X, int n, int k) {
  extern __shared__ float sm[];
  float* A = sm;  // packed lower triangle of L
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* Lb = Lg + (size_t)blockIdx.x * n * n;
  const float* rb = rhs + (size_t)blockIdx.x * n * k;
  float* Xb = X + (size_t)blockIdx.x * n * k;
  const int nb = (n + 31) >> 5;
  // one group of copies per block of 32 rows: the forward sweep starts on
  // the first rows while the rest arrive
  for (int g = 0; g < nb; ++g) {
    const int iend = 32 * g + 32 < n ? 32 * g + 32 : n;
    for (int i = 32 * g + warp; i < iend; i += nw)
      for (int j = lane; j <= i; j += 32)
        cp_async4(A + at<PACKED>(i, j, 0), Lb + (size_t)i * n + j);
    cp_async_commit();
  }
  for (int c0 = 0; c0 < k; c0 += nw) {  // one right-hand side per warp
    const int c = c0 + warp;
    const bool active = c < k;
    float y[RPL], dv[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      y[s] = 0.0f;
      dv[s] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      if (32 * s >= n) break;
      if (c0 == 0) {  // row block s has arrived, for every thread's copies
        cp_async_wait_pending(nb - 1 - s);
        __syncthreads();
      }
      if (active) {
        const int r = 32 * s + lane;
        const bool live = r < n;
        const int row = live ? at<PACKED>(r, 0, 0) : 0;
        float acc = live ? rb[(size_t)r * k + c] : 0.0f;
        // the solved rows above this block, j ascending
#pragma unroll
        for (int t = 0; t < s; ++t)
          for (int jj = 0; jj < 32; ++jj) {
            const float yj = __shfl_sync(FULL, y[t], jj);
            if (live) acc = fmaf(-A[row + 32 * t + jj], yj, acc);
          }
        // this block's triangle by the column sweep
        dv[s] = live ? 1.0f / fmaxf(A[row + r], 1e-30f) : 0.0f;
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * s + jj;
          if (j >= n) break;
          const float yj = __shfl_sync(FULL, acc * dv[s], jj);
          if (lane == jj) acc = yj;
          if (lane > jj && live) acc = fmaf(-A[row + j], yj, acc);
        }
        y[s] = acc;
      }
    }
    if (active) {
      sweep_backward<PACKED, RPL>(A, dv, n, 0, lane, y);
#pragma unroll
      for (int s = 0; s < RPL; ++s) {
        const int r = lane + 32 * s;
        if (r < n) Xb[(size_t)r * k + c] = y[s];
      }
    }
  }
}

// ---- posdef_solve, posdef_solve_fast ---------------------------------------
enum Mode {
  GIVEN_FACTOR,  // chol_solve: the matrix argument is L
  FACTOR,        // posdef_solve: factor the packed triangle, both sweeps
  FACTOR_RHS     // posdef_solve_fast: rhs rows appended to the triangle
};

template <int MODE, int RPL>
__global__ void __launch_bounds__(MAX_NT)
posdef_kernel(const float* __restrict__ Min, const float* __restrict__ rhs,
              float* __restrict__ X, int n, int k) {
  extern __shared__ float sm[];
  constexpr bool RHS = MODE == FACTOR_RHS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float* A = sm;
  float* R = A + packed_floats(n);  // RHS: right-hand side c at R + c n
  float* dg = R + (RHS ? k * n : 0);
  float* dginv = dg + n;
  const float* Mb = Min + (size_t)blockIdx.x * n * n;
  const float* rb = rhs + (size_t)blockIdx.x * n * k;
  float* Xb = X + (size_t)blockIdx.x * n * k;

  copy_lower_packed(A, Mb, n);
  if constexpr (RHS) {
    for (int idx = tid; idx < n * k; idx += nt) {
      const int j = idx / k, c = idx - k * j;
      cp_async4(R + c * n + j, rb + idx);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (RHS) factor<PACKED_RHS>(A, dg, dginv, n, n + k, n);
  else factor<PACKED>(A, dg, dginv, n, n, 0);

  float dv[RPL];
  load_dinv<RPL>(dginv, n, lane, dv);
  for (int c = warp; c < k; c += nw) {
    float b[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int r = lane + 32 * s;
      if constexpr (RHS) b[s] = r < n ? R[c * n + r] : 0.0f;
      else b[s] = r < n ? rb[(size_t)r * k + c] : 0.0f;
    }
    if constexpr (!RHS) sweep_forward<PACKED, RPL>(A, dv, n, 0, lane, b);
    sweep_backward<PACKED, RPL>(A, dv, n, 0, lane, b);
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int r = lane + 32 * s;
      if (r < n) Xb[(size_t)r * k + c] = b[s];
    }
  }
}

using SolveFn = void (*)(const float*, const float*, float*, int, int);

// The instantiation whose rows per lane (1, 2, 4 or 8) cover n; nullptr
// beyond n = 256.  Four sizes and not eight keep the build short: a sweep
// masks the rows beyond n anyway.
template <int RPL>
SolveFn solve_instance(int mode) {
  if (mode == GIVEN_FACTOR) return chol_solve_kernel<RPL>;
  return mode == FACTOR_RHS ? posdef_kernel<FACTOR_RHS, RPL>
                            : posdef_kernel<FACTOR, RPL>;
}

SolveFn solve_fn(int mode, int n) {
  const int rpl = (n + 31) / 32;
  if (rpl <= 1) return solve_instance<1>(mode);
  if (rpl <= 2) return solve_instance<2>(mode);
  if (rpl <= 4) return solve_instance<4>(mode);
  if (rpl <= MAX_RPL) return solve_instance<8>(mode);
  return nullptr;
}

// Threads of a factorizing block.  A packed panel leaves room for seven
// blocks an SM at n = 120 (with posdef_solve_fast's one right-hand side
// too): 128 threads each keep the registers within the SM's (measured
// faster than 256 threads on three square-panel blocks).
inline int factor_threads(int n) { return n > 64 ? 128 : 64; }

// Threads of a chol_solve block: the copies of the triangle, and one warp
// per right-hand side.
inline int solve_threads(int n) {
  int nt = 32 * ((n + 31) / 32);
  if (nt < 64) nt = 64;
  return nt > MAX_NT ? MAX_NT : nt;
}

int smem_bytes_of(int mode, int n, int k) {
  if (mode == GIVEN_FACTOR) return (int)(packed_floats(n) * sizeof(float));
  if (mode == FACTOR)
    return (int)((packed_floats(n) + 2 * n) * sizeof(float));
  return (int)((packed_floats(n) + (size_t)k * n + 2 * n) * sizeof(float));
}

int launch_solve(int mode, const CholParams* prm, const void* M,
                 const void* rhs, void* X, int B, void* stream) {
  const int n = prm->n, k = prm->k;
  if (B <= 0) return 0;
  SolveFn fn = n >= 1 && k >= 1 ? solve_fn(mode, n) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes_of(mode, n, k);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = mode == GIVEN_FACTOR ? solve_threads(n) : factor_threads(n);
  fn<<<B, nt, bytes, (cudaStream_t)stream>>>(
      (const float*)M, (const float*)rhs, (float*)X, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_params_bytes() { return (int)sizeof(CholParams); }

// dynamic shared memory per block
extern "C" int cholesky_smem_bytes(int n, int k) {
  return smem_bytes_of(FACTOR, n, k);
}

extern "C" int chol_solve_smem_bytes(int n, int k) {
  return smem_bytes_of(GIVEN_FACTOR, n, k);
}

extern "C" int posdef_solve_smem_bytes(int n, int k) {
  return smem_bytes_of(FACTOR, n, k);
}

extern "C" int posdef_solve_fast_smem_bytes(int n, int k) {
  return smem_bytes_of(FACTOR_RHS, n, k);
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
  cholesky_kernel<<<B, factor_threads(n), bytes,
                    (cudaStream_t)stream>>>(
      (const float*)M, (float*)L, n);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve(const CholParams* prm, const void* L,
                          const void* rhs, void* X, int B, void* stream) {
  return launch_solve(GIVEN_FACTOR, prm, L, rhs, X, B, stream);
}

extern "C" int posdef_solve(const CholParams* prm, const void* M,
                            const void* rhs, void* X, int B, void* stream) {
  return launch_solve(FACTOR, prm, M, rhs, X, B, stream);
}

extern "C" int posdef_solve_fast(const CholParams* prm, const void* M,
                                 const void* rhs, void* X, int B,
                                 void* stream) {
  return launch_solve(FACTOR_RHS, prm, M, rhs, X, B, stream);
}
