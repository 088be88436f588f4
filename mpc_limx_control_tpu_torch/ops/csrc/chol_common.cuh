// chol_common: the device functions of the batched Cholesky factorization
// and its two substitution sweeps, shared by csrc/chol.cu (the four K8
// kernels), csrc/pdip_fused.cu (the fused interior-point kernel) and the
// MPC core of the walking and standing kernels (csrc/mpc_core.cuh).
//
// A panel is a matrix in shared memory in one of two layouts: PACKED, the
// lower triangle row by row, row i at i (i + 1) / 2 (32-aligned blocks of
// rows then read one column conflict-free: the triangular numbers of 0..31
// are distinct mod 32); PACKED_RHS, the packed triangle of order ld followed
// by full rows of ld floats, row ld + c at ld (ld + 1) / 2 + c ld
// (right-hand sides riding on the factorization, chol.cu's
// posdef_solve_fast: their bytes grow with k, not k^2).  factor() is one
// block's in-place lower Cholesky with the TPU bodies' numerics (pivot
// max(A_jj, 1e-30), column scaled by 1 / sqrt(d)); sweep_forward() and
// sweep_backward() are one warp's L y = b and L' x = y with the right-hand
// side and the reciprocal diagonal in registers, RPL rows per lane.  Of the
// n x n part of a panel only the lower triangle is read or written.
//
// factor() is a right-looking panel scheme.  A panel of PANEL columns is
// factored column by column, a row per thread within the panel's columns
// (one block barrier a column); the rest of the lower triangle then takes
// the panel's PANEL rank-1 terms at once, in TILE x TILE register tiles
// spread over the whole block (one barrier a panel).  Every element keeps
// the arithmetic chain of the column-by-column algorithm: A[i][l] takes
// its -L[i][j] L[l][j] terms one fused multiply-add at a time, j
// ascending, with L[i][j] = A[i][j] * (1 / sqrt(d_j)) formed from the
// unscaled column exactly as the scaled column would hold it.  So the
// factor equals the column-by-column one bit for bit.  The columns are
// scaled once at the end (or, SCALE false, by the caller as it reads them).
// Against the row-per-thread schedule it replaces (two barriers a column,
// the longest row's n - 1 - j dependent shared-memory updates a step) the
// serial part is n + n / 8 barrier-separated steps of at most 7 independent
// updates each.  What bounds it on an H100: that chain's latency (each
// step waits on an IEEE sqrt and division, a shared-memory round trip and
// a barrier), hidden by the blocks an SM holds; the n^3 / 6 fused
// multiply-adds of the tiles are a few percent of the card's f32 rate.
// Measured at B = 4096 (tools/time_chol_kernels.py): 0.732 ms at n = 120
// (parent schedule 2.708), 0.193 at n = 60 (0.355); PERF.md section 6.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RPL = 8;   // rows per lane of a sweep: n <= 256
constexpr int MAX_NT = 256;  // threads per block
constexpr int PANEL = 8;     // columns a panel
constexpr int TILE = 4;      // rows and columns of a trailing-update tile
constexpr unsigned FULL = 0xffffffffu;

enum Layout { PACKED, PACKED_RHS };

// Element (i, j) of a panel: packed lower A[i (i + 1) / 2 + j] (j <= i;
// ld unused), or with PACKED_RHS the rows i >= ld after the triangle
// (branch-free: r = min(i, ld) rows of the triangle, then i - r full rows).
template <int LAY>
__device__ __forceinline__ int at(int i, int j, int ld) {
  if constexpr (LAY == PACKED_RHS) {
    const int r = min(i, ld);
    return ((r * (r + 1)) >> 1) + (i - r) * ld + j;
  }
  return ((i * (i + 1)) >> 1) + j;
}

// ---- asynchronous copies to shared memory ---------------------------------
// 4-byte cp.async: a panel row starts at an odd or triangular offset, so
// 16-byte copies would need a padded layout that costs the odd stride's
// conflict-free column walks; with 4-byte copies every thread keeps tens of
// copies in flight at no register cost, which is what the load needs.
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (0..7) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// ---- the factorization -----------------------------------------------------

// The panel [p0, p1)'s rank-1 terms on the trailing part: rows [p1, rows),
// columns [p1, n), l <= i, in TILE x TILE tiles.  Tile (a, b) covers rows
// p1 + TILE a.. and columns p1 + TILE b..; the tiles that touch the lower
// part are b <= a for the square rows and every b for the right-hand-side
// rows below them, numbered row-tile by row-tile.
template <int LAY>
__device__ inline void trailing_update(float* A, const float* dginv, int n,
                                       int rows, int ld, int p0, int p1) {
  const int nrt = (rows - p1 + TILE - 1) / TILE;
  const int nct = (n - p1 + TILE - 1) / TILE;
  const int tri = nct * (nct + 1) / 2;
  const int ntiles = tri + (nrt - nct) * nct;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    int a, b;
    if (t < tri) {
      a = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
      while (a * (a + 1) / 2 > t) --a;
      while ((a + 1) * (a + 2) / 2 <= t) ++a;
      b = t - a * (a + 1) / 2;
    } else {
      a = nct + (t - tri) / nct;
      b = (t - tri) % nct;
    }
    const int i0 = p1 + TILE * a, l0 = p1 + TILE * b;
    float acc[TILE][TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u)
#pragma unroll
      for (int v = 0; v < TILE; ++v) {
        const int i = i0 + u, l = l0 + v;
        acc[u][v] = (i < rows && l < n && l <= i) ? A[at<LAY>(i, l, ld)]
                                                  : 0.0f;
      }
    for (int j = p0; j < p1; ++j) {
      const float dj = dginv[j];
      float r[TILE], c[TILE];
#pragma unroll
      for (int u = 0; u < TILE; ++u) {
        const int i = i0 + u;
        r[u] = i < rows ? A[at<LAY>(i, j, ld)] * dj : 0.0f;
      }
      // column l < n: a row of the triangle in either layout
#pragma unroll
      for (int v = 0; v < TILE; ++v) {
        const int l = l0 + v;
        c[v] = l < n ? A[at<PACKED>(l, j, ld)] * dj : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u)
#pragma unroll
        for (int v = 0; v < TILE; ++v)
          acc[u][v] = fmaf(-r[u], c[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < TILE; ++u)
#pragma unroll
      for (int v = 0; v < TILE; ++v) {
        const int i = i0 + u, l = l0 + v;
        if (i < rows && l < n && l <= i) A[at<LAY>(i, l, ld)] = acc[u][v];
      }
  }
}

// In-place lower Cholesky of the n leading columns of a [rows][n] panel
// (rows >= n).  sqrt(d_j) ends in dg[j] and its reciprocal in dginv[j];
// with SCALE the strictly-lower part of column j ends in place as L, else
// it is left unscaled (L[i][j] = A[i][j] * dginv[j], the caller's product);
// the diagonal of the panel is left as the last update wrote it.  Rows n..
// are right-hand sides riding on the factorization: row n + c ends as
// (L^-1 b_c)' (scaled likewise).  The caller synchronizes the block before
// the call; the panel is final on return.
template <int LAY, bool SCALE = true>
__device__ inline void factor(float* A, float* dg, float* dginv, int n,
                              int rows, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int p0 = 0; p0 < n; p0 += PANEL) {
    const int p1 = p0 + PANEL < n ? p0 + PANEL : n;
    for (int j = p0; j < p1; ++j) {
      const float d = fmaxf(A[at<PACKED>(j, j, ld)], 1e-30f);
      const float inv = 1.0f / sqrtf(d);
      if (tid == 0) {
        dg[j] = sqrtf(d);
        dginv[j] = inv;
      }
      for (int i = j + 1 + tid; i < rows; i += nt) {
        const float lij = A[at<LAY>(i, j, ld)] * inv;
        const int lmax = i < p1 - 1 ? i : p1 - 1;
        // the pivot column (rows l < n: the triangle in either layout) and
        // the row's targets staged in registers, so that no load waits on
        // a store
        float c[PANEL], a[PANEL];
#pragma unroll
        for (int q = 1; q < PANEL; ++q) {
          const int l = j + q;
          c[q] = l <= lmax ? A[at<PACKED>(l, j, ld)] * inv : 0.0f;
          a[q] = l <= lmax ? A[at<LAY>(i, l, ld)] : 0.0f;
        }
#pragma unroll
        for (int q = 1; q < PANEL; ++q)
          if (j + q <= lmax) A[at<LAY>(i, j + q, ld)] = fmaf(-lij, c[q], a[q]);
      }
      __syncthreads();
    }
    if (p1 < n) {
      trailing_update<LAY>(A, dginv, n, rows, ld, p0, p1);
      __syncthreads();
    }
  }
  if constexpr (SCALE) {
    const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
    for (int i = 1 + warp; i < rows; i += nw) {
      const int jmax = i < n ? i : n;
      for (int j = lane; j < jmax; j += 32) A[at<LAY>(i, j, ld)] *= dginv[j];
    }
    __syncthreads();
  }
}

// ---- the sweeps ------------------------------------------------------------

// The reciprocal pivots of rows lane + 32 s, from dginv in shared memory.
template <int RPL>
__device__ __forceinline__ void load_dinv(const float* dginv, int n, int lane,
                                          float (&dv)[RPL]) {
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = lane + 32 * s;
    dv[s] = r < n ? dginv[r] : 0.0f;
  }
}

// L y = b by a column sweep in one warp: lane l holds rows l + 32 s of b
// in b[s] on entry and of y on exit, and the reciprocal pivots of those
// rows in dv[s]; each y_j is formed by its owner lane and broadcast.
template <int LAY, int RPL>
__device__ __forceinline__ void sweep_forward(const float* A,
                                              const float (&dv)[RPL], int n,
                                              int ld, int lane,
                                              float (&b)[RPL]) {
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = 32 * s + jj;
      if (j >= n) break;
      const float yj = __shfl_sync(FULL, b[s] * dv[s], jj);
      if (lane == jj) b[s] = yj;
#pragma unroll
      for (int t = s; t < RPL; ++t) {
        const int r = lane + 32 * t;
        if (r > j && r < n) b[t] = fmaf(-A[at<LAY>(r, j, ld)], yj, b[t]);
      }
    }
  }
}

// L' x = y by a column sweep from the bottom: rows i < j take L[j][i] x_j.
template <int LAY, int RPL>
__device__ __forceinline__ void sweep_backward(const float* A,
                                               const float (&dv)[RPL], int n,
                                               int ld, int lane,
                                               float (&b)[RPL]) {
#pragma unroll
  for (int s = RPL - 1; s >= 0; --s) {
    for (int jj = 31; jj >= 0; --jj) {
      const int j = 32 * s + jj;
      if (j >= n) continue;
      const float xj = __shfl_sync(FULL, b[s] * dv[s], jj);
      if (lane == jj) b[s] = xj;
#pragma unroll
      for (int t = 0; t <= s; ++t) {
        const int r = lane + 32 * t;
        if (r < j) b[t] = fmaf(-A[at<LAY>(j, r, ld)], xj, b[t]);
      }
    }
  }
}

}  // namespace
