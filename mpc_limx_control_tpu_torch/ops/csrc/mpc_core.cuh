// Shared device-side MPC core of the walking kernels (sm_90a).
//
// Counterpart of mpc_limx_control_tpu/ops/mpc_fused_pallas.py:_prep_mpc
// (:405) + _mpc_core (:64) for the single-support walking QP (nu = 3),
// solve_form = "subst":
//
//   1. in-kernel SRBD linearization at the measured yaw: exact nilpotent
//      ZOH  Ad = I + Ac ts + Ac^2 ts^2/2,  I_w^-1 = Rz I^-1 Rz',  Bd_k from
//      each horizon step's moment arm;
//   2. backward Gramian W_k = Q + Ad' W_{k+1} Ad (W_{N-1} = P);
//   3. band emission K[j,k] = 2 Bd_j' (Ad')^{k-j} W_k Bd_k (j <= k), with
//      2R + rho Gu'Gu + reg I added on the diagonal blocks, so
//      K = H + rho G'G + reg I of the condensed QP;
//   4. f = 2 Bd_j' s_j from a forward error sweep against the level-
//      attitude walking reference and an adjoint sweep;
//   5. in-place Cholesky of K;
//   6. `iters` warm over-relaxed ADMM steps with exact triangular solves,
//      a final solve for z, the residual |Gz - v|inf / (1 + |f|inf) and
//      the one-step prediction xi_pred = Ad x0 + Bd_0 u0.
//
// Design: one thread block of NT = 64 threads per scenario; the whole
// per-scenario working set (K 60x61, the Gramians, Bd, vectors: ~34.6 KB
// at N = 20) lives in dynamic shared memory sized from N.  The block's
// threads share out the Gramian elements, one row of K each (the band
// emission), and the trailing update of the column Cholesky; warp 0 runs
// the sequential sweeps (the f sweeps and the ADMM), keeping each
// substitution's right-hand side in registers (two rows per lane, n <= 64)
// and broadcasting each pivot with a warp shuffle, so a substitution step
// costs no block barrier.
//
// What bounds it on this card: latency, not flops or bytes.  One scenario
// is ~60 barrier-separated Cholesky pivot steps plus 12 x 60 dependent
// substitution steps (6 solves per tick, forward + backward), each a short
// chain of shared-memory loads and FMAs; a solve moves ~20 KB of inputs
// and outputs per scenario in total.  Throughput comes from many
// independent scenario blocks resident per SM (shared memory allows ~6 per
// SM at N = 20), not from the work inside one block.
//
// Ported math only: no 128-lane batch layout, no symmetrization pass (the
// Cholesky reads only the lower triangle, which the band emission writes
// directly), and the 6x3 cone block Gu is applied per horizon step
// instead of a dense kron(I_N, Gu) matrix.
#pragma once

#include <cuda_runtime.h>

namespace mpc {

constexpr int NX = 13;
constexpr int NU = 3;
constexpr int MU = 6;
constexpr int NT = 64;      // threads per block (one scenario per block)
constexpr int MAX_N = 21;   // n = 3N <= 64: two solve rows per lane

// Host and device share this layout; the Python side mirrors it with a
// ctypes.Structure (all fields 4 bytes, so no padding).
struct MpcParams {
  int N;
  int iters;
  float rho, alpha, ts, mass, height_des;
  float q[NX];       // state weights (steps 1..N-1)
  float p[NX];       // terminal weights (step N)
  float dblk[9];     // 2R + rho Gu'Gu + reg I, row-major [3][3]
  float Gu[MU * NU]; // friction-cone block, row-major [6][3]
  float hu[MU];      // cone bounds per step
  float Iinv[9];     // body inertia inverse, row-major
};

// aux-area offsets (floats)
constexpr int AUX_VDES = 0;   // v_des [3]
constexpr int AUX_WDES = 3;   // yaw rate
constexpr int AUX_ANC = 4;    // reference anchor (x, y, yaw)
constexpr int AUX_IW = 7;     // I_w^-1 [3][3]
constexpr int AUX_XS = 16;    // sweep double buffer [2][13]
constexpr int AUX_RES = 42;   // residual
constexpr int AUX_XP = 43;    // xi_pred [13]
constexpr int AUX_SIZE = 64;

struct Smem {
  int K, W, Bd, arms, qe, f, dginv, z, v, y, x0, aux, total;
};

__host__ __device__ inline Smem smem_layout(int N) {
  const int n = NU * N, m = MU * N;
  Smem s;
  int o = 0;
  s.K = o;     o += n * (n + 1);     // lower factor, row stride n + 1
  s.W = o;     o += N * NX * NX;     // Gramians W_k
  s.Bd = o;    o += N * NX * NU;     // Bd_k, row-major [13][3]
  s.arms = o;  o += N * 3;           // stance-foot position per step
  s.qe = o;    o += N * NX;          // weighted errors of the f sweep
  s.f = o;     o += n;
  s.dginv = o; o += n;               // 1 / diag(L)
  s.z = o;     o += 64;
  s.v = o;     o += m;
  s.y = o;     o += m;
  s.x0 = o;    o += 16;
  s.aux = o;   o += AUX_SIZE;
  s.total = o;
  return s;
}

// (Ad' M)[r][c] for M row-major with `ld` columns (Ad = I + nilpotent
// coupling: only rows 6..12 of Ad' M differ from M).
__device__ __forceinline__ float adT_elem(const float* M, int ld, int r,
                                          int c, float ts, float h2,
                                          float cy, float sy) {
  const float m_rc = M[r * ld + c];
  switch (r) {
    case 6: return m_rc + ts * (cy * M[c] - sy * M[ld + c]);
    case 7: return m_rc + ts * (sy * M[c] + cy * M[ld + c]);
    case 8: return m_rc + ts * M[2 * ld + c];
    case 9: case 10: case 11: return m_rc + ts * M[(r - 6) * ld + c];
    case 12: return m_rc + ts * M[11 * ld + c] + h2 * M[5 * ld + c];
    default: return m_rc;
  }
}

// (M Ad)[r][c] for M row-major [13][13].
__device__ __forceinline__ float adR_elem(const float* M, int r, int c,
                                          float ts, float h2, float cy,
                                          float sy) {
  const float* row = M + r * NX;
  switch (c) {
    case 6: return row[6] + ts * (cy * row[0] - sy * row[1]);
    case 7: return row[7] + ts * (sy * row[0] + cy * row[1]);
    case 8: return row[8] + ts * row[2];
    case 9: case 10: case 11: return row[c] + ts * row[c - 6];
    case 12: return row[12] + ts * row[11] + h2 * row[5];
    default: return row[c];
  }
}

// (Ad x)[r] for a 13-vector x.
__device__ __forceinline__ float ad_row(const float* x, int r, float ts,
                                        float h2, float cy, float sy) {
  switch (r) {
    case 0: return x[0] + ts * (cy * x[6] + sy * x[7]);
    case 1: return x[1] + ts * (-sy * x[6] + cy * x[7]);
    case 2: return x[2] + ts * x[8];
    case 3: case 4: return x[r] + ts * x[r + 6];
    case 5: return x[5] + ts * x[11] + h2 * x[12];
    case 11: return x[11] + ts * x[12];
    default: return x[r];
  }
}

// t <- Ad' t in registers.
__device__ __forceinline__ void adT_vec(float (&t)[NX], float ts, float h2,
                                        float cy, float sy) {
  const float t0 = t[0], t1 = t[1], t2 = t[2], t5 = t[5], t11 = t[11];
  t[12] = t[12] + ts * t11 + h2 * t5;
  t[11] = t11 + ts * t5;
  t[10] = t[10] + ts * t[4];
  t[9] = t[9] + ts * t[3];
  t[8] = t[8] + ts * t2;
  t[7] = t[7] + ts * (sy * t0 + cy * t1);
  t[6] = t[6] + ts * (cy * t0 - sy * t1);
}

// Row r of the cone matrix G = kron(I_N, Gu) applied to z.
__device__ __forceinline__ float g_row(const MpcParams& P, const float* z,
                                       int r) {
  const int k = r / MU, i = r - MU * (r / MU);
  const float* g = P.Gu + i * NU;
  const float* zk = z + NU * k;
  return g[0] * zk[0] + g[1] * zk[1] + g[2] * zk[2];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K z = b by forward then backward substitution; warp 0 only.  Lane l
// holds rows l and l + 32 of b in b0 / b1 on entry and of z on exit.
__device__ __forceinline__ void chol_solve_warp(const float* K, int LDK,
                                                const float* dginv, int n,
                                                int lane, float& b0,
                                                float& b1) {
  // L y = b: column sweep, pivot broadcast from its owner lane
  for (int j = 0; j < n; ++j) {
    const int owner = j & 31;
    const float mine = (j < 32) ? b0 : b1;
    const float yj = __shfl_sync(0xffffffffu, mine, owner) * dginv[j];
    if (lane == owner) {
      if (j < 32) b0 = yj; else b1 = yj;
    }
    if (lane > j) b0 -= K[lane * LDK + j] * yj;
    const int r1 = lane + 32;
    if (r1 > j && r1 < n) b1 -= K[r1 * LDK + j] * yj;
  }
  // L' x = y: column sweep from the bottom, rows i < j take L[j][i] x_j
  for (int j = n - 1; j >= 0; --j) {
    const int owner = j & 31;
    const float mine = (j < 32) ? b0 : b1;
    const float xj = __shfl_sync(0xffffffffu, mine, owner) * dginv[j];
    if (lane == owner) {
      if (j < 32) b0 = xj; else b1 = xj;
    }
    if (lane < j) b0 -= K[j * LDK + lane] * xj;
    const int r1 = lane + 32;
    if (r1 < j) b1 -= K[j * LDK + r1] * xj;
  }
}

// z = K^-1 (-f + rho G'(v - y)) into sm z; warp 0 only.
__device__ __forceinline__ void admm_z_update(const MpcParams& P,
                                              const float* K, int LDK,
                                              const float* dginv,
                                              const float* f,
                                              const float* v,
                                              const float* y, float* z,
                                              int n, int lane) {
  float b[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = lane + 32 * s;
    float val = 0.0f;
    if (c < n) {
      const int k = c / NU, bb = c - NU * (c / NU);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < MU; ++i) {
        const int r = MU * k + i;
        acc += P.Gu[i * NU + bb] * (v[r] - y[r]);
      }
      val = -f[c] + P.rho * acc;
    }
    b[s] = val;
  }
  chol_solve_warp(K, LDK, dginv, n, lane, b[0], b[1]);
  if (lane < n) z[lane] = b[0];
  if (lane + 32 < n) z[lane + 32] = b[1];
}

// The whole prep + solve for the scenario of this block.
//
// Staged by the caller in shared memory before the call (and followed by
// a __syncthreads): x0 [13] at L.x0, arms [N][3] at L.arms, v_des / yaw
// rate / anchor in the aux area.  zw / yw point at this scenario's warm
// state in global memory.  On return (after a block barrier): z [n] at
// L.z, y [m] at L.y, the residual at aux[AUX_RES], xi_pred at aux[AUX_XP].
__device__ inline void mpc_prep_solve(const MpcParams& P, float* sm, const Smem& L,
                               const float* __restrict__ zw,
                               const float* __restrict__ yw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = P.N, n = NU * N, m = MU * N, LDK = n + 1;
  float* K = sm + L.K;
  float* W = sm + L.W;
  float* Bd = sm + L.Bd;
  const float* arms = sm + L.arms;
  float* qe = sm + L.qe;
  float* f = sm + L.f;
  float* dginv = sm + L.dginv;
  float* z = sm + L.z;
  float* v = sm + L.v;
  float* y = sm + L.y;
  const float* x0 = sm + L.x0;
  float* aux = sm + L.aux;

  const float ts = P.ts, h2 = ts * ts * 0.5f;
  const float cy = cosf(x0[2]), sy = sinf(x0[2]);

  // ---- 1a. I_w^-1 = Rz I^-1 Rz' at the measured yaw -------------------
  if (tid < 9) {
    const int i = tid / 3, j = tid - 3 * (tid / 3);
    const float Rz[3][3] = {{cy, -sy, 0.0f}, {sy, cy, 0.0f},
                            {0.0f, 0.0f, 1.0f}};
    float acc = 0.0f;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        acc += Rz[i][a] * P.Iinv[a * 3 + b] * Rz[j][b];
    aux[AUX_IW + tid] = acc;
  }
  __syncthreads();

  // ---- 1b. Bd_k from the moment arm r = arm_k - pos (exact ZOH) -------
  for (int k = tid; k < N; k += NT) {
    const float rx = arms[3 * k] - x0[3];
    const float ry = arms[3 * k + 1] - x0[4];
    const float rz = arms[3 * k + 2] - x0[5];
    const float* iw = aux + AUX_IW;
    float T[3][3];  // I_w^-1 [r]x
    for (int i = 0; i < 3; ++i) {
      const float a = iw[3 * i], b = iw[3 * i + 1], c = iw[3 * i + 2];
      T[i][0] = b * rz - c * ry;
      T[i][1] = -a * rz + c * rx;
      T[i][2] = a * ry - b * rx;
    }
    float* Bk = Bd + k * NX * NU;
    const float sp = h2 / P.mass, sv = ts / P.mass;
    for (int a = 0; a < 3; ++a) {
      Bk[0 * 3 + a] = h2 * (cy * T[0][a] + sy * T[1][a]);   // ts^2/2 Rz'T
      Bk[1 * 3 + a] = h2 * (-sy * T[0][a] + cy * T[1][a]);
      Bk[2 * 3 + a] = h2 * T[2][a];
      for (int r = 0; r < 3; ++r) {
        Bk[(3 + r) * 3 + a] = (r == a) ? sp : 0.0f;         // ts^2/(2m) I
        Bk[(6 + r) * 3 + a] = ts * T[r][a];                 // ts T
        Bk[(9 + r) * 3 + a] = (r == a) ? sv : 0.0f;         // ts/m I
      }
      Bk[12 * 3 + a] = 0.0f;
    }
  }

  // ---- 2. backward Gramian recursion (K's storage as scratch) ---------
  {
    float* WN = W + (N - 1) * NX * NX;
    for (int idx = tid; idx < NX * NX; idx += NT) {
      const int r = idx / NX, c = idx - NX * (idx / NX);
      WN[idx] = (r == c) ? P.p[r] : 0.0f;
    }
    __syncthreads();
    float* Z = K;
    for (int k = N - 2; k >= 0; --k) {
      const float* Wn = W + (k + 1) * NX * NX;
      for (int idx = tid; idx < NX * NX; idx += NT) {
        const int r = idx / NX, c = idx - NX * (idx / NX);
        Z[idx] = adT_elem(Wn, NX, r, c, ts, h2, cy, sy);
      }
      __syncthreads();
      float* Wk = W + k * NX * NX;
      for (int idx = tid; idx < NX * NX; idx += NT) {
        const int r = idx / NX, c = idx - NX * (idx / NX);
        Wk[idx] = adR_elem(Z, r, c, ts, h2, cy, sy) + ((r == c) ? P.q[r]
                                                                : 0.0f);
      }
      __syncthreads();
    }
  }

  // ---- 3. band emission: thread (k, b) owns row 3k+b of the lower K ---
  // K[3k+b][3j+a] = K[3j+a][3k+b] = 2 Bd_j' (Ad')^{k-j} W_k Bd_k [a][b]
  if (tid < n) {
    const int k = tid / NU, b = tid - NU * (tid / NU);
    const float* Wk = W + k * NX * NX;
    const float* Bk = Bd + k * NX * NU;
    float t[NX];
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      float acc = 0.0f;
      for (int yy = 0; yy < NX; ++yy) acc += Wk[x * NX + yy] * Bk[yy * NU + b];
      t[x] = acc;
    }
    float* Krow = K + tid * LDK;
    for (int j = k; j >= 0; --j) {
      const float* Bj = Bd + j * NX * NU;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float e = 0.0f;
#pragma unroll
        for (int x = 0; x < NX; ++x) e += t[x] * Bj[x * NU + a];
        float val = 2.0f * e;
        if (j == k) val += P.dblk[a * 3 + b];
        Krow[NU * j + a] = val;    // a > b on j == k lands above the
      }                            // diagonal, which the factor never reads
      if (j > 0) adT_vec(t, ts, h2, cy, sy);
    }
  }

  // ---- 4. linear term f: forward error sweep + adjoint (warp 0) -------
  if (warp == 0) {
    float* xs = aux + AUX_XS;
    const float* vdes = aux + AUX_VDES;
    const float wdes = aux[AUX_WDES];
    const float* anc = aux + AUX_ANC;
    if (lane < NX) xs[lane] = x0[lane];
    __syncwarp();
    int cur = 0;
    for (int j = 0; j < N; ++j) {
      if (lane < NX) {
        const float xn = ad_row(xs + NX * cur, lane, ts, h2, cy, sy);
        // level-attitude walking reference row j + 1
        const float tj = (float)(j + 1) * ts;
        float ref;
        switch (lane) {
          case 2: ref = anc[2] + tj * wdes; break;
          case 3: ref = anc[0] + tj * vdes[0]; break;
          case 4: ref = anc[1] + tj * vdes[1]; break;
          case 5: ref = P.height_des; break;
          case 8: ref = wdes; break;
          case 9: case 10: case 11: ref = vdes[lane - 9]; break;
          case 12: ref = x0[12]; break;
          default: ref = 0.0f;    // roll, pitch, omega_x, omega_y
        }
        const float wq = (j == N - 1) ? P.p[lane] : P.q[lane];
        qe[j * NX + lane] = wq * (xn - ref);
        xs[NX * (1 - cur) + lane] = xn;
      }
      __syncwarp();
      cur = 1 - cur;
    }
    if (lane < NX) xs[NX * cur + lane] = 0.0f;
    __syncwarp();
    for (int j = N - 1; j >= 0; --j) {
      if (lane < NX) {
        const float sj = qe[j * NX + lane]
            + adT_elem(xs + NX * cur, 1, lane, 0, ts, h2, cy, sy);
        xs[NX * (1 - cur) + lane] = sj;
      }
      __syncwarp();
      cur = 1 - cur;
      if (lane < NU) {
        const float* Bj = Bd + j * NX * NU;
        float acc = 0.0f;
        for (int x = 0; x < NX; ++x) acc += Bj[x * NU + lane] * xs[NX * cur + x];
        f[NU * j + lane] = 2.0f * acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 5. in-place Cholesky of the lower triangle of K ----------------
  for (int j = 0; j < n; ++j) {
    const float d = fmaxf(K[j * LDK + j], 1e-30f);
    const float inv = 1.0f / sqrtf(d);
    for (int i = j + 1 + tid; i < n; i += NT) K[i * LDK + j] *= inv;
    if (tid == 0) dginv[j] = inv;
    __syncthreads();
    for (int i = j + 1 + tid; i < n; i += NT) {
      const float lij = K[i * LDK + j];
      float* Ki = K + i * LDK;
      for (int l = j + 1; l <= i; ++l) Ki[l] -= lij * K[l * LDK + j];
    }
    __syncthreads();
  }

  // ---- 6. warm ADMM in factor form (warp 0) ---------------------------
  if (warp == 0) {
    for (int c = lane; c < n; c += 32) z[c] = zw[c];
    __syncwarp();
    for (int r = lane; r < m; r += 32) {
      v[r] = fminf(g_row(P, z, r), P.hu[r % MU]);
      y[r] = yw[r];
    }
    __syncwarp();
    const float alpha = P.alpha, beta = 1.0f - P.alpha;
    for (int it = 0; it < P.iters; ++it) {
      admm_z_update(P, K, LDK, dginv, f, v, y, z, n, lane);
      __syncwarp();
      for (int r = lane; r < m; r += 32) {
        const float gzr = alpha * g_row(P, z, r) + beta * v[r];
        const float vn = fminf(gzr + y[r], P.hu[r % MU]);
        y[r] = y[r] + gzr - vn;
        v[r] = vn;
      }
      __syncwarp();
    }
    admm_z_update(P, K, LDK, dginv, f, v, y, z, n, lane);
    __syncwarp();

    float rp = 0.0f, fm = 0.0f;
    for (int r = lane; r < m; r += 32)
      rp = fmaxf(rp, fabsf(g_row(P, z, r) - v[r]));
    for (int c = lane; c < n; c += 32) fm = fmaxf(fm, fabsf(f[c]));
    rp = warp_max(rp);
    fm = warp_max(fm);
    if (lane == 0) aux[AUX_RES] = rp / (1.0f + fm);
    if (lane < NX) {
      aux[AUX_XP + lane] = ad_row(x0, lane, ts, h2, cy, sy)
          + Bd[lane * NU] * z[0] + Bd[lane * NU + 1] * z[1]
          + Bd[lane * NU + 2] * z[2];
    }
  }
  __syncthreads();
}

}  // namespace mpc
