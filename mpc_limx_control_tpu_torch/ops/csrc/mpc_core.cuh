// Shared device-side MPC core of the walking and standing kernels (sm_90a).
//
// Counterpart of mpc_limx_control_tpu/ops/mpc_fused_pallas.py:_prep_mpc
// (:405) + _mpc_core (:64), solve_form = "subst", for the single-support
// walking QP (NU = 3: one 3-vector GRF per horizon step) and the two-foot
// standing QP (NU = 6: both feet's GRF per step, _prep_mpc's two_feet):
//
//   1. in-kernel SRBD linearization at the measured yaw: exact nilpotent
//      ZOH  Ad = I + Ac ts + Ac^2 ts^2/2,  I_w^-1 = Rz I^-1 Rz',  Bd_k from
//      each horizon step's moment arm(s) (mpc_prep_solve), or Ad, Bd_k and
//      the reference rows as given (the generic fused QP, fused_qp.cu);
//   2. backward Gramian W_k = Q + Ad' W_{k+1} Ad (W_{N-1} = P);
//   3. band emission K[j,k] = 2 Bd_j' (Ad')^{k-j} W_k Bd_k (j <= k), with
//      2R + rho Gu'Gu + reg I added on each foot's diagonal block, so
//      K = H + rho G'G + reg I of the condensed QP;
//   4. f = 2 Bd_j' s_j from a forward error sweep against the reference
//      rows and an adjoint sweep;
//   5. in-place Cholesky of K;
//   6. `iters` warm over-relaxed ADMM steps with exact triangular solves,
//      a final solve for z, the residual |Gz - v|inf / (1 + |f|inf) and
//      the one-step prediction xi_pred = Ad x0 + Bd_0 u0.
//
// solve_form = "inv" (mpc_fused_pallas.py:230-263, :273-280) is the
// compile-time flag INV of the core, taken where the TPU kernel takes it,
// n <= 64 at either NU (:249; past that it runs the sweeps, and so do the
// launchers, which pick the INV instantiation only for n <= 64: N <= 21
// walking, N <= 10 standing): after step 5 the
// factor is inverted once, T = L^-1, and each z-update of step 6 is the
// two dense triangular mat-vecs x = T'(T b) instead of two substitution
// sweeps.  T is a packed lower triangle in a region of its own (the
// layout's `inv` argument), one column a thread (a forward substitution
// against e_j, no barrier); the mat-vecs run in warp 0, a row (then a
// column) of T per lane.  Row i of a packed triangle starts at
// i (i + 1) / 2, and the triangular numbers are a complete residue system
// modulo 32, so 32 consecutive rows start in 32 different banks.
//
// The core is a template over NU, the solve rows a lane RPL and two
// policies: how Ad is applied (the closed forms of the SRBD Ad, AdSrbd,
// or a dense 13 x 13 in shared memory, AdDense) and where a reference row
// comes from (synthesized level-attitude ramps, RefLevel, or rows read
// from shared memory, RefGiven).
//
// Design: one thread block per scenario (64 threads at NU = 3, 128 at
// NU = 6), the whole per-scenario working set in dynamic shared memory
// sized from N, one code path at both NU:
//   - K a packed lower triangle; the Gramian recursion keeps one W_k and
//     its scratch in K's storage and leaves only S_k = W_k Bd_k [13][NU]
//     per step, the band emission's sole read of the Gramians;
//   - the emission walks the rows tid, tid + NT, ..., so no row of K
//     needs a thread of its own;
//   - step 5 is the panel factorization of chol_common.cuh (factor<PACKED>:
//     n + n / 8 barrier-separated steps, every element's fused
//     multiply-add chain that of a column-by-column Cholesky, so the same
//     factor bit for bit);
//   - step 6 runs in warp 0: its two sweeps (sweep_forward /
//     sweep_backward) with the right-hand side and the reciprocal pivots
//     in registers, RPL rows a lane: 2 / 4 / 8 for n <= 64 / 128 / 256
//     (rpl<NU>(N); at NU = 6 at least 4), so the horizon reaches n <= 256:
//     N <= 85 walking, 42 standing;
//   - z, v and y take S's storage once the emission is done (n + 2 m =
//     5 NU N of 13 NU N floats), sqrt(d) and 1 / sqrt(d) the f sweep's.
// Shared memory at N = 20: 15.4 KB walking (a square K and the N
// Gramians took 34.6 KB: six blocks an SM, now fourteen), 37.5 KB
// standing with one step-invariant Bd, 45.2 KB with N Bd blocks and Ad
// (fused_qp nu = 6).  A walking block alone takes ~341k cycles, 70k of
// them in the factorization and 101k in the ADMM, and B = 4096 walking
// ticks 0.62 ms; a standing block ~604k cycles (175k, 273k), B = 4096
// standing ticks 1.85 ms (NVIDIA H100 80GB HBM3, tools/time_mpc_kernels.py;
// PERF.md section 6).
//
// What bounds it on this card: latency, not flops or bytes.  One scenario
// is a chain of barrier-separated pivot steps plus 12 x n dependent
// substitution steps (6 solves per tick, forward + backward), each a short
// chain of shared-memory loads and FMAs; a solve moves ~20-40 KB of inputs
// and outputs per scenario in total.  Throughput comes from many
// independent scenario blocks resident per SM, so the card's lever is the
// shared memory and registers a block takes.  Hopper's asynchronous copies
// (cp.async, TMA) have nothing to hide: a block stages ~200 floats of
// inputs against ~300k cycles of dependent pivots.  Its tensor cores need
// TF32 or lower for f32 inputs, which this controller cannot take (a
// reduced-precision product once sent the KF to NaN and the walking height
// to 0.56 m).
//
// Ported math only: no 128-lane batch layout, no symmetrization pass (the
// Cholesky reads only the lower triangle, which the band emission writes
// directly), and the 6x3 cone block Gu is applied per foot per horizon
// step instead of a dense kron(I_N, blockdiag(Gu, Gu)) matrix.
#pragma once

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace mpc {

constexpr int NX = 13;

// ---- stage clocks, compiled in only for a timing build ---------------------
// A build that defines MPC_STAGE_CLOCKS (tools/time_mpc_kernels.py --stages;
// ops/_build.py's normal build never does) records clock64() at the stage
// boundaries of every block b < STAGE_MAX_B, read by thread 0 (the
// clocks of a block's other warps do not agree with its own).  Each
// source that launches the core exports a reader
// (MPC_STAGE_READER) that copies the [STAGE_MAX_B][STAGE_SLOTS] int64
// array of its own translation unit to the host.
constexpr int STAGE_MAX_B = 4096;
constexpr int STAGE_SLOTS = 16;
enum Stage {
  ST_START = 0,   // kernel entry
  ST_PRE = 1,     // the MPC's inputs staged (prologue / loads done)
  ST_GRAM = 2,    // linearization and Gramian recursion done
  ST_EMIT = 3,    // warp 0's band emission rows done
  ST_FSWEEP = 4,  // warp 0's f sweeps done
  ST_BAND = 5,    // the block barrier after emission and f sweeps
  ST_CHOL = 6,    // factorization (and, INV, the inverse) done
  ST_ADMM = 7,    // the ADMM and its outputs done
  ST_END = 8      // kernel end (outputs, epilogue)
};

}  // namespace mpc

#ifdef MPC_STAGE_CLOCKS
namespace {
__device__ long long g_stage_clock[mpc::STAGE_MAX_B * mpc::STAGE_SLOTS];
}
#define MPC_STAGE(slot)                                                  \
  do {                                                                   \
    if (threadIdx.x == 0 && blockIdx.x < mpc::STAGE_MAX_B)               \
      g_stage_clock[blockIdx.x * mpc::STAGE_SLOTS + (slot)] = clock64(); \
  } while (0)
#define MPC_STAGE_READER(name)                                           \
  extern "C" int name(void* dst) {                                       \
    return (int)cudaMemcpyFromSymbol(dst, g_stage_clock,                 \
                                     sizeof(g_stage_clock));             \
  }
#else
#define MPC_STAGE(slot) ((void)0)
#define MPC_STAGE_READER(name)
#endif

namespace mpc {

// Sizes that follow from NU.
template <int NU>
struct Dim {
  static_assert(NU == 3 || NU == 6, "one or two point feet");
  static constexpr int MU = 2 * NU;             // cone rows per step
  static constexpr int NF = NU / 3;             // feet per step
  static constexpr int NT = NU == 3 ? 64 : 128;  // threads a block
  // the largest horizon: n = NU N <= 32 MAX_RPL = 256 (8 rows a lane)
  static constexpr int MAX_N = 32 * MAX_RPL / NU;
};

// Solve rows per lane at horizon N: the fewest of 2 (NU = 3 only), 4 and 8
// with n = NU N <= 32 RPL.  The number changes no arithmetic.
template <int NU>
__host__ __device__ constexpr int rpl(int N) {
  const int n = NU * N;
  return (NU == 3 && n <= 64) ? 2 : n <= 128 ? 4 : 8;
}

// solve_form = "inv" forms the factor inverse only where n <= 64, as the
// TPU kernel does (mpc_fused_pallas.py:249); beyond, the sweeps.
__host__ __device__ inline bool use_inv(bool inv, int n) {
  return inv && n <= 64;
}

// Host and device share this layout; the Python side mirrors it with a
// ctypes.Structure (all fields 4 bytes, so no padding).  The per-foot
// fields hold two feet; NU = 3 uses the first.
struct MpcParams {
  int N;
  int iters;
  float rho, alpha, ts, mass, height_des;
  float q[NX];       // state weights (steps 1..N-1)
  float p[NX];       // terminal weights (step N)
  float dblk[2][9];  // per foot: 2R + rho Gu'Gu + reg I, row-major [3][3]
  float Gu[18];      // friction-cone block of one foot, row-major [6][3]
  float hu[12];      // cone bounds per step, foot-major
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
  int K, S, Bd, arms, qe, f, T, dg, dginv, z, v, y, x0, aux, total;
};

// W_k and Ad' W_{k+1}, 176 floats apart, in K's storage while the Gramian
// recursion runs
constexpr int GRAM_PAIR = 2 * 176;

// Start of row i of a packed lower triangle.
__host__ __device__ __forceinline__ int tri(int i) {
  return (i * (i + 1)) / 2;
}

// nbd: how many Bd blocks the kernel keeps: N when they differ over the
// horizon, 1 when they are step-invariant (standing); narms: how many arm
// sets (-1: nbd; 0 where Bd is given, fused_qp.cu); inv: room for the
// packed factor inverse T, taken only where the core forms it (use_inv).
//
// No Gramians are kept: the recursion runs on one W and one scratch in
// K's storage and leaves S_k = W_k Bd_k [13][NU] per step, all that the
// band emission reads; once the emission is done S holds z, v and y (and,
// INV, the mat-vecs' scratch row after them: 6 NU N <= 13 NU N floats),
// and once the f sweeps are done qe holds the factor's sqrt(d) and
// 1 / sqrt(d).
template <int NU>
__host__ __device__ inline Smem smem_layout(int N, int nbd, int narms = -1,
                                            bool inv = false) {
  const int n = NU * N, m = Dim<NU>::MU * N;
  Smem s{};
  int o = 0;
  const int ksize = tri(n);
  if (narms < 0) narms = nbd;
  s.K = o;     o += ksize > GRAM_PAIR ? ksize : GRAM_PAIR;
  s.S = o;     o += N * NX * NU;     // S_k = W_k Bd_k, row-major [13][NU]
  s.Bd = o;    o += nbd * NX * NU;   // Bd_k, row-major [13][NU]
  s.arms = o;  o += narms * NU;      // foot position(s) per step
  s.qe = o;    o += N * NX;          // weighted errors of the f sweep
  s.f = o;     o += n;
  s.T = o;     o += use_inv(inv, n) ? ksize : 0;
  s.x0 = o;    o += 16;
  s.aux = o;   o += AUX_SIZE;
  s.total = o;
  s.z = s.S;                         // z [n], v [m], y [m]: 5 NU N <= 13 NU N
  s.v = s.z + n;
  s.y = s.v + m;
  s.dg = s.qe;                       // dg [n], dginv [n]: 2 NU N <= 13 N
  s.dginv = s.qe + n;
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

// ---- how Ad is applied ----------------------------------------------------
// The exact-ZOH SRBD Ad at yaw (cy, sy): closed forms, no matrix.
struct AdSrbd {
  float ts, h2, cy, sy;
  __device__ __forceinline__ float tM(const float* M, int ld, int r,
                                      int c) const {
    return adT_elem(M, ld, r, c, ts, h2, cy, sy);
  }
  __device__ __forceinline__ float Mr(const float* M, int r, int c) const {
    return adR_elem(M, r, c, ts, h2, cy, sy);
  }
  __device__ __forceinline__ float row(const float* x, int r) const {
    return ad_row(x, r, ts, h2, cy, sy);
  }
  __device__ __forceinline__ void tvec(float (&t)[NX]) const {
    adT_vec(t, ts, h2, cy, sy);
  }
};

// Any Ad, row-major [13][13] in shared memory: dense products.
struct AdDense {
  const float* A;
  __device__ __forceinline__ float tM(const float* M, int ld, int r,
                                      int c) const {
    float acc = 0.0f;
    for (int x = 0; x < NX; ++x) acc += A[x * NX + r] * M[x * ld + c];
    return acc;
  }
  __device__ __forceinline__ float Mr(const float* M, int r, int c) const {
    float acc = 0.0f;
    for (int x = 0; x < NX; ++x) acc += M[r * NX + x] * A[x * NX + c];
    return acc;
  }
  __device__ __forceinline__ float row(const float* x, int r) const {
    float acc = 0.0f;
    for (int c = 0; c < NX; ++c) acc += A[r * NX + c] * x[c];
    return acc;
  }
  __device__ __forceinline__ void tvec(float (&t)[NX]) const {
    float o[NX];
#pragma unroll
    for (int y = 0; y < NX; ++y) {
      float acc = 0.0f;
#pragma unroll
      for (int x = 0; x < NX; ++x) acc += A[x * NX + y] * t[x];
      o[y] = acc;
    }
#pragma unroll
    for (int y = 0; y < NX; ++y) t[y] = o[y];
  }
};

// ---- where reference row j (1..N), element e comes from --------------------
// The level-attitude walking reference (models/srbd.py:walking_reference):
// yaw and xy ramps from the anchor at the commanded rates, z pinned.
struct RefLevel {
  const float* aux;   // AUX_VDES / AUX_WDES / AUX_ANC staged by the caller
  const float* x0;
  float height_des, ts;
  __device__ __forceinline__ float operator()(int j, int e) const {
    const float* vdes = aux + AUX_VDES;
    const float wdes = aux[AUX_WDES];
    const float* anc = aux + AUX_ANC;
    const float tj = (float)j * ts;
    switch (e) {
      case 2: return anc[2] + tj * wdes;
      case 3: return anc[0] + tj * vdes[0];
      case 4: return anc[1] + tj * vdes[1];
      case 5: return height_des;
      case 8: return wdes;
      case 9: case 10: case 11: return vdes[e - 9];
      case 12: return x0[12];
      default: return 0.0f;    // roll, pitch, omega_x, omega_y
    }
  }
};

// Rows as given, [N + 1][13] in shared memory.
struct RefGiven {
  const float* xr;
  __device__ __forceinline__ float operator()(int j, int e) const {
    return xr[j * NX + e];
  }
};

// Row r of the cone matrix G = kron(I_N, blockdiag of Gu per foot) on z.
template <int NU>
__device__ __forceinline__ float g_row(const MpcParams& P, const float* z,
                                       int r) {
  constexpr int MU = Dim<NU>::MU;
  const int k = r / MU, i = r - MU * (r / MU);
  const int foot = i / 6, ii = i - 6 * foot;
  const float* g = P.Gu + ii * 3;
  const float* zk = z + NU * k + 3 * foot;
  return g[0] * zk[0] + g[1] * zk[1] + g[2] * zk[2];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// b = -f + rho G'(v - y), rows lane + 32 s in b[s]; warp 0 only.
template <int NU, int RPL>
__device__ __forceinline__ void admm_rhs(const MpcParams& P, const float* f,
                                         const float* v, const float* y,
                                         int n, int lane, float (&b)[RPL]) {
  constexpr int MU = Dim<NU>::MU;
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int c = lane + 32 * s;
    float val = 0.0f;
    if (c < n) {
      const int k = c / NU, bb = c - NU * (c / NU);
      const int foot = bb / 3, b3 = bb - 3 * foot;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int r = MU * k + 6 * foot + i;
        acc += P.Gu[i * 3 + b3] * (v[r] - y[r]);
      }
      val = -f[c] + P.rho * acc;
    }
    b[s] = val;
  }
}

// z = K^-1 (-f + rho G'(v - y)) into sm z; warp 0 only.  The two sweeps of
// chol_common.cuh on the packed factor K, the reciprocal pivots dv of this
// lane's rows in registers; INV: K^-1 b as T'(T b) with the packed factor
// inverse T instead, z and tmp [n] as scratch.
template <int NU, int RPL, bool INV>
__device__ __forceinline__ void admm_z_update(const MpcParams& P,
                                              const float* K,
                                              const float (&dv)[RPL],
                                              const float* T, float* tmp,
                                              const float* f,
                                              const float* v,
                                              const float* y, float* z,
                                              int n, int lane) {
  float b[RPL];
  admm_rhs<NU, RPL>(P, f, v, y, n, lane, b);
  if constexpr (INV) {
    // y = T b: lane i takes row i of T against b staged in z
#pragma unroll
    for (int s = 0; s < RPL; ++s)
      if (lane + 32 * s < n) z[lane + 32 * s] = b[s];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int i = lane + 32 * s;
      float acc = 0.0f;
      if (i < n) {
        const float* Ti = T + tri(i);
        for (int j = 0; j <= i; ++j) acc += Ti[j] * z[j];
      }
      b[s] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < RPL; ++s)
      if (lane + 32 * s < n) tmp[lane + 32 * s] = b[s];
    __syncwarp();
    // x = T' y: lane j takes column j of T
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int j = lane + 32 * s;
      float acc = 0.0f;
      if (j < n)
        for (int i = j; i < n; ++i) acc += T[tri(i) + j] * tmp[i];
      b[s] = acc;
    }
    __syncwarp();
  } else {
    sweep_forward<PACKED, RPL>(K, dv, n, 0, lane, b);
    sweep_backward<PACKED, RPL>(K, dv, n, 0, lane, b);
  }
#pragma unroll
  for (int s = 0; s < RPL; ++s)
    if (lane + 32 * s < n) z[lane + 32 * s] = b[s];
}

// Condense, factor and solve for the scenario of this block.
//
// In shared memory before the call (and followed by a __syncthreads, or
// written by this block's threads before the call's first barrier): x0
// [13] at L.x0 and Bd at L.Bd, block k at k * bd_stride (0: one block for
// every step); what `ad` and `ref` read.  zw / yw point at this scenario's
// warm state in global memory.  On return (after a block barrier): z [n]
// at L.z, y [m] at L.y, the residual at aux[AUX_RES], xi_pred at
// aux[AUX_XP].
//
// RPL: solve rows per lane (n <= 32 RPL; rpl<NU>(N)).  INV: the factor
// inverse (only where use_inv(true, n): the launchers pick the INV
// instantiation there alone, with L laid out for it).
template <int NU, bool INV, int RPL, class AdP, class RefP>
__device__ inline void mpc_condense_solve(const MpcParams& P, float* sm,
                                          const Smem& L, const AdP& ad,
                                          const RefP& ref, int bd_stride,
                                          const float* __restrict__ zw,
                                          const float* __restrict__ yw) {
  constexpr int MU = Dim<NU>::MU, NT = Dim<NU>::NT;
  static_assert(!INV || RPL == rpl<NU>(64 / NU),
                "the factor inverse is formed for n <= 64");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = P.N, n = NU * N, m = MU * N;
  float* K = sm + L.K;
  float* S = sm + L.S;
  const float* Bd = sm + L.Bd;
  float* qe = sm + L.qe;
  float* f = sm + L.f;
  float* dginv = sm + L.dginv;
  float* z = sm + L.z;
  float* v = sm + L.v;
  float* y = sm + L.y;
  const float* x0 = sm + L.x0;
  float* aux = sm + L.aux;

  // ---- 2. backward Gramian recursion (K's storage as scratch) ---------
  // one W_k in K's storage, Ad' W_k beside it; each step leaves
  // S_k = W_k Bd_k
  {
    float* W = K;
    float* Z = K + GRAM_PAIR / 2;
    for (int idx = tid; idx < NX * NX; idx += NT) {
      const int r = idx / NX, c = idx - NX * (idx / NX);
      W[idx] = (r == c) ? P.p[r] : 0.0f;
    }
    __syncthreads();
    for (int k = N - 1; k >= 0; --k) {
      const float* Bk = Bd + k * bd_stride;
      float* Sk = S + k * NX * NU;
      const int items = NX * NU + (k > 0 ? NX * NX : 0);
      for (int idx = tid; idx < items; idx += NT) {
        if (idx < NX * NU) {
          const int x = idx / NU, b = idx - NU * (idx / NU);
          float acc = 0.0f;
          for (int yy = 0; yy < NX; ++yy)
            acc += W[x * NX + yy] * Bk[yy * NU + b];
          Sk[idx] = acc;
        } else {
          const int e = idx - NX * NU;
          const int r = e / NX, c = e - NX * (e / NX);
          Z[e] = ad.tM(W, NX, r, c);
        }
      }
      __syncthreads();
      if (k == 0) break;
      for (int idx = tid; idx < NX * NX; idx += NT) {
        const int r = idx / NX, c = idx - NX * (idx / NX);
        W[idx] = ad.Mr(Z, r, c) + ((r == c) ? P.q[r] : 0.0f);
      }
      __syncthreads();
    }
  }
  MPC_STAGE(ST_GRAM);

  // ---- 3. band emission of the lower K, rows tid, tid + NT, ...:
  // K[NU k+b][NU j+a] = 2 Bd_j' (Ad')^{k-j} W_k Bd_k [a][b], t = S_k
  // column b carried from j = k down
  for (int row = tid; row < n; row += NT) {
    const int k = row / NU, b = row - NU * (row / NU);
    const float* Sk = S + k * NX * NU;
    float t[NX];
#pragma unroll
    for (int x = 0; x < NX; ++x) t[x] = Sk[x * NU + b];
    float* Krow = K + tri(row);
    for (int j = k; j >= 0; --j) {
      const float* Bj = Bd + j * bd_stride;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float e = 0.0f;
#pragma unroll
        for (int x = 0; x < NX; ++x) e += t[x] * Bj[x * NU + a];
        float val = 2.0f * e;
        if (j == k && a / 3 == b / 3)
          val += P.dblk[a / 3][(a % 3) * 3 + b % 3];
        // the factor reads the lower triangle only
        if (NU * j + a <= row) Krow[NU * j + a] = val;
      }
      if (j > 0) ad.tvec(t);
    }
  }
  MPC_STAGE(ST_EMIT);

  // ---- 4. linear term f: forward error sweep + adjoint (warp 0) -------
  if (warp == 0) {
    float* xs = aux + AUX_XS;
    if (lane < NX) xs[lane] = x0[lane];
    __syncwarp();
    int cur = 0;
    for (int j = 0; j < N; ++j) {
      if (lane < NX) {
        const float xn = ad.row(xs + NX * cur, lane);
        const float wq = (j == N - 1) ? P.p[lane] : P.q[lane];
        qe[j * NX + lane] = wq * (xn - ref(j + 1, lane));
        xs[NX * (1 - cur) + lane] = xn;
      }
      __syncwarp();
      cur = 1 - cur;
    }
    if (lane < NX) xs[NX * cur + lane] = 0.0f;
    __syncwarp();
    for (int j = N - 1; j >= 0; --j) {
      if (lane < NX) {
        const float sj = qe[j * NX + lane] + ad.tM(xs + NX * cur, 1, lane, 0);
        xs[NX * (1 - cur) + lane] = sj;
      }
      __syncwarp();
      cur = 1 - cur;
      if (lane < NU) {
        const float* Bj = Bd + j * bd_stride;
        float acc = 0.0f;
        for (int x = 0; x < NX; ++x) acc += Bj[x * NU + lane] * xs[NX * cur + x];
        f[NU * j + lane] = 2.0f * acc;
      }
      __syncwarp();
    }
    MPC_STAGE(ST_FSWEEP);
  }
  __syncthreads();
  MPC_STAGE(ST_BAND);

  // ---- 5. in-place Cholesky of the packed lower triangle of K ---------
  factor<PACKED>(K, sm + L.dg, dginv, n, n, 0);

  // ---- 5b. INV: T = L^-1, packed lower: thread j solves L t = e_j down
  // its column, T_ij = -(sum_{l=j}^{i-1} L_il T_lj) / L_ii
  float* T = sm + L.T;
  if constexpr (INV) {
    for (int j = tid; j < n; j += NT) {
      T[tri(j) + j] = dginv[j];
      for (int i = j + 1; i < n; ++i) {
        const float* Li = K + tri(i);
        float acc = 0.0f;
        for (int l = j; l < i; ++l) acc += Li[l] * T[tri(l) + j];
        T[tri(i) + j] = -acc * dginv[i];
      }
    }
    __syncthreads();
  }
  MPC_STAGE(ST_CHOL);

  // ---- 6. warm ADMM in factor form (warp 0) ---------------------------
  if (warp == 0) {
    for (int c = lane; c < n; c += 32) z[c] = zw[c];
    __syncwarp();
    for (int r = lane; r < m; r += 32) {
      v[r] = fminf(g_row<NU>(P, z, r), P.hu[r % MU]);
      y[r] = yw[r];
    }
    __syncwarp();
    const float alpha = P.alpha, beta = 1.0f - P.alpha;
    // the reciprocal pivots of this lane's rows, once per solve; INV: the
    // mat-vecs' scratch row after y
    float dv[RPL];
    load_dinv<RPL>(dginv, n, lane, dv);
    float* tmp = y + m;
    for (int it = 0; it < P.iters; ++it) {
      admm_z_update<NU, RPL, INV>(P, K, dv, T, tmp, f, v, y, z, n, lane);
      __syncwarp();
      for (int r = lane; r < m; r += 32) {
        const float gzr = alpha * g_row<NU>(P, z, r) + beta * v[r];
        const float vn = fminf(gzr + y[r], P.hu[r % MU]);
        y[r] = y[r] + gzr - vn;
        v[r] = vn;
      }
      __syncwarp();
    }
    admm_z_update<NU, RPL, INV>(P, K, dv, T, tmp, f, v, y, z, n, lane);
    __syncwarp();

    float rp = 0.0f, fm = 0.0f;
    for (int r = lane; r < m; r += 32)
      rp = fmaxf(rp, fabsf(g_row<NU>(P, z, r) - v[r]));
    for (int c = lane; c < n; c += 32) fm = fmaxf(fm, fabsf(f[c]));
    rp = warp_max(rp);
    fm = warp_max(fm);
    if (lane == 0) aux[AUX_RES] = rp / (1.0f + fm);
    if (lane < NX) {
      float xp = ad.row(x0, lane);
#pragma unroll
      for (int a = 0; a < NU; ++a) xp = xp + Bd[lane * NU + a] * z[a];
      aux[AUX_XP + lane] = xp;
    }
  }
  __syncthreads();
  MPC_STAGE(ST_ADMM);
}

// The whole prep + solve for the scenario of this block: the SRBD
// linearization at the measured yaw, then mpc_condense_solve against the
// level-attitude reference.
//
// Staged by the caller in shared memory before the call (and followed by
// a __syncthreads): x0 [13] at L.x0; the foot position(s) each step pushes
// from at L.arms, [nbd][NF][3] (nbd = N, or 1 when the arms do not change
// over the horizon); v_des / yaw rate / anchor in the aux area.  Results as
// mpc_condense_solve.
template <int NU, bool INV, int RPL>
__device__ inline void mpc_prep_solve(const MpcParams& P, float* sm,
                                      const Smem& L, int nbd,
                                      const float* __restrict__ zw,
                                      const float* __restrict__ yw) {
  constexpr int NF = Dim<NU>::NF, NT = Dim<NU>::NT;
  const int tid = threadIdx.x;
  float* Bd = sm + L.Bd;
  const float* arms = sm + L.arms;
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

  // ---- 1b. Bd_k from the moment arm r = arm_k - pos (exact ZOH), one
  // column triple per foot; the feet share the scaled-identity rows ------
  for (int kf = tid; kf < nbd * NF; kf += NT) {
    const int k = kf / NF, c0 = 3 * (kf - NF * (kf / NF));
    const float rx = arms[3 * kf] - x0[3];
    const float ry = arms[3 * kf + 1] - x0[4];
    const float rz = arms[3 * kf + 2] - x0[5];
    const float* iw = aux + AUX_IW;
    float T[3][3];  // I_w^-1 [r]x
    for (int i = 0; i < 3; ++i) {
      const float a = iw[3 * i], b = iw[3 * i + 1], c = iw[3 * i + 2];
      T[i][0] = b * rz - c * ry;
      T[i][1] = -a * rz + c * rx;
      T[i][2] = a * ry - b * rx;
    }
    float* Bk = Bd + k * NX * NU + c0;
    const float sp = h2 / P.mass, sv = ts / P.mass;
    for (int a = 0; a < 3; ++a) {
      Bk[0 * NU + a] = h2 * (cy * T[0][a] + sy * T[1][a]);   // ts^2/2 Rz'T
      Bk[1 * NU + a] = h2 * (-sy * T[0][a] + cy * T[1][a]);
      Bk[2 * NU + a] = h2 * T[2][a];
      for (int r = 0; r < 3; ++r) {
        Bk[(3 + r) * NU + a] = (r == a) ? sp : 0.0f;         // ts^2/(2m) I
        Bk[(6 + r) * NU + a] = ts * T[r][a];                 // ts T
        Bk[(9 + r) * NU + a] = (r == a) ? sv : 0.0f;         // ts/m I
      }
      Bk[12 * NU + a] = 0.0f;
    }
  }

  const AdSrbd ad{ts, h2, cy, sy};
  const RefLevel ref{aux, x0, P.height_des, ts};
  mpc_condense_solve<NU, INV, RPL>(P, sm, L, ad, ref, nbd > 1 ? NX * NU : 0,
                                   zw, yw);
}

// Blocks of `kernel` an SM holds at `threads` threads and `bytes` of
// dynamic shared memory (the attribute raised to `bytes` first, as a launch
// does); -1 when CUDA refuses either call.
template <class Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, int bytes) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    bytes) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace mpc
