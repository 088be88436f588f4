// Device functions shared by the whole-tick kernels (walking_tick.cu,
// standing_tick.cu): the kernel constants and pointer block, leg
// kinematics, the 12-state Kalman filter (on a half warp in registers
// for the held-force forms, on a warp in shared memory for the solving
// forms), the tick's prologue (gait clock, FK, anchor, placement, swing
// IK) and epilogue (exact-ZOH SRBD plant step, next-tick kinematics), and
// the held-force forms' tick spread over a half warp.
// Counterparts of the sections of
// mpc_limx_control_tpu/ops/tick_fused_pallas.py:_tick_kernel (:130) named
// at each function.
//
// The held-force forms are one dependent chain per scenario (latency
// and issue slots, not flops or bytes: ~1k flops and ~0.3 KB a scenario
// with the truth, ~7k and ~1.8 KB with the filter).  On one thread that
// chain -- ~30 sines and cosines and two IKs one after another -- takes
// ~40k cycles on the H100 (PERF.md section 6), so the design shortens it
// (kf_tick, hold_tick: the angles' sines and cosines on nine lanes, the
// two IKs on two) and runs two scenarios a warp (hold_kernel_body).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mpc_core.cuh"
namespace mpc {

// Mirrored on the Python side by a ctypes.Structure (4-byte fields only).
struct TickParams {
  MpcParams mpc;
  float dt, cycle, swing_t, stance_t, gait_height, p_rel_max, ground_h;
  float k_cap;
  int use_capture;
  float anchor_band, anchor_gain, yaw_band;
  float off_l[2], off_r[2];
  float geom[12];   // abad, hip, knee, foot+contact (left-side signs)
  // filter constants: process noise (dt/20) ipp, (9.81 dt/20) ipv, dt fpp;
  // sensor noise fsp, fsv, fhn; high_suspect_number; foot radius
  float kf[8];
};

// Device pointers of one launch (a variant leaves the ones it does not
// use null).
struct TickIO {
  const float *xi, *q, *fl, *fr, *zw, *yw, *anc, *it, *vdes, *wdes, *grf;
  const float *kx, *kp, *pv, *pq;
  float *xi_o, *q_o, *fl_o, *fr_o, *z_o, *y_o, *anc_o, *res_o, *grf_o;
  float *tgt_o, *kx_o, *kp_o;
};

}  // namespace mpc

namespace {

using mpc::TickIO;
using mpc::TickParams;

struct Leg {
  float ax, ay, az, hx, hy, hz, kx, ky, kz, fx, fy, fz;
};

__device__ __forceinline__ Leg load_leg(const TickParams& T) {
  const float* g = T.geom;
  return Leg{g[0], g[1], g[2], g[3], g[4], g[5],
             g[6], g[7], g[8], g[9], g[10], g[11]};
}

__device__ __forceinline__ float wrapf(float a) {
  return atan2f(sinf(a), cosf(a));
}

// R = Rz(yaw) Ry(pitch) Rx(roll), row-major, from the angles' cosines and
// sines
__device__ __forceinline__ void rot_cs(float cr, float sr, float cp,
                                       float sp, float cy, float sy,
                                       float R[3][3]) {
  R[0][0] = cy * cp; R[0][1] = cy * sp * sr - sy * cr;
  R[0][2] = cy * sp * cr + sy * sr;
  R[1][0] = sy * cp; R[1][1] = sy * sp * sr + cy * cr;
  R[1][2] = sy * sp * cr - cy * sr;
  R[2][0] = -sp; R[2][1] = cp * sr; R[2][2] = cp * cr;
}

// R = Rz(yaw) Ry(pitch) Rx(roll), row-major
__device__ void rot_rpy(const float* rpy, float R[3][3]) {
  rot_cs(cosf(rpy[0]), sinf(rpy[0]), cosf(rpy[1]), sinf(rpy[1]),
         cosf(rpy[2]), sinf(rpy[2]), R);
}

__device__ __forceinline__ void mv(const float R[3][3], const float* v,
                                   float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2];
}

__device__ __forceinline__ void mtv(const float R[3][3], const float* v,
                                    float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2];
}

// cosines and sines of a leg's q0, q1 and q1 + q2
struct LegTrig {
  float c0, s0, c1, s1, c12, s12;
};

__device__ __forceinline__ LegTrig leg_trig(const float* q) {
  const float q12 = q[1] + q[2];
  return LegTrig{cosf(q[0]), sinf(q[0]), cosf(q[1]), sinf(q[1]), cosf(q12),
                 sinf(q12)};
}

// contact point in the base frame; mir = +1 left / -1 right
__device__ __forceinline__ void fk_leg_t(const Leg& g, const LegTrig& t,
                                         float mir, float* p) {
  const float c0 = t.c0, s0 = t.s0, c1 = t.c1, s1 = t.s1;
  const float c12 = t.c12, s12 = t.s12;
  const float ux = g.hx + c1 * g.kx + s1 * g.kz + c12 * g.fx + s12 * g.fz;
  const float uy = (g.hy + g.ky + g.fy) * mir;
  const float uz = g.hz - s1 * g.kx + c1 * g.kz - s12 * g.fx + c12 * g.fz;
  p[0] = g.ax + ux;
  p[1] = g.ay * mir + c0 * uy - s0 * uz;
  p[2] = g.az + s0 * uy + c0 * uz;
}

__device__ void fk_leg(const Leg& g, const float* q, float mir, float* p) {
  fk_leg_t(g, leg_trig(q), mir, p);
}

// closed-form position IK, branch nearest q_ref (ties to the first)
__device__ void ik_leg(const Leg& g, const float* tgt, const float* q_ref,
                       float mir, float* q) {
  const float vx = tgt[0] - g.ax;
  const float vy = tgt[1] - g.ay * mir;
  const float vz = tgt[2] - g.az;
  const float y_chain = (g.hy + g.ky + g.fy) * mir;
  const float r = sqrtf(vy * vy + vz * vz);
  const float phi = atan2f(vz, vy);
  const float c = fminf(fmaxf(y_chain / fmaxf(r, 1e-9f), -1.0f), 1.0f);
  const float d0 = acosf(c);
  const float c0a = wrapf(phi - d0), c0b = wrapf(phi + d0);
  const float q0 = (fabsf(wrapf(c0a - q_ref[0])) <= fabsf(wrapf(c0b - q_ref[0])))
                       ? c0a : c0b;
  const float cq0 = cosf(q0), sq0 = sinf(q0);
  const float ux = vx - g.hx;
  const float uz = -sq0 * vy + cq0 * vz - g.hz;
  const float la2 = g.kx * g.kx + g.kz * g.kz;
  const float lb2 = g.fx * g.fx + g.fz * g.fz;
  const float rho = sqrtf(la2 * lb2);
  const float psi = atan2f(g.kx * g.fz - g.kz * g.fx,
                           g.kx * g.fx + g.kz * g.fz);
  const float k2 = (ux * ux + uz * uz - la2 - lb2) / 2.0f;
  const float c2 = fminf(fmaxf(k2 / rho, -1.0f), 1.0f);
  const float d2 = acosf(c2);
  const float c2a = wrapf(psi - d2), c2b = wrapf(psi + d2);
  const float q2 = (fabsf(wrapf(c2a - q_ref[2])) <= fabsf(wrapf(c2b - q_ref[2])))
                       ? c2a : c2b;
  const float wx = g.kx + cosf(q2) * g.fx + sinf(q2) * g.fz;
  const float wz = g.kz - sinf(q2) * g.fx + cosf(q2) * g.fz;
  q[0] = q0;
  q[1] = wrapf(atan2f(wz, wx) - atan2f(uz, ux));
  q[2] = q2;
}

// torch.remainder / jnp.mod for a positive period
__device__ __forceinline__ float pos_mod(float t, float period) {
  float r = fmodf(t, period);
  if (r != 0.0f && r < 0.0f) r += period;
  return r;
}


// contact-point velocity J(q) dq in the base frame (closed form of the
// Rx(q0) Ry(q1) Ry(q2) chain's Jacobian), from the leg's trig
__device__ __forceinline__ void jac_vel_t(const Leg& g, const LegTrig& t,
                                          const float* dq, float mir,
                                          float* v) {
  const float c0 = t.c0, s0 = t.s0, c1 = t.c1, s1 = t.s1;
  const float c12 = t.c12, s12 = t.s12;
  const float a1 = c1 * g.kx + s1 * g.kz, b1 = -s1 * g.kx + c1 * g.kz;
  const float a2 = c12 * g.fx + s12 * g.fz, b2 = -s12 * g.fx + c12 * g.fz;
  const float uy = (g.hy + g.ky + g.fy) * mir;
  const float uz = g.hz + b1 + b2;
  const float vz_pl = -(dq[1] * (a1 + a2) + dq[2] * a2);
  v[0] = dq[1] * (b1 + b2) + dq[2] * b2;
  v[1] = dq[0] * (-s0 * uy - c0 * uz) - s0 * vz_pl;
  v[2] = dq[0] * (c0 * uy - s0 * uz) + c0 * vz_pl;
}

__device__ void jac_vel(const Leg& g, const float* q, const float* dq,
                        float mir, float* v) {
  jac_vel_t(g, leg_trig(q), dq, mir, v);
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// left swing now, from the gait clock
__device__ __forceinline__ bool left_swing(const TickParams& T, float it) {
  return pos_mod(__fmul_rn(it, T.dt), T.cycle) < T.swing_t;
}

// The nine angles of a tick: xi's roll, pitch and yaw, then each leg's
// q0, q1 and q1 + q2 (left 3-5, right 6-8).
__device__ __forceinline__ float tick_angle(const float* xi, const float* q6,
                                            int k) {
  if (k < 3) return xi[k];
  const float* ql = q6 + 3 * ((k - 3) / 3);
  const int m = (k - 3) % 3;
  return m == 0 ? ql[0] : m == 1 ? ql[1] : ql[1] + ql[2];
}

// Their cosines and sines on a half warp: angle k on lane k (lanes 0-8 at
// once), the cosines to trig[0..8], the sines to trig[9..17] in shared
// memory (the caller synchronizes the warp before reading them).
__device__ __forceinline__ void tick_trig_warp(int lane, const float* xi,
                                               const float* q6,
                                               float* trig) {
  if (lane < 9) {
    const float a = tick_angle(xi, q6, lane);
    trig[lane] = cosf(a);
    trig[9 + lane] = sinf(a);
  }
}

// Where the prologue gets the attitude's rotation R and a leg's trig
// (side 0 left, 1 right): computed where it is used, on one thread ...
struct TrigHere {
  const float* xi;
  const float* q6;
  __device__ __forceinline__ void rot(float R[3][3]) const {
    rot_rpy(xi, R);
  }
  __device__ __forceinline__ LegTrig leg(int side) const {
    return leg_trig(q6 + 3 * side);
  }
};

// ... or read from tick_trig_warp's array.
struct TrigShared {
  const float* t;
  __device__ __forceinline__ void rot(float R[3][3]) const {
    rot_cs(t[0], t[9], t[1], t[10], t[2], t[11], R);
  }
  __device__ __forceinline__ LegTrig leg(int side) const {
    const float* c = t + 3 + 3 * side;
    return LegTrig{c[0], c[9], c[1], c[10], c[2], c[11]};
  }
};

// ---- the Kalman filter ------------------------------------------------
// The register filter and the held-force tick (truth and KF forms) run
// one scenario on each half of a warp, KF_LANES lanes (rows of S, right-hand
// sides and angles all fit in 16), the two halves in step: half_bcast
// gives a value of lane `src` of this half to every lane of it.
constexpr int KF_LANES = 16;

template <class V>
__device__ __forceinline__ V half_bcast(V v, int src) {
  return __shfl_sync(FULL, v, src, KF_LANES);
}

// Filter scratch of one scenario (floats): kp staged (then the posterior
// covariance before symmetrization), the predicted covariance, C P, the
// factor's rows (then the 13 solved right-hand sides [ey | C P]), the
// observation, the predicted state, the posterior state.
constexpr int KW_KP = 0;      // [12][12]
constexpr int KW_PP = 144;    // [12][12]
constexpr int KW_CP = 288;    // [14][12]
constexpr int KW_LX = 456;    // [14][14] L, then [14][13] X
constexpr int KW_Y = 652;     // [14]
constexpr int KW_XP = 666;    // [12]
constexpr int KW_XN = 678;    // [12]
constexpr int KW_DG = 690;    // [14] 1 / diag(L)
constexpr int KW_TRIG = 704;  // [18] cosines, then sines (tick_trig_warp)
constexpr int KW_SIZE = 722;

// Stage slots of the filter and the held-force tick (thread 0's clock64()
// stamps of a MPC_STAGE_CLOCKS build; the MPC core's are 0-8).
enum KfStage {
  KS_SENSE = 9,    // inputs loaded, sensors synthesized, kp staged
  KS_PRED = 10,    // P_pred, C P and the rows of S
  KS_FACTOR = 11,  // S = L L' in registers
  KS_SOLVE = 12,   // the 13 right-hand sides solved
  KS_POST = 13,    // posterior and symmetrization written
  KS_HOLD_PRE = 14 // the held-force tick's prologue (gait .. swing IK)
};

// (C v)[r] for the observation matrix C [14][12] of the filter, v with
// element stride s: rows 0-5 base minus foot position, 6-11 base
// velocity (once per foot), 12-13 the foot heights.
__device__ __forceinline__ float c_row(const float* v, int s, int r) {
  if (r < 3) return v[r * s] - v[(r + 6) * s];
  if (r < 6) return v[(r - 3) * s] - v[(r + 6) * s];
  if (r < 9) return v[(r - 3) * s];
  if (r < 12) return v[(r - 6) * s];
  return v[(r == 12 ? 8 : 11) * s];
}

// One predict + update of the 12-state filter (ops/kf.py math, in the
// order of the TPU kernel's est_kf section): kx [12] / kp [12][12] in,
// the posterior to kx_out / kp_out and to w[KW_XN].  `ls`: the left foot
// swings (else the right); `both`: both feet are in contact (standing).
// Run by the KF_LANES lanes of a half warp (lane = 0..15), the other half
// running another scenario in step, w [KW_SIZE] in shared memory; the
// cosines and sines of the tick's nine angles (tick_trig_warp) are left in
// w[KW_TRIG].
//
// The filter is one dependent chain, and at large B the lanes' issue
// slots are what the SM runs short of, so the design shortens the chain
// and fills the lanes: two scenarios a warp; kp read coalesced into
// registers first, its latency under the sensor synthesis, whose nine
// sines and cosines run on nine lanes at once; S and its factor stay in
// registers, a row a lane, each column's pivot and L[k][j] broadcast by
// shuffles (no barrier a column); the 13 right-hand sides are a column a
// lane, in registers, L read from shared memory by broadcast.  Every
// element keeps the arithmetic of the column-by-column Cholesky and
// substitutions of kf_tick_smem (the same fused multiply-adds in the same
// order): on the H100 the walking KF hold form's outputs are the
// shared-memory filter's bit for bit; standing, the covariance is, and
// the posterior state differs in its last bit or two (PERF.md).
__device__ __forceinline__ void kf_tick(
    const TickParams& T, const Leg& g, int lane, bool ls, bool both,
    const float* xi, const float* q6, const float* pv, const float* pq,
    const float* kx, const float* kp, float* w, float* kx_out,
    float* kp_out) {
  constexpr int NL = KF_LANES;
  const float dt = T.dt;
  const float big = T.kf[6];
  // a foot in swing gets its noise scaled up; standing, both are down
  const float gl = (ls && !both) ? big : 1.0f;
  const float gr = (ls || both) ? 1.0f : big;
  float* KP = w + KW_KP;
  float* Pp = w + KW_PP;
  float* CP = w + KW_CP;
  float* LX = w + KW_LX;

  // ---- loads: kp coalesced into registers, issued before any use -------
  constexpr int NKP = (144 + NL - 1) / NL;
  float kpr[NKP];
#pragma unroll
  for (int k = 0; k < NKP; ++k) {
    const int e = lane + NL * k;
    kpr[k] = e < 144 ? kp[e] : 0.0f;
  }

  // ---- sensors from the truth: the nine angles' cosines and sines on
  // nine lanes, the rest on lane 0; the IMU orientation is xi's ----------
  tick_trig_warp(lane, xi, q6, w + KW_TRIG);
  __syncwarp();
  if (lane == 0) {
    const TrigShared trig{w + KW_TRIG};
    float R[3][3];
    trig.rot(R);
    const LegTrig tl = trig.leg(0), tr = trig.leg(1);
    float dq[6], pb[3], vb[3], tmp[3], pl[3], pr[3], vl[3], vr[3];
    for (int i = 0; i < 6; ++i) dq[i] = (q6[i] - pq[i]) / dt;
    const float* om = xi + 6;
    fk_leg_t(g, tl, 1.0f, pb);
    mv(R, pb, pl);
    fk_leg_t(g, tr, -1.0f, pb);
    mv(R, pb, pr);
    jac_vel_t(g, tl, dq, 1.0f, vb);
    mv(R, vb, vl);
    cross(om, pl, tmp);
    for (int i = 0; i < 3; ++i) vl[i] += tmp[i];
    jac_vel_t(g, tr, dq + 3, -1.0f, vb);
    mv(R, vb, vr);
    cross(om, pr, tmp);
    for (int i = 0; i < 3; ++i) vr[i] += tmp[i];
    const float rad = T.kf[7];
    float* y = w + KW_Y;
    y[0] = -pl[0]; y[1] = -pl[1]; y[2] = rad - pl[2];
    y[3] = -pr[0]; y[4] = -pr[1]; y[5] = rad - pr[2];
    for (int i = 0; i < 3; ++i) {
      y[6 + i] = -vl[i];
      y[9 + i] = -vr[i];
    }
    y[12] = 0.0f;
    y[13] = 0.0f;
  }
  if (lane < 12) {
    // predict the state with the world acceleration
    const int i3 = lane < 6 ? lane % 3 : 0;
    const float aw = (xi[9 + i3] - pv[i3]) / dt;
    float xp;
    if (lane < 3)
      xp = kx[lane] + dt * kx[3 + lane] + (0.5f * dt * dt) * aw;
    else if (lane < 6)
      xp = kx[lane] + dt * aw;
    else
      xp = kx[lane];
    w[KW_XP + lane] = xp;
  }
#pragma unroll
  for (int k = 0; k < NKP; ++k) {
    const int e = lane + NL * k;
    if (e < 144) KP[e] = kpr[k];
  }
  __syncwarp();
  MPC_STAGE(KS_SENSE);

  // ---- P_pred = A P A' + diag(q), A = I + dt (position <- velocity) ----
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    const float a_ij = KP[i * 12 + j] + (i < 3 ? dt * KP[(i + 3) * 12 + j]
                                               : 0.0f);
    float v = a_ij;
    if (j < 3) {
      const int j3 = j + 3;
      v += dt * (KP[i * 12 + j3] + (i < 3 ? dt * KP[(i + 3) * 12 + j3]
                                          : 0.0f));
    }
    if (i == j)
      v += i < 3 ? T.kf[0] : i < 6 ? T.kf[1] : T.kf[2] * (i < 9 ? gl : gr);
    Pp[e] = v;
  }
  __syncwarp();
  for (int e = lane; e < 168; e += NL)           // C P_pred
    CP[e] = c_row(Pp + e % 12, 12, e / 12);
  __syncwarp();
  // S = C P C' + R: row r of its lower triangle on lane r (lanes past 13
  // repeat row 13), with the contact-gated measurement noise
  const int r = lane < 14 ? lane : 13;
  const float rd = r < 6 ? T.kf[3] * ((r < 3) ? gl : gr)
                 : r < 12 ? T.kf[4] * ((r < 9) ? gl : gr)
                          : T.kf[5] * ((r == 12) ? gl : gr);
  float a[14];
#pragma unroll
  for (int c = 0; c < 14; ++c)
    a[c] = c_row(CP + r * 12, 1, c) + (r == c ? rd : 0.0f);
  MPC_STAGE(KS_PRED);

  // ---- Cholesky of S in registers (lower), pivots clamped at 1e-30:
  // column j's pivot from lane j, the scaled column's L[k][j] from lane k;
  // the rest of a row (upper part, lanes past 13) is never read ---------
  float* dg = w + KW_DG;
#pragma unroll
  for (int j = 0; j < 14; ++j) {
    const float d = half_bcast(a[j], j);
    const float inv = 1.0f / sqrtf(fmaxf(d, 1e-30f));
    if (lane == 0) dg[j] = inv;
    a[j] *= inv;
#pragma unroll
    for (int k = j + 1; k < 14; ++k) {
      const float lkj = half_bcast(a[j], k);
      a[k] -= a[j] * lkj;
    }
  }
  if (lane < 14) {
#pragma unroll
    for (int c = 0; c < 14; ++c) LX[lane * 14 + c] = a[c];
  }
  __syncwarp();
  MPC_STAGE(KS_FACTOR);

  // ---- S^-1 [ey | C P]: right-hand side c on lane c (lanes past 12
  // repeat column 12), forward then back, in registers -------------------
  const int c = lane < 13 ? lane : 12;
  float x[14];
#pragma unroll
  for (int i = 0; i < 14; ++i)
    x[i] = c == 0 ? w[KW_Y + i] - c_row(w + KW_XP, 1, i)   // innovation
                  : CP[i * 12 + c - 1];
#pragma unroll
  for (int j = 0; j < 14; ++j) {
    const float xj = x[j] * dg[j];
    x[j] = xj;
#pragma unroll
    for (int i = j + 1; i < 14; ++i) x[i] -= LX[i * 14 + j] * xj;
  }
#pragma unroll
  for (int j = 13; j >= 0; --j) {
    float acc = x[j];
#pragma unroll
    for (int i = j + 1; i < 14; ++i) acc -= LX[i * 14 + j] * x[i];
    x[j] = acc * dg[j];
  }
  __syncwarp();   // every lane has read L: X takes its place
  float* X = LX;
  if (lane < 13) {
#pragma unroll
    for (int i = 0; i < 14; ++i) X[i * 13 + lane] = x[i];
  }
  __syncwarp();
  MPC_STAGE(KS_SOLVE);

  // posterior: x = x_pred + (P C') S^-1 ey, P = P_pred - (P C') S^-1 C P
  for (int i = lane; i < 12; i += NL) {
    float acc = w[KW_XP + i];
    for (int k = 0; k < 14; ++k) acc += CP[k * 12 + i] * X[k * 13];
    w[KW_XN + i] = acc;
    kx_out[i] = acc;
  }
  float* Pn = KP;   // kp is no longer needed
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    float acc = 0.0f;
    for (int k = 0; k < 14; ++k) acc += CP[k * 12 + i] * X[k * 13 + 1 + j];
    Pn[e] = Pp[e] - acc;
  }
  __syncwarp();
  // symmetrize, then the xy conditioning (include/stateEstimator.h:
  // 299-306): cut the xy <-> rest covariances, shrink the xy block x0.1
  const float p01 = 0.5f * (Pn[1] + Pn[12]);
  const bool cond = Pn[0] * Pn[13] - p01 * p01 > 1e-6f;
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    float v = 0.5f * (Pn[e] + Pn[j * 12 + i]);
    if (cond) v *= ((i < 2) == (j < 2)) ? ((i < 2) ? 0.1f : 1.0f) : 0.0f;
    kp_out[e] = v;
  }
  __syncwarp();
  MPC_STAGE(KS_POST);
}

// ---- the filter of the solving forms ------------------------------------
// The shared-memory form of the filter, which the solving tick kernels
// keep: there it runs on warp 0 of a block that holds the MPC core, whose
// register and shared-memory budget sets the blocks an SM; kf_tick's
// register-resident rows and columns take the KF solving kernels from 80
// to 128-167 registers walking and 72 to 128 standing (12 -> 8 and 6 -> 4
// blocks an SM, 12-13 % and 20-22 % slower at B = 4096 on the H100,
// PERF.md section 6).  Scratch (floats): predicted covariance, C P, the
// innovation covariance S (its lower Cholesky factor in place, then the
// posterior covariance before symmetrization), the 13 right-hand sides
// [ey | C P], predicted state, observation, R diagonal, 1 / diag(L),
// posterior state.
constexpr int KWS_PP = 0;      // [12][12]
constexpr int KWS_CP = 144;    // [14][12]
constexpr int KWS_S = 312;     // [14][14]
constexpr int KWS_X = 508;     // [14][13]
constexpr int KWS_XP = 690;    // [12]
constexpr int KWS_Y = 702;     // [14]
constexpr int KWS_RD = 716;    // [14]
constexpr int KWS_DG = 730;    // [14]
constexpr int KWS_XN = 744;    // [12]
constexpr int KWS_SIZE = 756;

// One predict + update of the 12-state filter as kf_tick, on the 32 lanes
// of a warp, its scratch in shared memory: the sensors on lane 0, the
// covariance entries shared out over the lanes, a barrier a factor
// column, the 13 right-hand sides one a lane; the posterior to
// w[KWS_XN].
__device__ __forceinline__ void kf_tick_smem(
    const TickParams& T, const Leg& g, int lane, bool ls, bool both,
    const float* xi, const float* q6, const float* pv, const float* pq,
    const float* kx, const float* kp, float* w, float* kx_out,
    float* kp_out) {
  constexpr int NL = 32;
  const float dt = T.dt;
  const float big = T.kf[6];
  // a foot in swing gets its noise scaled up; standing, both are down
  const float gl = (ls && !both) ? big : 1.0f;
  const float gr = (ls || both) ? 1.0f : big;
  float* Pp = w + KWS_PP;
  float* CP = w + KWS_CP;
  float* S = w + KWS_S;
  float* X = w + KWS_X;

  if (lane == 0) {
    // sensors synthesized from the truth; the IMU orientation is xi's
    float R[3][3];
    rot_rpy(xi, R);
    float dq[6], aw[3], pb[3], vb[3], tmp[3], pl[3], pr[3], vl[3], vr[3];
    for (int i = 0; i < 6; ++i) dq[i] = (q6[i] - pq[i]) / dt;
    for (int i = 0; i < 3; ++i) aw[i] = (xi[9 + i] - pv[i]) / dt;
    const float* om = xi + 6;
    fk_leg(g, q6, 1.0f, pb);
    mv(R, pb, pl);
    fk_leg(g, q6 + 3, -1.0f, pb);
    mv(R, pb, pr);
    jac_vel(g, q6, dq, 1.0f, vb);
    mv(R, vb, vl);
    cross(om, pl, tmp);
    for (int i = 0; i < 3; ++i) vl[i] += tmp[i];
    jac_vel(g, q6 + 3, dq + 3, -1.0f, vb);
    mv(R, vb, vr);
    cross(om, pr, tmp);
    for (int i = 0; i < 3; ++i) vr[i] += tmp[i];
    const float rad = T.kf[7];
    float* y = w + KWS_Y;
    y[0] = -pl[0]; y[1] = -pl[1]; y[2] = rad - pl[2];
    y[3] = -pr[0]; y[4] = -pr[1]; y[5] = rad - pr[2];
    for (int i = 0; i < 3; ++i) {
      y[6 + i] = -vl[i];
      y[9 + i] = -vr[i];
    }
    y[12] = 0.0f;
    y[13] = 0.0f;
    // predict the state with the world acceleration
    float* xp = w + KWS_XP;
    for (int i = 0; i < 3; ++i) {
      xp[i] = kx[i] + dt * kx[3 + i] + (0.5f * dt * dt) * aw[i];
      xp[3 + i] = kx[3 + i] + dt * aw[i];
    }
    for (int i = 6; i < 12; ++i) xp[i] = kx[i];
    // contact-gated measurement noise
    float* rd = w + KWS_RD;
    for (int i = 0; i < 3; ++i) {
      rd[i] = T.kf[3] * gl;
      rd[3 + i] = T.kf[3] * gr;
      rd[6 + i] = T.kf[4] * gl;
      rd[9 + i] = T.kf[4] * gr;
    }
    rd[12] = T.kf[5] * gl;
    rd[13] = T.kf[5] * gr;
  }
  MPC_STAGE(KS_SENSE);
  // P_pred = A P A' + diag(q), A = I + dt (position <- velocity)
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    const float a_ij = kp[i * 12 + j] + (i < 3 ? dt * kp[(i + 3) * 12 + j]
                                               : 0.0f);
    float v = a_ij;
    if (j < 3) {
      const int j3 = j + 3;
      v += dt * (kp[i * 12 + j3] + (i < 3 ? dt * kp[(i + 3) * 12 + j3]
                                          : 0.0f));
    }
    if (i == j)
      v += i < 3 ? T.kf[0] : i < 6 ? T.kf[1] : T.kf[2] * (i < 9 ? gl : gr);
    Pp[e] = v;
  }
  __syncwarp();
  for (int e = lane; e < 168; e += NL)           // C P_pred
    CP[e] = c_row(Pp + e % 12, 12, e / 12);
  __syncwarp();
  for (int e = lane; e < 196; e += NL) {         // S = C P C' + R (lower)
    const int r = e / 14, c = e % 14;
    if (c <= r) S[e] = c_row(CP + r * 12, 1, c) + (r == c ? w[KWS_RD + r]
                                                          : 0.0f);
  }
  for (int e = lane; e < 168; e += NL)           // rhs columns 1..12
    X[(e / 12) * 13 + 1 + e % 12] = CP[e];
  for (int r = lane; r < 14; r += NL)            // rhs column 0: innovation
    X[r * 13] = w[KWS_Y + r] - c_row(w + KWS_XP, 1, r);
  __syncwarp();
  MPC_STAGE(KS_PRED);

  // Cholesky of S in place (lower), pivots clamped at 1e-30
  for (int j = 0; j < 14; ++j) {
    const float inv = 1.0f / sqrtf(fmaxf(S[j * 14 + j], 1e-30f));
    if (lane == 0) w[KWS_DG + j] = inv;
    for (int i = j + 1 + lane; i < 14; i += NL) S[i * 14 + j] *= inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < 14; i += NL) {
      const float lij = S[i * 14 + j];
      for (int k = j + 1; k <= i; ++k) S[i * 14 + k] -= lij * S[k * 14 + j];
    }
    __syncwarp();
  }
  MPC_STAGE(KS_FACTOR);
  // S^-1 [ey | C P]: one right-hand side per lane, forward then back
  for (int c = lane; c < 13; c += NL) {
    for (int j = 0; j < 14; ++j) {
      const float xj = X[j * 13 + c] * w[KWS_DG + j];
      X[j * 13 + c] = xj;
      for (int i = j + 1; i < 14; ++i) X[i * 13 + c] -= S[i * 14 + j] * xj;
    }
    for (int j = 13; j >= 0; --j) {
      float acc = X[j * 13 + c];
      for (int i = j + 1; i < 14; ++i) acc -= S[i * 14 + j] * X[i * 13 + c];
      X[j * 13 + c] = acc * w[KWS_DG + j];
    }
  }
  __syncwarp();
  MPC_STAGE(KS_SOLVE);
  // posterior: x = x_pred + (P C') S^-1 ey, P = P_pred - (P C') S^-1 C P
  for (int i = lane; i < 12; i += NL) {
    float acc = w[KWS_XP + i];
    for (int k = 0; k < 14; ++k) acc += CP[k * 12 + i] * X[k * 13];
    w[KWS_XN + i] = acc;
    kx_out[i] = acc;
  }
  float* Pn = S;   // the factor is no longer needed
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    float acc = 0.0f;
    for (int k = 0; k < 14; ++k) acc += CP[k * 12 + i] * X[k * 13 + 1 + j];
    Pn[e] = Pp[e] - acc;
  }
  __syncwarp();
  // symmetrize, then the xy conditioning (include/stateEstimator.h:
  // 299-306): cut the xy <-> rest covariances, shrink the xy block x0.1
  const float p01 = 0.5f * (Pn[1] + Pn[12]);
  const bool cond = Pn[0] * Pn[13] - p01 * p01 > 1e-6f;
  for (int e = lane; e < 144; e += NL) {
    const int i = e / 12, j = e % 12;
    float v = 0.5f * (Pn[e] + Pn[j * 12 + i]);
    if (cond) v *= ((i < 2) == (j < 2)) ? ((i < 2) ? 0.1f : 1.0f) : 0.0f;
    kp_out[e] = v;
  }
  __syncwarp();
  MPC_STAGE(KS_POST);
}

// ---- prologue and epilogue, shared by every variant ----------------------
struct Pre {
  bool ls;           // left leg in swing
  float t_now;       // iteration * dt
  float anc[3];      // clipped reference anchor (x, y, yaw)
  float target[3];   // swing foot placement
  float p_l_w[3], p_r_w[3];   // world feet from FK
  float next_b[3];   // the swing foot's next point in the base frame
  float swq[3];      // swing-leg joint command
};

// Sections 1-4 of the TPU kernel up to the swing IK: gait clock, both-leg
// FK, anchor clip and advance, foot placement and (`swing`) the swing
// foot's next point in the base frame.  `pos` / `vel` are the base
// position and velocity the controller sees (the truth, or the filter's
// posterior); the orientation is always xi's; `trig` gives its rotation
// and the legs' trig (TrigHere, TrigShared).  Pointers are already offset
// to this scenario.
template <class Trig>
__device__ __forceinline__ void tick_prologue_t(
    const TickParams& T, const Leg& g, const float* xi, const float* pos,
    const float* vel, const float* vdes, float wdes, const float* anc,
    float it, bool swing, const Trig& trig, float* anc_out, float* tgt_out,
    Pre& o) {
  o.t_now = __fmul_rn(it, T.dt);
  const float phase = pos_mod(o.t_now, T.cycle);
  const bool ls = phase < T.swing_t;
  o.ls = ls;
  const float remain = ls ? T.swing_t - phase : T.cycle - phase;
  const float progress = (T.swing_t - remain) / T.swing_t;

  float R[3][3];
  trig.rot(R);
  float pb[3], tmp[3];
  fk_leg_t(g, trig.leg(0), 1.0f, pb);
  mv(R, pb, tmp);
  for (int i = 0; i < 3; ++i) o.p_l_w[i] = pos[i] + tmp[i];
  fk_leg_t(g, trig.leg(1), -1.0f, pb);
  mv(R, pb, tmp);
  for (int i = 0; i < 3; ++i) o.p_r_w[i] = pos[i] + tmp[i];

  // reference anchor: clip into the band around the pose, advance
  o.anc[0] = fminf(fmaxf(anc[0], pos[0] - T.anchor_band),
                   pos[0] + T.anchor_band);
  o.anc[1] = fminf(fmaxf(anc[1], pos[1] - T.anchor_band),
                   pos[1] + T.anchor_band);
  o.anc[2] = fminf(fmaxf(anc[2], xi[2] - T.yaw_band), xi[2] + T.yaw_band);
  anc_out[0] = o.anc[0] + vdes[0] * T.dt;
  anc_out[1] = o.anc[1] + vdes[1] * T.dt;
  anc_out[2] = o.anc[2] + wdes * T.dt;

  // foot placement (capture or reference law)
  float vp[3], cx = 0.0f, cyy = 0.0f;
  for (int i = 0; i < 3; ++i) vp[i] = T.use_capture ? vel[i] : vdes[i];
  if (T.use_capture) {
    cx = T.k_cap * (vel[0] - vdes[0]);
    cyy = T.k_cap * (vel[1] - vdes[1]);
  }
  const float prx = fminf(fmaxf(vp[0] * (0.5f * T.stance_t) + cx,
                                -T.p_rel_max), T.p_rel_max);
  const float pry = fminf(fmaxf(vp[1] * (0.5f * T.stance_t) + cyy,
                                -T.p_rel_max), T.p_rel_max);
  float* target = o.target;
  target[0] = (pos[0] + vp[0] * remain) + prx + (ls ? T.off_l[0] : T.off_r[0]);
  target[1] = (pos[1] + vp[1] * remain) + pry + (ls ? T.off_l[1] : T.off_r[1]);
  if (T.anchor_gain > 0.0f) {
    target[0] += T.anchor_gain * (pos[0] - o.anc[0]);
    target[1] += T.anchor_gain * (pos[1] - o.anc[1]);
  }
  target[2] = T.ground_h;
  for (int i = 0; i < 3; ++i) tgt_out[i] = target[i];

  // the swing trajectory's next point (walking only)
  if (!swing) return;
  const float* fnow = ls ? o.p_l_w : o.p_r_w;
  float nxt[3];
  nxt[0] = fnow[0] + (target[0] - fnow[0]) * progress;
  nxt[1] = fnow[1] + (target[1] - fnow[1]) * progress;
  nxt[2] = T.ground_h + T.gait_height * sinf(CUDART_PI_F * progress);
  for (int i = 0; i < 3; ++i) tmp[i] = nxt[i] - pos[i];
  mtv(R, tmp, o.next_b);
}

// Sections 1-4 of the TPU kernel on one thread: tick_prologue_t, then
// (`swing`) the analytic IK of the swing leg to its next point.  Standing
// (`swing` false) stops after the placement: o.swq stays unset.
__device__ void tick_prologue(const TickParams& T, const Leg& g,
                              const float* xi, const float* pos,
                              const float* vel, const float* q6,
                              const float* vdes, float wdes,
                              const float* anc, float it, bool swing,
                              float* anc_out, float* tgt_out, Pre& o) {
  tick_prologue_t(T, g, xi, pos, vel, vdes, wdes, anc, it, swing,
                  TrigHere{xi, q6}, anc_out, tgt_out, o);
  if (!swing) return;
  ik_leg(g, o.next_b, o.ls ? q6 : q6 + 3, o.ls ? 1.0f : -1.0f, o.swq);
}

// Section 7: the stance forces f_l / f_r (world) to grf_out and the
// exact-ZOH SRBD step of the truth state xi into xn (and xi_out).
__device__ void plant_step_zoh(const TickParams& T, const float* xi,
                               const float* fl, const float* fr,
                               const float* f_l, const float* f_r,
                               float (&xn)[mpc::NX], float* xi_out,
                               float* grf_out) {
  const mpc::MpcParams& P = T.mpc;
  for (int i = 0; i < 3; ++i) {
    grf_out[i] = f_l[i];
    grf_out[3 + i] = f_r[i];
  }
  const float pos[3] = {xi[3], xi[4], xi[5]};
  const float rl[3] = {fl[0] - pos[0], fl[1] - pos[1], fl[2] - pos[2]};
  const float rr[3] = {fr[0] - pos[0], fr[1] - pos[1], fr[2] - pos[2]};
  float tau[3];
  tau[0] = (rl[1] * f_l[2] - rl[2] * f_l[1]) + (rr[1] * f_r[2] - rr[2] * f_r[1]);
  tau[1] = (rl[2] * f_l[0] - rl[0] * f_l[2]) + (rr[2] * f_r[0] - rr[0] * f_r[2]);
  tau[2] = (rl[0] * f_l[1] - rl[1] * f_l[0]) + (rr[0] * f_r[1] - rr[1] * f_r[0]);
  const float cy = cosf(xi[2]), sy = sinf(xi[2]);
  const float tb[3] = {cy * tau[0] + sy * tau[1], -sy * tau[0] + cy * tau[1],
                       tau[2]};
  float ib[3];
  for (int i = 0; i < 3; ++i)
    ib[i] = P.Iinv[3 * i] * tb[0] + P.Iinv[3 * i + 1] * tb[1]
          + P.Iinv[3 * i + 2] * tb[2];
  const float wd[3] = {cy * ib[0] - sy * ib[1], sy * ib[0] + cy * ib[1],
                       ib[2]};
  float acc[3];
  for (int i = 0; i < 3; ++i) acc[i] = (f_l[i] + f_r[i]) / P.mass;
  acc[2] += xi[12];
  const float dt = T.dt, half = dt * dt / 2.0f;
  const float w[3] = {xi[6], xi[7], xi[8]};
  const float rtw[3] = {cy * w[0] + sy * w[1], -sy * w[0] + cy * w[1], w[2]};
  const float rtwd[3] = {cy * wd[0] + sy * wd[1], -sy * wd[0] + cy * wd[1],
                         wd[2]};
  for (int i = 0; i < 3; ++i) {
    xn[i] = xi[i] + dt * rtw[i] + half * rtwd[i];
    xn[3 + i] = pos[i] + dt * xi[9 + i] + half * acc[i];
    xn[6 + i] = w[i] + dt * wd[i];
    xn[9 + i] = xi[9 + i] + dt * acc[i];
  }
  xn[12] = xi[12];
  for (int i = 0; i < mpc::NX; ++i) xi_out[i] = xn[i];
}

// Sections 7-8, walking: the plant step, then the swing foot following
// its command (ground clamp) and the stance foot pinned, its leg
// re-solved by IK.  Pointers are already offset to this scenario.
__device__ void tick_epilogue(const TickParams& T, const Leg& g,
                              const float* xi, const float* q6,
                              const float* fl, const float* fr, bool ls,
                              const float* f_l, const float* f_r,
                              const float* swq, float* xi_out, float* q_out,
                              float* fl_out, float* fr_out, float* grf_out) {
  float xn[mpc::NX];
  plant_step_zoh(T, xi, fl, fr, f_l, f_r, xn, xi_out, grf_out);

  float Rn[3][3];
  rot_rpy(xn, Rn);
  const float mir = ls ? 1.0f : -1.0f;
  float pb[3], tmp[3], psw[3];
  fk_leg(g, swq, mir, pb);
  mv(Rn, pb, tmp);
  for (int i = 0; i < 3; ++i) psw[i] = xn[3 + i] + tmp[i];
  psw[2] = fmaxf(psw[2], T.ground_h);
  float fl_n[3], fr_n[3];
  for (int i = 0; i < 3; ++i) {
    fl_n[i] = ls ? psw[i] : fl[i];
    fr_n[i] = ls ? fr[i] : psw[i];
    fl_out[i] = fl_n[i];
    fr_out[i] = fr_n[i];
  }
  const float* fst = ls ? fr_n : fl_n;
  for (int i = 0; i < 3; ++i) tmp[i] = fst[i] - xn[3 + i];
  float tb2[3], qst[3];
  mtv(Rn, tmp, tb2);
  ik_leg(g, tb2, ls ? q6 + 3 : q6, -mir, qst);
  for (int i = 0; i < 3; ++i) {
    q_out[i] = ls ? swq[i] : qst[i];
    q_out[3 + i] = ls ? qst[i] : swq[i];
  }
}

// Sections 7-8, standing: the plant step with both feet's forces; both
// feet stay pinned and both legs are re-solved by IK from the new base
// pose, the previous joints as the branch reference.
__device__ void stand_epilogue(const TickParams& T, const Leg& g,
                               const float* xi, const float* q6,
                               const float* fl, const float* fr,
                               const float* f_l, const float* f_r,
                               float* xi_out, float* q_out, float* fl_out,
                               float* fr_out, float* grf_out) {
  float xn[mpc::NX];
  plant_step_zoh(T, xi, fl, fr, f_l, f_r, xn, xi_out, grf_out);
  float Rn[3][3];
  rot_rpy(xn, Rn);
  float tmp[3], tb[3];
  for (int i = 0; i < 3; ++i) {
    fl_out[i] = fl[i];
    fr_out[i] = fr[i];
    tmp[i] = fl[i] - xn[3 + i];
  }
  mtv(Rn, tmp, tb);
  ik_leg(g, tb, q6, 1.0f, q_out);
  for (int i = 0; i < 3; ++i) tmp[i] = fr[i] - xn[3 + i];
  mtv(Rn, tmp, tb);
  ik_leg(g, tb, q6 + 3, -1.0f, q_out + 3);
}

// The held-force tick on a scenario's half warp (sections 1-4, the held
// force, sections 7-8 of scenario b; STAND: the standing tick): the
// arithmetic of tick_prologue and tick_epilogue / stand_epilogue, laid
// out so that its two leg IKs -- walking, the swing leg to its next point
// and the stance leg re-pinned; standing, both legs re-pinned -- run on
// lanes 0 and 1 at once, and the new attitude's and the swing leg's sines
// and cosines on three lanes at once; the rest runs on lane 0, which
// alone reads `pos` / `vel` (the controller's base position and velocity:
// the truth's, or the filter's posterior).  trig: tick_trig_warp's.
template <bool STAND>
__device__ void hold_tick(const TickParams& T, const Leg& g,
                          const TickIO& io, int b, int lane,
                          const float* pos, const float* vel,
                          const float* trig) {
  const float* xi = io.xi + b * mpc::NX;
  const float* q6 = io.q + b * 6;
  const float* fl = io.fl + b * 3;
  const float* fr = io.fr + b * 3;
  Pre o{};
  float xn[mpc::NX] = {};
  if (lane == 0) {
    // gait, FK, anchor, placement, the swing foot's next point; the held
    // force (walking: on the foot in stance NOW; standing: the pair as
    // given); the plant step; z / y pass through, no residual
    tick_prologue_t(T, g, xi, pos, vel, io.vdes + b * 3, io.wdes[b],
                    io.anc + b * 3, io.it[b], !STAND, TrigShared{trig},
                    io.anc_o + b * 3, io.tgt_o + b * 3, o);
    MPC_STAGE(KS_HOLD_PRE);
    const float* gh = io.grf + b * 6;
    float f_l[3], f_r[3];
    for (int i = 0; i < 3; ++i) {
      const float fa = gh[i] + gh[3 + i];
      f_l[i] = STAND ? gh[i] : o.ls ? 0.0f : fa;
      f_r[i] = STAND ? gh[3 + i] : o.ls ? fa : 0.0f;
    }
    io.res_o[b] = 0.0f;
    plant_step_zoh(T, xi, fl, fr, f_l, f_r, xn, io.xi_o + b * mpc::NX,
                   io.grf_o + b * 6);
  }
  const bool ls = half_bcast(o.ls ? 1 : 0, 0) != 0;
  float xb[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xb[i] = half_bcast(xn[i], 0);
  // the new attitude's rotation: an angle a lane on lanes 0-2
  const float an = lane == 0 ? xb[0] : lane == 1 ? xb[1] : xb[2];
  const float cn = cosf(an), sn = sinf(an);
  float Rn[3][3];
  rot_cs(half_bcast(cn, 0), half_bcast(sn, 0),
         half_bcast(cn, 1), half_bcast(sn, 1),
         half_bcast(cn, 2), half_bcast(sn, 2), Rn);
  // the two IKs at once, lane 0 and lane 1: a pinned leg's target is its
  // foot in the new base frame, the swing leg's its next point
  const bool swing_leg = !STAND && lane == 0;
  const bool right = STAND ? lane == 1 : (swing_leg ? !ls : ls);
  const float* foot = right ? fr : fl;
  float tmp[3], tgt[3], qik[3] = {};
  for (int i = 0; i < 3; ++i) tmp[i] = foot[i] - xb[3 + i];
  mtv(Rn, tmp, tgt);
  for (int i = 0; i < 3; ++i) tgt[i] = swing_leg ? o.next_b[i] : tgt[i];
  if (lane < 2)
    ik_leg(g, tgt, right ? q6 + 3 : q6, right ? -1.0f : 1.0f, qik);
  float* q_out = io.q_o + b * 6;
  float* fl_out = io.fl_o + b * 3;
  float* fr_out = io.fr_o + b * 3;
  if constexpr (STAND) {
    if (lane < 2)
      for (int i = 0; i < 3; ++i) q_out[3 * lane + i] = qik[i];
    if (lane == 0)
      for (int i = 0; i < 3; ++i) {
        fl_out[i] = fl[i];
        fr_out[i] = fr[i];
      }
  } else {
    // the swing foot follows its command (ground clamp): its leg's sines
    // and cosines on lanes 0-2, the rest on lane 0
    float swq[3], qst[3];
    for (int i = 0; i < 3; ++i) {
      swq[i] = half_bcast(qik[i], 0);
      qst[i] = half_bcast(qik[i], 1);
    }
    const float a = lane == 0 ? swq[0] : lane == 1 ? swq[1] : swq[1] + swq[2];
    const float ca = cosf(a), sa = sinf(a);
    const LegTrig t{half_bcast(ca, 0), half_bcast(sa, 0),
                    half_bcast(ca, 1), half_bcast(sa, 1),
                    half_bcast(ca, 2), half_bcast(sa, 2)};
    if (lane == 0) {
      const float mir = ls ? 1.0f : -1.0f;
      float pb[3], psw[3];
      fk_leg_t(g, t, mir, pb);
      mv(Rn, pb, tmp);
      for (int i = 0; i < 3; ++i) psw[i] = xb[3 + i] + tmp[i];
      psw[2] = fmaxf(psw[2], T.ground_h);
      for (int i = 0; i < 3; ++i) {
        fl_out[i] = ls ? psw[i] : fl[i];
        fr_out[i] = ls ? fr[i] : psw[i];
        q_out[i] = ls ? swq[i] : qst[i];
        q_out[3 + i] = ls ? qst[i] : swq[i];
      }
    }
  }
}

// threads per block of the held-force forms (no MPC), how many scenarios
// a block takes (one per half warp), and the blocks an SM must hold: four
// of 128 threads, so 128 registers a thread at most, let the 512 blocks of
// B = 4096 scenarios run as one wave on 132 SMs without spilling
constexpr int HOLD_NT = 128;
constexpr int HOLD_PER_BLOCK = HOLD_NT / KF_LANES;
constexpr int HOLD_MIN_BLOCKS = 4;

// The held-force kernels' body (STAND: standing; KF: the filter's
// posterior drives the controller, else the truth): a scenario on each
// half warp.  A half past the batch repeats the last scenario (its inputs,
// so the same values written), so that the warp's shuffles and
// __syncwarp()s stay full.  With the truth the tick needs only the nine
// angles' sines and cosines (tick_trig_warp) in shared memory; the filter
// leaves them in its scratch.
template <bool STAND, bool KF>
__device__ __forceinline__ void hold_kernel_body(const TickParams& T,
                                                 const TickIO& io, int B) {
  MPC_STAGE(mpc::ST_START);
  const Leg g = load_leg(T);
  const int slot = threadIdx.x / KF_LANES, lane = threadIdx.x % KF_LANES;
  const int b0 = blockIdx.x * HOLD_PER_BLOCK + (slot & ~1);
  if (b0 >= B) return;   // the whole warp
  const int b = b0 + (slot & 1) < B ? b0 + (slot & 1) : B - 1;
  const float* xi = io.xi + b * mpc::NX;
  const float* q6 = io.q + b * 6;
  if constexpr (KF) {
    __shared__ float scratch[HOLD_PER_BLOCK][KW_SIZE];
    float* w = scratch[slot];
    kf_tick(T, g, lane, !STAND && left_swing(T, io.it[b]), STAND, xi, q6,
            io.pv + b * 3, io.pq + b * 6, io.kx + b * 12, io.kp + b * 144, w,
            io.kx_o + b * 12, io.kp_o + b * 144);
    hold_tick<STAND>(T, g, io, b, lane, w + KW_XN, w + KW_XN + 3,
                     w + KW_TRIG);
  } else {
    __shared__ float trig[HOLD_PER_BLOCK][18];   // cosines, then sines
    tick_trig_warp(lane, xi, q6, trig[slot]);
    __syncwarp();
    hold_tick<STAND>(T, g, io, b, lane, xi + 3, xi + 9, trig[slot]);
  }
  MPC_STAGE(mpc::ST_END);
}

}  // namespace

// ---- C entry points (plain C interface for ctypes) -----------------------
// One macro per variant defines `extern "C" int name(prm, pointers..., B,
// stream)` around a launcher `int launch(const TickParams*, const TickIO&,
// int B, void* stream)`.  Pointer order: inputs xi, q, foot_l, foot_r,
// [z_warm, y_warm], anchor, it, v_des, yaw_rate, [grf_held], [kf_x, kf_p,
// prev_v, prev_q]; outputs xi, q, foot_l, foot_r, [z, y], anchor, residual,
// grf, target, [kf_x, kf_p] -- the bracketed groups as the variant has
// them.
#define TICK_IO_STATE_(io)                                                  \
  io.xi = (const float*)xi; io.q = (const float*)q;                         \
  io.fl = (const float*)foot_l; io.fr = (const float*)foot_r;               \
  io.anc = (const float*)anchor; io.it = (const float*)it;                  \
  io.vdes = (const float*)v_des; io.wdes = (const float*)yaw_rate;          \
  io.xi_o = (float*)xi_out; io.q_o = (float*)q_out;                         \
  io.fl_o = (float*)fl_out; io.fr_o = (float*)fr_out;                       \
  io.anc_o = (float*)anc_out; io.res_o = (float*)res_out;                   \
  io.grf_o = (float*)grf_out; io.tgt_o = (float*)tgt_out;
#define TICK_IO_WARM_(io)                                                   \
  io.zw = (const float*)z_warm; io.yw = (const float*)y_warm;               \
  io.z_o = (float*)z_out; io.y_o = (float*)y_out;
#define TICK_IO_KF_(io)                                                     \
  io.kx = (const float*)kf_x; io.kp = (const float*)kf_p;                   \
  io.pv = (const float*)prev_v; io.pq = (const float*)prev_q;               \
  io.kx_o = (float*)kfx_out; io.kp_o = (float*)kfp_out;

#define TICK_ENTRY_SOLVE(name, launch)                                      \
  extern "C" int name(                                                      \
      const mpc::TickParams* prm, const void* xi, const void* q,            \
      const void* foot_l, const void* foot_r, const void* z_warm,           \
      const void* y_warm, const void* anchor, const void* it,               \
      const void* v_des, const void* yaw_rate, void* xi_out, void* q_out,   \
      void* fl_out, void* fr_out, void* z_out, void* y_out, void* anc_out,  \
      void* res_out, void* grf_out, void* tgt_out, int B, void* stream) {   \
    mpc::TickIO io{};                                                       \
    TICK_IO_STATE_(io) TICK_IO_WARM_(io)                                    \
    return launch(prm, io, B, stream);                                      \
  }

#define TICK_ENTRY_KF(name, launch)                                         \
  extern "C" int name(                                                      \
      const mpc::TickParams* prm, const void* xi, const void* q,            \
      const void* foot_l, const void* foot_r, const void* z_warm,           \
      const void* y_warm, const void* anchor, const void* it,               \
      const void* v_des, const void* yaw_rate, const void* kf_x,            \
      const void* kf_p, const void* prev_v, const void* prev_q,             \
      void* xi_out, void* q_out, void* fl_out, void* fr_out, void* z_out,   \
      void* y_out, void* anc_out, void* res_out, void* grf_out,             \
      void* tgt_out, void* kfx_out, void* kfp_out, int B, void* stream) {   \
    mpc::TickIO io{};                                                       \
    TICK_IO_STATE_(io) TICK_IO_WARM_(io) TICK_IO_KF_(io)                    \
    return launch(prm, io, B, stream);                                      \
  }

#define TICK_ENTRY_HOLD(name, launch)                                       \
  extern "C" int name(                                                      \
      const mpc::TickParams* prm, const void* xi, const void* q,            \
      const void* foot_l, const void* foot_r, const void* anchor,           \
      const void* it, const void* v_des, const void* yaw_rate,              \
      const void* grf_held, void* xi_out, void* q_out, void* fl_out,        \
      void* fr_out, void* anc_out, void* res_out, void* grf_out,            \
      void* tgt_out, int B, void* stream) {                                 \
    mpc::TickIO io{};                                                       \
    TICK_IO_STATE_(io)                                                      \
    io.grf = (const float*)grf_held;                                        \
    return launch(prm, io, B, stream);                                      \
  }

#define TICK_ENTRY_KF_HOLD(name, launch)                                    \
  extern "C" int name(                                                      \
      const mpc::TickParams* prm, const void* xi, const void* q,            \
      const void* foot_l, const void* foot_r, const void* anchor,           \
      const void* it, const void* v_des, const void* yaw_rate,              \
      const void* grf_held, const void* kf_x, const void* kf_p,             \
      const void* prev_v, const void* prev_q, void* xi_out, void* q_out,    \
      void* fl_out, void* fr_out, void* anc_out, void* res_out,             \
      void* grf_out, void* tgt_out, void* kfx_out, void* kfp_out, int B,    \
      void* stream) {                                                       \
    mpc::TickIO io{};                                                       \
    TICK_IO_STATE_(io) TICK_IO_KF_(io)                                      \
    io.grf = (const float*)grf_held;                                        \
    return launch(prm, io, B, stream);                                      \
  }
