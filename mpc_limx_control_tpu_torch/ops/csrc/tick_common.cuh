// Device functions shared by the whole-tick kernels (walking_tick.cu,
// standing_tick.cu): the kernel constants and pointer block, leg
// kinematics, the 12-state Kalman filter on one warp, and the tick's
// prologue (gait clock, FK, anchor, placement, swing IK) and epilogue
// (exact-ZOH SRBD plant step, next-tick kinematics).  Counterparts of the
// sections of mpc_limx_control_tpu/ops/tick_fused_pallas.py:_tick_kernel
// (:130) named at each function.
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

// R = Rz(yaw) Ry(pitch) Rx(roll), row-major
__device__ void rot_rpy(const float* rpy, float R[3][3]) {
  const float cr = cosf(rpy[0]), sr = sinf(rpy[0]);
  const float cp = cosf(rpy[1]), sp = sinf(rpy[1]);
  const float cy = cosf(rpy[2]), sy = sinf(rpy[2]);
  R[0][0] = cy * cp; R[0][1] = cy * sp * sr - sy * cr;
  R[0][2] = cy * sp * cr + sy * sr;
  R[1][0] = sy * cp; R[1][1] = sy * sp * sr + cy * cr;
  R[1][2] = sy * sp * cr - cy * sr;
  R[2][0] = -sp; R[2][1] = cp * sr; R[2][2] = cp * cr;
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

// contact point in the base frame; mir = +1 left / -1 right
__device__ void fk_leg(const Leg& g, const float* q, float mir, float* p) {
  const float c0 = cosf(q[0]), s0 = sinf(q[0]);
  const float c1 = cosf(q[1]), s1 = sinf(q[1]);
  const float q12 = q[1] + q[2];
  const float c12 = cosf(q12), s12 = sinf(q12);
  const float ux = g.hx + c1 * g.kx + s1 * g.kz + c12 * g.fx + s12 * g.fz;
  const float uy = (g.hy + g.ky + g.fy) * mir;
  const float uz = g.hz - s1 * g.kx + c1 * g.kz - s12 * g.fx + c12 * g.fz;
  p[0] = g.ax + ux;
  p[1] = g.ay * mir + c0 * uy - s0 * uz;
  p[2] = g.az + s0 * uy + c0 * uz;
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
// Rx(q0) Ry(q1) Ry(q2) chain's Jacobian)
__device__ void jac_vel(const Leg& g, const float* q, const float* dq,
                        float mir, float* v) {
  const float c0 = cosf(q[0]), s0 = sinf(q[0]);
  const float c1 = cosf(q[1]), s1 = sinf(q[1]);
  const float q12 = q[1] + q[2];
  const float c12 = cosf(q12), s12 = sinf(q12);
  const float a1 = c1 * g.kx + s1 * g.kz, b1 = -s1 * g.kx + c1 * g.kz;
  const float a2 = c12 * g.fx + s12 * g.fz, b2 = -s12 * g.fx + c12 * g.fz;
  const float uy = (g.hy + g.ky + g.fy) * mir;
  const float uz = g.hz + b1 + b2;
  const float vz_pl = -(dq[1] * (a1 + a2) + dq[2] * a2);
  v[0] = dq[1] * (b1 + b2) + dq[2] * b2;
  v[1] = dq[0] * (-s0 * uy - c0 * uz) - s0 * vz_pl;
  v[2] = dq[0] * (c0 * uy - s0 * uz) + c0 * vz_pl;
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

// ---- the Kalman filter ------------------------------------------------
// Filter scratch (floats): predicted covariance, C P, the innovation
// covariance S (its lower Cholesky factor in place, then the posterior
// covariance before symmetrization), the 13 right-hand sides [ey | C P],
// predicted state, observation, R diagonal, 1 / diag(L), posterior state.
constexpr int KW_PP = 0;      // [12][12]
constexpr int KW_CP = 144;    // [14][12]
constexpr int KW_S = 312;     // [14][14]
constexpr int KW_X = 508;     // [14][13]
constexpr int KW_XP = 690;    // [12]
constexpr int KW_Y = 702;     // [14]
constexpr int KW_RD = 716;    // [14]
constexpr int KW_DG = 730;    // [14]
constexpr int KW_XN = 744;    // [12]
constexpr int KW_SIZE = 756;

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
// Run by the 32 lanes of one warp (lane = 0..31), w [KW_SIZE] in shared
// memory.
__device__ __forceinline__ void kf_tick(
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
  float* Pp = w + KW_PP;
  float* CP = w + KW_CP;
  float* S = w + KW_S;
  float* X = w + KW_X;

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
    float* y = w + KW_Y;
    y[0] = -pl[0]; y[1] = -pl[1]; y[2] = rad - pl[2];
    y[3] = -pr[0]; y[4] = -pr[1]; y[5] = rad - pr[2];
    for (int i = 0; i < 3; ++i) {
      y[6 + i] = -vl[i];
      y[9 + i] = -vr[i];
    }
    y[12] = 0.0f;
    y[13] = 0.0f;
    // predict the state with the world acceleration
    float* xp = w + KW_XP;
    for (int i = 0; i < 3; ++i) {
      xp[i] = kx[i] + dt * kx[3 + i] + (0.5f * dt * dt) * aw[i];
      xp[3 + i] = kx[3 + i] + dt * aw[i];
    }
    for (int i = 6; i < 12; ++i) xp[i] = kx[i];
    // contact-gated measurement noise
    float* rd = w + KW_RD;
    for (int i = 0; i < 3; ++i) {
      rd[i] = T.kf[3] * gl;
      rd[3 + i] = T.kf[3] * gr;
      rd[6 + i] = T.kf[4] * gl;
      rd[9 + i] = T.kf[4] * gr;
    }
    rd[12] = T.kf[5] * gl;
    rd[13] = T.kf[5] * gr;
  }
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
    if (c <= r) S[e] = c_row(CP + r * 12, 1, c) + (r == c ? w[KW_RD + r]
                                                          : 0.0f);
  }
  for (int e = lane; e < 168; e += NL)           // rhs columns 1..12
    X[(e / 12) * 13 + 1 + e % 12] = CP[e];
  for (int r = lane; r < 14; r += NL)            // rhs column 0: innovation
    X[r * 13] = w[KW_Y + r] - c_row(w + KW_XP, 1, r);
  __syncwarp();

  // Cholesky of S in place (lower), pivots clamped at 1e-30
  for (int j = 0; j < 14; ++j) {
    const float inv = 1.0f / sqrtf(fmaxf(S[j * 14 + j], 1e-30f));
    if (lane == 0) w[KW_DG + j] = inv;
    for (int i = j + 1 + lane; i < 14; i += NL) S[i * 14 + j] *= inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < 14; i += NL) {
      const float lij = S[i * 14 + j];
      for (int k = j + 1; k <= i; ++k) S[i * 14 + k] -= lij * S[k * 14 + j];
    }
    __syncwarp();
  }
  // S^-1 [ey | C P]: one right-hand side per lane, forward then back
  for (int c = lane; c < 13; c += NL) {
    for (int j = 0; j < 14; ++j) {
      const float xj = X[j * 13 + c] * w[KW_DG + j];
      X[j * 13 + c] = xj;
      for (int i = j + 1; i < 14; ++i) X[i * 13 + c] -= S[i * 14 + j] * xj;
    }
    for (int j = 13; j >= 0; --j) {
      float acc = X[j * 13 + c];
      for (int i = j + 1; i < 14; ++i) acc -= S[i * 14 + j] * X[i * 13 + c];
      X[j * 13 + c] = acc * w[KW_DG + j];
    }
  }
  __syncwarp();
  // posterior: x = x_pred + (P C') S^-1 ey, P = P_pred - (P C') S^-1 C P
  for (int i = lane; i < 12; i += NL) {
    float acc = w[KW_XP + i];
    for (int k = 0; k < 14; ++k) acc += CP[k * 12 + i] * X[k * 13];
    w[KW_XN + i] = acc;
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
}

// ---- prologue and epilogue, shared by every variant ----------------------
struct Pre {
  bool ls;           // left leg in swing
  float t_now;       // iteration * dt
  float anc[3];      // clipped reference anchor (x, y, yaw)
  float target[3];   // swing foot placement
  float p_l_w[3], p_r_w[3];   // world feet from FK
  float swq[3];      // swing-leg joint command
};

// Sections 1-4 of the TPU kernel: gait clock, both-leg FK, anchor clip
// and advance, foot placement, swing trajectory and swing IK.  `pos` /
// `vel` are the base position and velocity the controller sees (the
// truth, or the filter's posterior); the orientation is always xi's.
// Standing (`swing` false) stops after the placement: o.swq stays unset.
// Pointers are already offset to this scenario.
__device__ void tick_prologue(const TickParams& T, const Leg& g,
                              const float* xi, const float* pos,
                              const float* vel, const float* q6,
                              const float* vdes, float wdes,
                              const float* anc, float it, bool swing,
                              float* anc_out, float* tgt_out, Pre& o) {
  o.t_now = __fmul_rn(it, T.dt);
  const float phase = pos_mod(o.t_now, T.cycle);
  const bool ls = phase < T.swing_t;
  o.ls = ls;
  const float remain = ls ? T.swing_t - phase : T.cycle - phase;
  const float progress = (T.swing_t - remain) / T.swing_t;

  float R[3][3];
  rot_rpy(xi, R);
  float pb[3], tmp[3];
  fk_leg(g, q6, 1.0f, pb);
  mv(R, pb, tmp);
  for (int i = 0; i < 3; ++i) o.p_l_w[i] = pos[i] + tmp[i];
  fk_leg(g, q6 + 3, -1.0f, pb);
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

  // swing trajectory + analytic IK of the swing leg (walking only)
  if (!swing) return;
  const float* fnow = ls ? o.p_l_w : o.p_r_w;
  float nxt[3];
  nxt[0] = fnow[0] + (target[0] - fnow[0]) * progress;
  nxt[1] = fnow[1] + (target[1] - fnow[1]) * progress;
  nxt[2] = T.ground_h + T.gait_height * sinf(CUDART_PI_F * progress);
  for (int i = 0; i < 3; ++i) tmp[i] = nxt[i] - pos[i];
  float next_b[3];
  mtv(R, tmp, next_b);
  ik_leg(g, next_b, ls ? q6 : q6 + 3, ls ? 1.0f : -1.0f, o.swq);
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

// threads per block of the held-force forms (no MPC), and how many
// scenarios a block of the KF held-force form takes (one per warp)
constexpr int HOLD_NT = 128;
constexpr int HOLD_KF_WARPS = HOLD_NT / 32;

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
