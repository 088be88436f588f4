// walking_tick: one whole closed-loop walking tick, one scenario per block.
//
// Replaces mpc_limx_control_tpu/ops/tick_fused_pallas.py:_tick_kernel
// (:130; pallas_call at :868 via _fused_tick_core :737, fused_walking_tick
// :626 and make_tick_fused :911) in walk mode with truth odometry and no
// held force: gait clock, both-leg FK, reference-anchor clip, capture-point
// placement, sinusoidal swing + analytic IK, contact schedule and moment
// arms over the horizon, the prep-fused MPC (mpc_core.cuh), GRF split,
// exact-ZOH SRBD plant step, rigid-ground clamp, and the next tick's swing
// FK and stance-pinning IK.  The hold / KF / standing variants of the TPU
// kernel are later slices and are refused by the Python wrapper.
//
// Bound on this card: latency.  The scalar prologue and epilogue (a few
// hundred flops and ~30 transcendentals) run on one thread; the MPC core
// in the middle is ~60 barrier-separated Cholesky steps + 12 x 60
// warp-shuffle substitution steps.  One small block per scenario keeps
// several scenarios resident per SM to hide that latency.
//
// The gait-clock times are formed with __fmul_rn / __fadd_rn so that no
// fused multiply-add changes their rounding: phase switches then land on
// the same tick as in the plain PyTorch tick (and in JAX).
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
};

}  // namespace mpc

namespace {

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

// tick-local scratch after the MPC layout (floats)
constexpr int TK_LS = 0;       // left swing flag (1 / 0)
constexpr int TK_TNOW = 1;     // iteration * dt
constexpr int TK_ARML = 2;     // arm_l [3]
constexpr int TK_ARMR = 5;     // arm_r [3]
constexpr int TK_SWQ = 8;      // swing_q [3]
constexpr int TK_SIZE = 16;

__global__ void __launch_bounds__(mpc::NT)
walking_tick_kernel(const __grid_constant__ TickParams T,
                    const float* __restrict__ xi_in,
                    const float* __restrict__ q_in,
                    const float* __restrict__ fl_in,
                    const float* __restrict__ fr_in,
                    const float* __restrict__ z_warm,
                    const float* __restrict__ y_warm,
                    const float* __restrict__ anc_in,
                    const float* __restrict__ it_in,
                    const float* __restrict__ vdes_in,
                    const float* __restrict__ wdes_in,
                    float* __restrict__ xi_out, float* __restrict__ q_out,
                    float* __restrict__ fl_out, float* __restrict__ fr_out,
                    float* __restrict__ z_out, float* __restrict__ y_out,
                    float* __restrict__ anc_out,
                    float* __restrict__ res_out,
                    float* __restrict__ grf_out,
                    float* __restrict__ tgt_out) {
  extern __shared__ float sm[];
  const mpc::MpcParams& P = T.mpc;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = P.N, n = mpc::NU * N, m = mpc::MU * N;
  const mpc::Smem L = mpc::smem_layout(N);
  float* aux = sm + L.aux;
  float* tk = sm + L.total;
  const Leg g = load_leg(T);

  // ---- prologue (one thread): gait, FK, anchor, placement, swing IK ---
  if (tid == 0) {
    const float* xi = xi_in + b * mpc::NX;
    const float* q6 = q_in + b * 6;
    const float* vdes = vdes_in + b * 3;
    const float wdes = wdes_in[b];
    const float* anc = anc_in + b * 3;
    const float pos[3] = {xi[3], xi[4], xi[5]};
    const float vel[3] = {xi[9], xi[10], xi[11]};

    const float t_now = __fmul_rn(it_in[b], T.dt);
    const float phase = pos_mod(t_now, T.cycle);
    const bool ls = phase < T.swing_t;
    const float remain = ls ? T.swing_t - phase : T.cycle - phase;
    const float progress = (T.swing_t - remain) / T.swing_t;

    float R[3][3];
    rot_rpy(xi, R);
    float pb[3], tmp[3], p_l_w[3], p_r_w[3];
    fk_leg(g, q6, 1.0f, pb);
    mv(R, pb, tmp);
    for (int i = 0; i < 3; ++i) p_l_w[i] = pos[i] + tmp[i];
    fk_leg(g, q6 + 3, -1.0f, pb);
    mv(R, pb, tmp);
    for (int i = 0; i < 3; ++i) p_r_w[i] = pos[i] + tmp[i];

    // reference anchor: clip into the band around the pose, advance
    const float ax = fminf(fmaxf(anc[0], pos[0] - T.anchor_band),
                           pos[0] + T.anchor_band);
    const float ay = fminf(fmaxf(anc[1], pos[1] - T.anchor_band),
                           pos[1] + T.anchor_band);
    const float ayaw = fminf(fmaxf(anc[2], xi[2] - T.yaw_band),
                             xi[2] + T.yaw_band);
    anc_out[b * 3 + 0] = ax + vdes[0] * T.dt;
    anc_out[b * 3 + 1] = ay + vdes[1] * T.dt;
    anc_out[b * 3 + 2] = ayaw + wdes * T.dt;

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
    float target[3];
    target[0] = (pos[0] + vp[0] * remain) + prx + (ls ? T.off_l[0] : T.off_r[0]);
    target[1] = (pos[1] + vp[1] * remain) + pry + (ls ? T.off_l[1] : T.off_r[1]);
    if (T.anchor_gain > 0.0f) {
      target[0] += T.anchor_gain * (pos[0] - ax);
      target[1] += T.anchor_gain * (pos[1] - ay);
    }
    target[2] = T.ground_h;
    for (int i = 0; i < 3; ++i) tgt_out[b * 3 + i] = target[i];

    // swing trajectory + analytic IK of the swing leg
    const float* fnow = ls ? p_l_w : p_r_w;
    float nxt[3];
    nxt[0] = fnow[0] + (target[0] - fnow[0]) * progress;
    nxt[1] = fnow[1] + (target[1] - fnow[1]) * progress;
    nxt[2] = T.ground_h + T.gait_height * sinf(CUDART_PI_F * progress);
    for (int i = 0; i < 3; ++i) tmp[i] = nxt[i] - pos[i];
    float next_b[3];
    mtv(R, tmp, next_b);
    float swq[3];
    ik_leg(g, next_b, ls ? q6 : q6 + 3, ls ? 1.0f : -1.0f, swq);

    // stage the MPC inputs: truth odometry, clipped anchor, commands
    for (int i = 0; i < mpc::NX; ++i) sm[L.x0 + i] = xi[i];
    for (int i = 0; i < 3; ++i) aux[mpc::AUX_VDES + i] = vdes[i];
    aux[mpc::AUX_WDES] = wdes;
    aux[mpc::AUX_ANC + 0] = ax;
    aux[mpc::AUX_ANC + 1] = ay;
    aux[mpc::AUX_ANC + 2] = ayaw;
    tk[TK_LS] = ls ? 1.0f : 0.0f;
    tk[TK_TNOW] = t_now;
    for (int i = 0; i < 3; ++i) {
      // a standing foot pushes from where it is; the swinging foot
      // re-enters stance at its placement target
      tk[TK_ARML + i] = ls ? target[i] : p_l_w[i];
      tk[TK_ARMR + i] = ls ? p_r_w[i] : target[i];
      tk[TK_SWQ + i] = swq[i];
    }
  }
  __syncthreads();

  // ---- contact schedule + moment arms over the horizon ----------------
  for (int k = tid; k < N; k += mpc::NT) {
    const float tk_k = __fadd_rn(tk[TK_TNOW], __fmul_rn((float)k, P.ts));
    const bool left_stance = !(pos_mod(tk_k, T.cycle) < T.swing_t);
    const float* arm = tk + (left_stance ? TK_ARML : TK_ARMR);
    for (int i = 0; i < 3; ++i) sm[L.arms + 3 * k + i] = arm[i];
  }
  __syncthreads();

  // ---- the prep-fused MPC solve ---------------------------------------
  mpc::mpc_prep_solve(P, sm, L, z_warm + (size_t)b * n,
                      y_warm + (size_t)b * m);

  for (int c = tid; c < n; c += mpc::NT) z_out[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += mpc::NT) y_out[(size_t)b * m + r] = sm[L.y + r];

  // ---- epilogue (one thread): GRF split, plant step, next kinematics --
  if (tid == 0) {
    const float* xi = xi_in + b * mpc::NX;
    const float* q6 = q_in + b * 6;
    const float* fl = fl_in + b * 3;
    const float* fr = fr_in + b * 3;
    const bool ls = tk[TK_LS] > 0.5f;
    const float* u0 = sm + L.z;
    res_out[b] = aux[mpc::AUX_RES];

    float f_l[3], f_r[3];
    for (int i = 0; i < 3; ++i) {
      f_l[i] = ls ? 0.0f : u0[i];
      f_r[i] = ls ? u0[i] : 0.0f;
      grf_out[b * 6 + i] = f_l[i];
      grf_out[b * 6 + 3 + i] = f_r[i];
    }

    // exact-ZOH SRBD step in vector form
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
    float xn[mpc::NX];
    for (int i = 0; i < 3; ++i) {
      xn[i] = xi[i] + dt * rtw[i] + half * rtwd[i];
      xn[3 + i] = pos[i] + dt * xi[9 + i] + half * acc[i];
      xn[6 + i] = w[i] + dt * wd[i];
      xn[9 + i] = xi[9 + i] + dt * acc[i];
    }
    xn[12] = xi[12];
    for (int i = 0; i < mpc::NX; ++i) xi_out[b * mpc::NX + i] = xn[i];

    // next-tick kinematics: swing foot follows its command (ground
    // clamp), stance foot stays pinned and its leg is re-solved by IK
    float Rn[3][3];
    rot_rpy(xn, Rn);
    const float* swq = tk + TK_SWQ;
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
      fl_out[b * 3 + i] = fl_n[i];
      fr_out[b * 3 + i] = fr_n[i];
    }
    const float* fst = ls ? fr_n : fl_n;
    for (int i = 0; i < 3; ++i) tmp[i] = fst[i] - xn[3 + i];
    float tb2[3], qst[3];
    mtv(Rn, tmp, tb2);
    ik_leg(g, tb2, ls ? q6 + 3 : q6, -mir, qst);
    for (int i = 0; i < 3; ++i) {
      q_out[b * 6 + i] = ls ? swq[i] : qst[i];
      q_out[b * 6 + 3 + i] = ls ? qst[i] : swq[i];
    }
  }
}

}  // namespace

extern "C" int walking_tick_smem_bytes(int N) {
  return (int)((mpc::smem_layout(N).total + TK_SIZE) * sizeof(float));
}

extern "C" int walking_tick_params_bytes() { return (int)sizeof(TickParams); }

extern "C" int walking_tick(const TickParams* prm, const void* xi,
                            const void* q, const void* foot_l,
                            const void* foot_r, const void* z_warm,
                            const void* y_warm, const void* anchor,
                            const void* it, const void* v_des,
                            const void* yaw_rate, void* xi_out, void* q_out,
                            void* fl_out, void* fr_out, void* z_out,
                            void* y_out, void* anc_out, void* res_out,
                            void* grf_out, void* tgt_out, int B,
                            void* stream) {
  if (B <= 0) return 0;
  const int bytes = walking_tick_smem_bytes(prm->mpc.N);
  cudaError_t err = cudaFuncSetAttribute(
      walking_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  walking_tick_kernel<<<B, mpc::NT, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)xi, (const float*)q, (const float*)foot_l,
      (const float*)foot_r, (const float*)z_warm, (const float*)y_warm,
      (const float*)anchor, (const float*)it, (const float*)v_des,
      (const float*)yaw_rate, (float*)xi_out, (float*)q_out, (float*)fl_out,
      (float*)fr_out, (float*)z_out, (float*)y_out, (float*)anc_out,
      (float*)res_out, (float*)grf_out, (float*)tgt_out);
  return (int)cudaGetLastError();
}
