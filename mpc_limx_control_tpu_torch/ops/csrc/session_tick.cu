// walking_session_tick: the live session's walking tick at batch 1, one
// kernel a tick.
//
// The JAX session runs its solve and held-force ticks as two jax.jit
// closures of controller.tick (control/session.py), which XLA fuses into a
// few kernels.  Their PyTorch counterparts (ControlSession._warm_fn /
// _hold_fn) replayed as CUDA graphs are ~470 / ~340 small dependent
// kernels, ~1.2 us each on the device.  These two entry points do the same
// work in one launch each:
//
//   walking_session_tick       the warm solve tick: the packet's first
//                              SOLVE_IN floats, the QP warm state (z, y)
//                              in place, out [command, next anchor, force]
//   walking_session_tick_hold  the held-force tick: the packet in, the
//                              command out, the next anchor into the
//                              packet
//
// A tick is controller.tick's walking branch: gait clock, both-leg FK,
// anchor clip and advance, capture placement, swing trajectory and
// analytic IK (tick_prologue_t + ik_leg of tick_common.cuh); solving, the
// contact schedule, the moment arms and the prep-fused MPC core
// (mpc::mpc_prep_solve of mpc_core.cuh, as walking_tick.cu stages it);
// holding, the held force on the foot now in stance; then the command
// [q dq tau kp kd] (walking_command): the stance torque
// tau = -J_st' (R' f), the swing IK on the swinging leg and the measured
// joints on the other, dq = 0, kp on the swing leg, kd on all six.  There
// is no plant step: the robot is on the wire.
//
// Unlike the batched tick kernels, the session's packet carries the
// odometry's quaternion, and controller.tick rotates by it
// (rot.quat_to_rot), so the base rotation here is the quaternion's too
// (TrigQuat); the roll, pitch and yaw (the host's quat_to_rpy) feed the
// MPC's x0 and the anchor's yaw, as there.
//
// Layout: one block a scenario (the session launches B = 1).  The solve
// form is the MPC core's block (64 threads, its shared memory at horizon N
// plus the tick scratch); the held form is one warp.  In both, lanes 0-8
// of warp 0 take the nine angles' sines and cosines at once
// (tick_trig_warp), then thread 0 runs the prologue, the IK and the
// command.  Horizon 1 to 85 steps; solve_form "inv" takes the factor
// inverse up to n = 64, as walking_tick.cu.
//
// The batched kernels' objects do not change: this file only calls the
// shared headers' device functions.
#include "tick_common.cuh"

namespace mpc {

// Mirrored on the Python side by a ctypes.Structure (4-byte fields only).
struct SessionParams {
  TickParams tick;
  float vdes[3];   // cfg.desired_velocity
  float wdes;      // cfg.desired_yaw_rate
  float kp, kd;    // the command's gains
  int anchor;      // the held form writes the next anchor into the packet
  int inv;         // solve_form = "inv"
};

}  // namespace mpc

namespace {

using mpc::SessionParams;

constexpr int NU = 3;
constexpr int NT = mpc::Dim<NU>::NT;

// The session's packet (control/session.py, float offsets): joints q, the
// truth odometry (pos, rpy, quat, v_pos, v_ori), the iteration, the
// reference anchor, the held force; a row of the solve form's input is
// the first SOLVE_IN floats.
constexpr int PK_Q = 0;
constexpr int PK_POS = 18;
constexpr int PK_ORI = 21;
constexpr int PK_QUAT = 24;
constexpr int PK_VPOS = 28;
constexpr int PK_VORI = 31;
constexpr int PK_IT = 46;
constexpr int PK_ANCHOR = 47;
constexpr int PK_SOLVE_IN = 50;
constexpr int PK_GRF = 50;
constexpr int PK_PACKET = 56;
// the outputs: the command [q dq tau kp kd], then (solve form) the next
// anchor and the force (L, R)
constexpr int OUT_CMD = 30;
constexpr int OUT_ANCHOR = 30;
constexpr int OUT_GRF = 33;
constexpr int OUT_WARM = 39;
// srbd.initial_state's gravity state
constexpr float G_STATE = -9.81f;

// tick scratch (floats): after the MPC layout in the solve form, alone in
// the held form
constexpr int TK_LS = 0;       // left swing flag (1 / 0)
constexpr int TK_TNOW = 1;     // iteration * dt
constexpr int TK_ARML = 2;     // arm_l [3]
constexpr int TK_ARMR = 5;     // arm_r [3]
constexpr int TK_SWQ = 8;      // swing_q [3]
constexpr int TK_TRIG = 16;    // [18] cosines, then sines (tick_trig_warp)
constexpr int TK_SIZE = 40;

// The prologue's rotation from the packet's quaternion (x, y, z, w), as
// rot.quat_to_rot; the legs' trig from tick_trig_warp's array.
struct TrigQuat {
  const float* quat;
  const float* t;
  __device__ __forceinline__ void rot(float R[3][3]) const {
    const float x = quat[0], y = quat[1], z = quat[2], w = quat[3];
    const float s = 2.0f / fmaxf(x * x + y * y + z * z + w * w, 1e-12f);
    const float xx = s * x * x, yy = s * y * y, zz = s * z * z;
    const float xy = s * x * y, xz = s * x * z, yz = s * y * z;
    const float wx = s * w * x, wy = s * w * y, wz = s * w * z;
    R[0][0] = 1.0f - (yy + zz); R[0][1] = xy - wz; R[0][2] = xz + wy;
    R[1][0] = xy + wz; R[1][1] = 1.0f - (xx + zz); R[1][2] = yz - wx;
    R[2][0] = xz - wy; R[2][1] = yz + wx; R[2][2] = 1.0f - (xx + yy);
  }
  __device__ __forceinline__ LegTrig leg(int side) const {
    return TrigShared{t}.leg(side);
  }
};

// The command of controller.tick's walking branch (controller.py, "pack
// the command") into cmd [q dq tau kp kd]: the stance leg's torque
// tau = -J_st' (R' f_st) with J_st its contact Jacobian
// (kin.contact_jacobian's closed form), the swing IK on the swinging leg
// and the measured joints on the stance leg, dq = 0, kp on the swing leg,
// kd on all six.  ls: the left leg swings; f_st: the stance foot's world
// force.
__device__ void walking_command(const SessionParams& S, const Leg& g,
                                const TrigQuat& trig, bool ls,
                                const float* q6, const float* swq,
                                const float* f_st, float* cmd) {
  float R[3][3], fb[3];
  trig.rot(R);
  mtv(R, f_st, fb);
  const LegTrig t = trig.leg(ls ? 1 : 0);
  const float mir = ls ? -1.0f : 1.0f;
  const float a1 = t.c1 * g.kx + t.s1 * g.kz, b1 = -t.s1 * g.kx + t.c1 * g.kz;
  const float a2 = t.c12 * g.fx + t.s12 * g.fz;
  const float b2 = -t.s12 * g.fx + t.c12 * g.fz;
  const float uy = (g.hy + g.ky + g.fy) * mir;
  const float uz = g.hz + b1 + b2;
  // J's columns: d p / d q0, q1, q2
  const float J[3][3] = {{0.0f, -t.s0 * uy - t.c0 * uz, t.c0 * uy - t.s0 * uz},
                         {b1 + b2, t.s0 * (a1 + a2), -t.c0 * (a1 + a2)},
                         {b2, t.s0 * a2, -t.c0 * a2}};
  const int st = ls ? 3 : 0, sw = ls ? 0 : 3;
  for (int k = 0; k < 3; ++k) {
    cmd[st + k] = q6[st + k];
    cmd[sw + k] = swq[k];
    cmd[6 + k] = 0.0f;
    cmd[9 + k] = 0.0f;
    cmd[12 + st + k] = -(J[k][0] * fb[0] + J[k][1] * fb[1] + J[k][2] * fb[2]);
    cmd[12 + sw + k] = 0.0f;
    cmd[18 + sw + k] = S.kp;
    cmd[18 + st + k] = 0.0f;
    cmd[24 + k] = S.kd;
    cmd[27 + k] = S.kd;
  }
}

// SOLVE: the warm solve tick (a block of NT threads); else the held-force
// tick (one warp).  INV, RPL: the MPC core's factor inverse and solve rows
// a lane (walking_tick.cu).
template <bool SOLVE, bool INV, int RPL>
__global__ void __launch_bounds__(NT)
walking_session_kernel(const __grid_constant__ SessionParams S,
                       const float* __restrict__ in_all, float* packet_all,
                       float* z_all, float* y_all,
                       float* __restrict__ out_all) {
  extern __shared__ float sm[];
  const TickParams& T = S.tick;
  const mpc::MpcParams& P = T.mpc;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, N, -1, INV);
  float* tk = SOLVE ? sm + L.total : sm;
  const float* in = SOLVE ? in_all + (size_t)b * PK_SOLVE_IN
                          : packet_all + (size_t)b * PK_PACKET;
  float* out = out_all + (size_t)b * (SOLVE ? OUT_WARM : OUT_CMD);
  const float* q6 = in + PK_Q;
  const float* ori = in + PK_ORI;
  const Leg g = load_leg(T);
  const TrigQuat trig{in + PK_QUAT, tk + TK_TRIG};

  // ---- the nine angles' sines and cosines, lanes 0-8 (the rpy's are
  // computed beside the legs' and not used: the rotation is the quat's)
  if (tid < 32) tick_trig_warp(tid, ori, q6, tk + TK_TRIG);
  __syncwarp();

  // ---- prologue (one thread): gait, FK, anchor, placement, swing IK ---
  float anc_next[3], tgt[3];
  Pre o;
  if (tid == 0) {
    // without an anchor band controller.tick tracks the measured pose
    // (x, y, yaw), whatever the yaw band
    const float* pos = in + PK_POS;
    const bool band = T.anchor_band > 0.0f;
    const float anc[3] = {band ? in[PK_ANCHOR] : pos[0],
                          band ? in[PK_ANCHOR + 1] : pos[1],
                          band ? in[PK_ANCHOR + 2] : ori[2]};
    tick_prologue_t(T, g, ori, pos, in + PK_VPOS, S.vdes, S.wdes, anc,
                    in[PK_IT], true, trig, anc_next, tgt, o);
    ik_leg(g, o.next_b, o.ls ? q6 : q6 + 3, o.ls ? 1.0f : -1.0f, o.swq);
  }

  if constexpr (!SOLVE) {
    // the held force belongs to the foot in stance now
    if (tid == 0) {
      const float* gh = in + PK_GRF;
      const float f_st[3] = {gh[0] + gh[3], gh[1] + gh[4], gh[2] + gh[5]};
      walking_command(S, g, trig, o.ls, q6, o.swq, f_st, out);
      if (S.anchor)
        for (int i = 0; i < 3; ++i) packet_all[(size_t)b * PK_PACKET
                                               + PK_ANCHOR + i] = anc_next[i];
    }
    return;
  } else {
    float* aux = sm + L.aux;
    if (tid == 0) {
      // the MPC's inputs: x0 = [rpy, pos, v_ori, v_pos, g], the clipped
      // anchor, the commands; the moment arms' two candidates
      for (int i = 0; i < 3; ++i) {
        sm[L.x0 + i] = ori[i];
        sm[L.x0 + 3 + i] = in[PK_POS + i];
        sm[L.x0 + 6 + i] = in[PK_VORI + i];
        sm[L.x0 + 9 + i] = in[PK_VPOS + i];
        aux[mpc::AUX_VDES + i] = S.vdes[i];
        aux[mpc::AUX_ANC + i] = o.anc[i];
        out[OUT_ANCHOR + i] = anc_next[i];
      }
      sm[L.x0 + 12] = G_STATE;
      aux[mpc::AUX_WDES] = S.wdes;
      tk[TK_LS] = o.ls ? 1.0f : 0.0f;
      tk[TK_TNOW] = o.t_now;
      for (int i = 0; i < 3; ++i) {
        // a standing foot pushes from where it is; the swinging foot
        // re-enters stance at its placement target
        tk[TK_ARML + i] = o.ls ? o.target[i] : o.p_l_w[i];
        tk[TK_ARMR + i] = o.ls ? o.p_r_w[i] : o.target[i];
        tk[TK_SWQ + i] = o.swq[i];
      }
    }
    __syncthreads();

    // ---- contact schedule + moment arms over the horizon --------------
    for (int k = tid; k < N; k += NT) {
      const float tk_k = __fadd_rn(tk[TK_TNOW], __fmul_rn((float)k, P.ts));
      const bool left_stance = !(pos_mod(tk_k, T.cycle) < T.swing_t);
      const float* arm = tk + (left_stance ? TK_ARML : TK_ARMR);
      for (int i = 0; i < 3; ++i) sm[L.arms + 3 * k + i] = arm[i];
    }
    __syncthreads();

    // ---- the prep-fused MPC solve, warm from (z, y), which it has read
    // before its last barrier: the new state goes back in place ---------
    float* z = z_all + (size_t)b * n;
    float* y = y_all + (size_t)b * m;
    mpc::mpc_prep_solve<NU, INV, RPL>(P, sm, L, N, z, y);
    for (int c = tid; c < n; c += NT) z[c] = sm[L.z + c];
    for (int r = tid; r < m; r += NT) y[r] = sm[L.y + r];

    // ---- the force on the foot in stance now, and the command ---------
    if (tid == 0) {
      const bool ls = tk[TK_LS] > 0.5f;
      const float* u0 = sm + L.z;
      for (int i = 0; i < 3; ++i) {
        out[OUT_GRF + i] = ls ? 0.0f : u0[i];
        out[OUT_GRF + 3 + i] = ls ? u0[i] : 0.0f;
      }
      walking_command(S, g, trig, ls, q6, tk + TK_SWQ, u0, out);
    }
  }
}

// dynamic shared memory of a form: the MPC layout and the tick scratch
// (solve), the tick scratch alone (held)
__host__ __device__ inline int session_smem_floats(int N, bool solve,
                                                   bool inv) {
  return solve ? mpc::smem_layout<NU>(N, N, -1, inv).total + TK_SIZE
               : TK_SIZE;
}

// the solving kernel for horizon N (walking_tick.cu's solve_kernel)
auto session_solve_kernel(int N, bool inv) {
  if (mpc::use_inv(inv, NU * N)) return walking_session_kernel<true, true, 2>;
  switch (mpc::rpl<NU>(N)) {
    case 2: return walking_session_kernel<true, false, 2>;
    case 4: return walking_session_kernel<true, false, 4>;
    default: return walking_session_kernel<true, false, 8>;
  }
}

int launch_session(const SessionParams* prm, bool solve, const void* in,
                   void* packet, void* z, void* y, void* out, int B,
                   void* stream) {
  if (B <= 0) return 0;
  const int N = prm->tick.mpc.N;
  if (N < 1 || N > mpc::Dim<NU>::MAX_N) return (int)cudaErrorInvalidValue;
  const bool inv = prm->inv != 0;
  const int bytes = (int)(session_smem_floats(N, solve, inv) * sizeof(float));
  const auto kernel = solve ? session_solve_kernel(N, inv)
                            : walking_session_kernel<false, false, 2>;
  if (solve) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, solve ? NT : 32, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)in, (float*)packet, (float*)z, (float*)y,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int walking_session_params_bytes() {
  return (int)sizeof(SessionParams);
}

// solve_in [B][SOLVE_IN], z [B][3N] and y [B][6N] in place, out [B][39]
extern "C" int walking_session_tick(const SessionParams* prm,
                                    const void* solve_in, void* z, void* y,
                                    void* out, int B, void* stream) {
  return launch_session(prm, true, solve_in, nullptr, z, y, out, B, stream);
}

// packet [B][PACKET] (the next anchor written into it), out [B][30]
extern "C" int walking_session_tick_hold(const SessionParams* prm,
                                         void* packet, void* out, int B,
                                         void* stream) {
  return launch_session(prm, false, nullptr, packet, nullptr, nullptr, out, B,
                        stream);
}
