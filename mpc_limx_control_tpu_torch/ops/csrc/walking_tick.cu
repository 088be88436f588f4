// walking_tick: one whole closed-loop walking tick.
//
// Replaces mpc_limx_control_tpu/ops/tick_fused_pallas.py:_tick_kernel
// (:130; pallas_call at :868 via _fused_tick_core :737, fused_walking_tick
// :626 and make_tick_fused :911) in walk mode, in the four forms its
// est_kf / hold flags give, each its own C entry point:
//
//   walking_tick          truth odometry, MPC solve (one block/scenario)
//   walking_tick_kf       the 12-state Kalman filter in the kernel (K5)
//   walking_tick_hold     the dtMPC held-force tick, no MPC (K4)
//   walking_tick_kf_hold  both
//   walking_tick_inv, walking_tick_kf_inv
//                         the two solving forms with solve_form = "inv"
//
// A tick is: gait clock, both-leg FK, reference-anchor clip, capture-point
// placement, sinusoidal swing + analytic IK (tick_prologue); contact
// schedule and moment arms over the horizon and the prep-fused MPC
// (mpc_core.cuh) -- or, holding, the held force on the foot now in stance;
// GRF split, exact-ZOH SRBD plant step, rigid-ground clamp and the next
// tick's swing FK and stance-pinning IK (tick_epilogue).  The device
// functions are in tick_common.cuh; the standing forms of the TPU kernel
// are standing_tick.cu.
//
// Truth and estimate (the KF forms): the filter's sensors are synthesized
// from the truth (FK, closed-form Jacobian velocity + omega x r, and the
// acceleration as (v - prev_v) / dt), and its posterior base position and
// velocity drive the controller -- FK world feet, anchor clip, placement,
// swing IK frame and the MPC's x0 -- while the orientation (the IMU's) and
// the plant step stay on the truth.
//
// Bound on this card: latency.  The scalar prologue and epilogue (a few
// hundred flops and ~30 transcendentals) run on one thread; the MPC core
// in the middle is ~70 barrier-separated Cholesky steps + 12 x 60
// warp-shuffle substitution steps at N = 20.  One small block (64
// threads, ~15.5 KB of shared memory at N = 20) per scenario keeps many
// scenarios resident per SM to hide that latency.  The filter (~6k flops:
// 14 x 14 Cholesky and 13 right-hand sides) runs in warp 0 of that block
// before the prologue, in its shared-memory form (kf_tick_smem), its
// scratch in the MPC's K area, which is free until the solve.  The hold
// forms need none of the MPC's shared memory: a half warp per scenario,
// eight a block, the whole tick that half warp's dependent chain: with
// the KF the register-resident filter (kf_tick: S and its factor a row a
// lane, the 13 right-hand sides a column a lane), then, in both, the
// held-force tick spread over the lanes (hold_tick: the nine angles' sines
// and cosines at once, the two leg IKs at once), so that at B = 4096 the
// 512 blocks run as one wave (tick_common.cuh).
//
// Horizon: 1 to 85 steps (n = 3 N <= 256), the solve rows a lane of the
// core chosen at launch (mpc::rpl: 2 / 4 / 8); the "inv" forms take the
// factor inverse up to n = 64 and the substitution kernels beyond, as the
// TPU kernel does.
//
// The gait-clock times are formed with __fmul_rn / __fadd_rn so that no
// fused multiply-add changes their rounding: phase switches then land on
// the same tick as in the plain PyTorch tick (and in JAX).
#include "tick_common.cuh"

namespace {

constexpr int NU = 3;
constexpr int NT = mpc::Dim<NU>::NT;

// tick-local scratch after the MPC layout (floats)
constexpr int TK_LS = 0;       // left swing flag (1 / 0)
constexpr int TK_TNOW = 1;     // iteration * dt
constexpr int TK_ARML = 2;     // arm_l [3]
constexpr int TK_ARMR = 5;     // arm_r [3]
constexpr int TK_SWQ = 8;      // swing_q [3]
constexpr int TK_SIZE = 16;

// ---- the solving forms: one block of NT threads per scenario ------------
// INV: the MPC core's solve_form = "inv" (mpc_core.cuh, n <= 64 only);
// RPL: its solve rows a lane, mpc::rpl<3>(N)
template <bool KF, bool INV, int RPL>
__global__ void __launch_bounds__(NT)
walking_tick_kernel(const __grid_constant__ TickParams T,
                    const __grid_constant__ TickIO io) {
  extern __shared__ float sm[];
  const mpc::MpcParams& P = T.mpc;
  const int b = blockIdx.x, tid = threadIdx.x;
  MPC_STAGE(mpc::ST_START);
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, N, -1, INV);
  float* aux = sm + L.aux;
  float* tk = sm + L.total;
  const Leg g = load_leg(T);
  const float* xi = io.xi + b * mpc::NX;
  const float* q6 = io.q + b * 6;
  const float it = io.it[b];

  // ---- the Kalman filter (KF forms): warp 0, scratch in the K area ----
  // (the launch sizes shared memory to hold it at any N)
  const float* pos = xi + 3;
  const float* vel = xi + 9;
  float xn[6];
  if constexpr (KF) {
    float* w = sm + L.K;
    if (tid < 32) {
      kf_tick_smem(T, g, tid, left_swing(T, it), false, xi, q6,
                   io.pv + b * 3, io.pq + b * 6, io.kx + b * 12,
                   io.kp + b * 144, w, io.kx_o + b * 12, io.kp_o + b * 144);
      // into registers: the prologue's staging may overwrite the scratch
      for (int i = 0; i < 6; ++i) xn[i] = w[KWS_XN + i];
    }
    pos = xn;
    vel = xn + 3;
  }

  // ---- prologue (one thread): gait, FK, anchor, placement, swing IK ---
  if (tid == 0) {
    const float* vdes = io.vdes + b * 3;
    Pre o;
    tick_prologue(T, g, xi, pos, vel, q6, vdes, io.wdes[b], io.anc + b * 3,
                  it, true, io.anc_o + b * 3, io.tgt_o + b * 3, o);
    // stage the MPC inputs: the controller's odometry (orientation and
    // angular velocity from xi), the clipped anchor, the commands
    for (int i = 0; i < mpc::NX; ++i) sm[L.x0 + i] = xi[i];
    for (int i = 0; i < 3; ++i) {
      sm[L.x0 + 3 + i] = pos[i];
      sm[L.x0 + 9 + i] = vel[i];
      aux[mpc::AUX_VDES + i] = vdes[i];
      aux[mpc::AUX_ANC + i] = o.anc[i];
    }
    aux[mpc::AUX_WDES] = io.wdes[b];
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

  // ---- contact schedule + moment arms over the horizon ----------------
  for (int k = tid; k < N; k += NT) {
    const float tk_k = __fadd_rn(tk[TK_TNOW], __fmul_rn((float)k, P.ts));
    const bool left_stance = !(pos_mod(tk_k, T.cycle) < T.swing_t);
    const float* arm = tk + (left_stance ? TK_ARML : TK_ARMR);
    for (int i = 0; i < 3; ++i) sm[L.arms + 3 * k + i] = arm[i];
  }
  __syncthreads();
  MPC_STAGE(mpc::ST_PRE);

  // ---- the prep-fused MPC solve ---------------------------------------
  mpc::mpc_prep_solve<NU, INV, RPL>(P, sm, L, N, io.zw + (size_t)b * n,
                                    io.yw + (size_t)b * m);

  for (int c = tid; c < n; c += NT) io.z_o[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) io.y_o[(size_t)b * m + r] = sm[L.y + r];

  // ---- epilogue (one thread): GRF split, plant step, next kinematics --
  if (tid == 0) {
    const bool ls = tk[TK_LS] > 0.5f;
    const float* u0 = sm + L.z;
    io.res_o[b] = aux[mpc::AUX_RES];
    float f_l[3], f_r[3];
    for (int i = 0; i < 3; ++i) {
      f_l[i] = ls ? 0.0f : u0[i];
      f_r[i] = ls ? u0[i] : 0.0f;
    }
    tick_epilogue(T, g, xi, q6, io.fl + b * 3, io.fr + b * 3, ls, f_l, f_r,
                  tk + TK_SWQ, io.xi_o + b * mpc::NX, io.q_o + b * 6,
                  io.fl_o + b * 3, io.fr_o + b * 3, io.grf_o + b * 6);
  }
  MPC_STAGE(mpc::ST_END);
}

// ---- the held-force forms: no MPC ----------------------------------------
// A half warp per scenario, eight a block (tick_common.cuh
// hold_kernel_body): with the KF, kf_tick then hold_tick; with the truth,
// hold_tick alone.  The held force goes to the foot in stance NOW.
template <bool KF>
__global__ void __launch_bounds__(HOLD_NT, HOLD_MIN_BLOCKS)
walking_tick_hold_kernel(const __grid_constant__ TickParams T,
                         const __grid_constant__ TickIO io, int B) {
  hold_kernel_body<false, KF>(T, io, B);
}

// dynamic shared memory of the solving forms: the MPC layout (with the
// factor inverse where an "inv" form takes it), the tick scratch, and room
// for the filter's scratch from the K area at any N
__host__ __device__ inline int solve_smem_floats(int N, bool kf, bool inv) {
  const mpc::Smem L = mpc::smem_layout<NU>(N, N, -1, inv);
  const int need = L.total + TK_SIZE;
  return (kf && L.K + KWS_SIZE > need) ? L.K + KWS_SIZE : need;
}

// the solving kernel for horizon N: the factor-inverse instantiation where
// an "inv" form takes it (n <= 64), else the sweeps with mpc::rpl<3>(N)
// solve rows a lane
template <bool KF>
auto solve_kernel(int N, bool inv) {
  if (mpc::use_inv(inv, NU * N)) return walking_tick_kernel<KF, true, 2>;
  switch (mpc::rpl<NU>(N)) {
    case 2: return walking_tick_kernel<KF, false, 2>;
    case 4: return walking_tick_kernel<KF, false, 4>;
    default: return walking_tick_kernel<KF, false, 8>;
  }
}

template <bool KF, bool INV = false>
int launch_solve(const TickParams* prm, const TickIO& io, int B,
                 void* stream) {
  if (B <= 0) return 0;
  const int N = prm->mpc.N;
  if (N < 1 || N > mpc::Dim<NU>::MAX_N) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(solve_smem_floats(N, KF, INV) * sizeof(float));
  const auto kernel = solve_kernel<KF>(N, INV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT, bytes, (cudaStream_t)stream>>>(*prm, io);
  return (int)cudaGetLastError();
}

template <bool KF>
int launch_hold(const TickParams* prm, const TickIO& io, int B,
                void* stream) {
  if (B <= 0) return 0;
  walking_tick_hold_kernel<KF><<<(B + HOLD_PER_BLOCK - 1) / HOLD_PER_BLOCK,
                                 HOLD_NT, 0, (cudaStream_t)stream>>>(*prm, io,
                                                                     B);
  return (int)cudaGetLastError();
}

}  // namespace

MPC_STAGE_READER(walking_tick_stage_clocks)

// dynamic shared memory per block of the solving forms (the hold forms use
// none), and the blocks of them an SM holds, at horizon N
#define SOLVE_SIZERS(name, kf, inv)                                    \
  extern "C" int name##_smem_bytes(int N) {                            \
    return (int)(solve_smem_floats(N, kf, inv) * sizeof(float));       \
  }                                                                    \
  extern "C" int name##_blocks_per_sm(int N) {                         \
    return mpc::blocks_per_sm(solve_kernel<kf>(N, inv), NT,            \
                              name##_smem_bytes(N));                   \
  }
SOLVE_SIZERS(walking_tick, false, false)
SOLVE_SIZERS(walking_tick_kf, true, false)
SOLVE_SIZERS(walking_tick_inv, false, true)
SOLVE_SIZERS(walking_tick_kf_inv, true, true)
// the blocks of a held-force form an SM holds (no dynamic shared memory)
extern "C" int walking_tick_hold_blocks_per_sm() {
  return mpc::blocks_per_sm(walking_tick_hold_kernel<false>, HOLD_NT, 0);
}
extern "C" int walking_tick_kf_hold_blocks_per_sm() {
  return mpc::blocks_per_sm(walking_tick_hold_kernel<true>, HOLD_NT, 0);
}

extern "C" int walking_tick_params_bytes() { return (int)sizeof(TickParams); }

// the C entry points (pointer order in tick_common.cuh)
TICK_ENTRY_SOLVE(walking_tick, launch_solve<false>)
TICK_ENTRY_KF(walking_tick_kf, launch_solve<true>)
TICK_ENTRY_HOLD(walking_tick_hold, launch_hold<false>)
TICK_ENTRY_KF_HOLD(walking_tick_kf_hold, launch_hold<true>)
// the solving forms with solve_form = "inv" (the hold forms run no solve)
TICK_ENTRY_SOLVE(walking_tick_inv, (launch_solve<false, true>))
TICK_ENTRY_KF(walking_tick_kf_inv, (launch_solve<true, true>))
