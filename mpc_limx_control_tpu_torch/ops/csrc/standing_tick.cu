// standing_tick: one whole closed-loop standing-balance tick.
//
// Replaces mpc_limx_control_tpu/ops/tick_fused_pallas.py:_tick_kernel
// (:130; pallas_call at :868) with stand=True, in the four forms its
// est_kf / hold flags give, each its own C entry point:
//
//   standing_tick          truth odometry, the two-foot MPC solve
//   standing_tick_kf       the 12-state Kalman filter in the kernel
//   standing_tick_hold     the dtMPC held-force tick, no MPC
//   standing_tick_kf_hold  both
//
// A standing tick is: gait clock and placement target (reported, not
// used: no leg swings), both-leg FK (tick_prologue); the two-foot nu = 6
// MPC of mpc_core.cuh with both feet in stance over the whole horizon --
// one step-invariant Bd [13, 6] from the pair of FK feet, the reference
// anchored at the feet's midpoint in xy and the measured yaw -- or,
// holding, the given force pair as it is; the exact-ZOH SRBD plant step
// with both forces, both feet pinned and both legs re-solved by IK
// (stand_epilogue).  In the KF forms both feet are in contact for the
// filter; its posterior position and velocity drive the FK feet and the
// MPC's x0, the plant steps from the truth (as in walking_tick.cu).
//
// Bound on this card: latency.  n = 6 N = 120 decision variables at
// N = 20: 120 barrier-separated Cholesky pivot steps (n^3 / 3 = 576k
// flops shared by 128 threads) and 12 substitution sweeps of 120
// warp-shuffle steps, four rows per lane.  One block of 128 threads per
// scenario; K is stored as a packed lower triangle and Bd once, so the
// block's ~47 KB of shared memory lets four scenarios share an SM.  The
// hold forms run no MPC: one thread (truth) or one warp (KF) per scenario.
#include "tick_common.cuh"

namespace {

constexpr int NU = 6;
constexpr int NT = mpc::Dim<NU>::NT;

// ---- the solving forms: one block of NT threads per scenario ------------
template <bool KF>
__global__ void __launch_bounds__(NT)
standing_tick_kernel(const __grid_constant__ TickParams T,
                     const __grid_constant__ TickIO io) {
  extern __shared__ float sm[];
  const mpc::MpcParams& P = T.mpc;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, 1);
  float* aux = sm + L.aux;
  const Leg g = load_leg(T);
  const float* xi = io.xi + b * mpc::NX;
  const float* q6 = io.q + b * 6;
  const float it = io.it[b];

  // ---- the Kalman filter (KF forms): warp 0, scratch in the K area ----
  const float* pos = xi + 3;
  const float* vel = xi + 9;
  float xn[6];
  if constexpr (KF) {
    float* w = sm + L.K;
    if (tid < 32) {
      kf_tick(T, g, tid, false, true, xi, q6, io.pv + b * 3, io.pq + b * 6,
              io.kx + b * 12, io.kp + b * 144, w, io.kx_o + b * 12,
              io.kp_o + b * 144);
      for (int i = 0; i < 6; ++i) xn[i] = w[KW_XN + i];
    }
    pos = xn;
    vel = xn + 3;
  }

  // ---- prologue (one thread): gait, FK, anchor, placement --------------
  if (tid == 0) {
    const float* vdes = io.vdes + b * 3;
    Pre o;
    tick_prologue(T, g, xi, pos, vel, q6, vdes, io.wdes[b], io.anc + b * 3,
                  it, false, io.anc_o + b * 3, io.tgt_o + b * 3, o);
    // stage the MPC inputs: the controller's odometry, both feet as the
    // horizon's moment arms, the reference anchored over the support
    for (int i = 0; i < mpc::NX; ++i) sm[L.x0 + i] = xi[i];
    for (int i = 0; i < 3; ++i) {
      sm[L.x0 + 3 + i] = pos[i];
      sm[L.x0 + 9 + i] = vel[i];
      sm[L.arms + i] = o.p_l_w[i];
      sm[L.arms + 3 + i] = o.p_r_w[i];
      aux[mpc::AUX_VDES + i] = vdes[i];
    }
    aux[mpc::AUX_ANC] = 0.5f * (o.p_l_w[0] + o.p_r_w[0]);
    aux[mpc::AUX_ANC + 1] = 0.5f * (o.p_l_w[1] + o.p_r_w[1]);
    aux[mpc::AUX_ANC + 2] = xi[2];
    aux[mpc::AUX_WDES] = io.wdes[b];
  }
  __syncthreads();

  // ---- the prep-fused two-foot MPC solve ------------------------------
  mpc::mpc_prep_solve<NU>(P, sm, L, 1, io.zw + (size_t)b * n,
                          io.yw + (size_t)b * m);

  for (int c = tid; c < n; c += NT) io.z_o[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) io.y_o[(size_t)b * m + r] = sm[L.y + r];

  // ---- epilogue (one thread): both forces, plant step, both legs' IK --
  if (tid == 0) {
    const float* u0 = sm + L.z;
    io.res_o[b] = aux[mpc::AUX_RES];
    stand_epilogue(T, g, xi, q6, io.fl + b * 3, io.fr + b * 3, u0, u0 + 3,
                   io.xi_o + b * mpc::NX, io.q_o + b * 6, io.fl_o + b * 3,
                   io.fr_o + b * 3, io.grf_o + b * 6);
  }
}

// ---- the held-force forms: no MPC ----------------------------------------
// The force pair is applied as given (no stance-foot reassignment: both
// feet stand); z / y pass through in the wrapper, the residual is 0.
__device__ void stand_hold_tick(const TickParams& T, const Leg& g,
                                const TickIO& io, int b, const float* pos,
                                const float* vel) {
  const float* xi = io.xi + b * mpc::NX;
  const float* q6 = io.q + b * 6;
  Pre o;
  tick_prologue(T, g, xi, pos, vel, q6, io.vdes + b * 3, io.wdes[b],
                io.anc + b * 3, io.it[b], false, io.anc_o + b * 3,
                io.tgt_o + b * 3, o);
  const float* gh = io.grf + b * 6;
  io.res_o[b] = 0.0f;
  stand_epilogue(T, g, xi, q6, io.fl + b * 3, io.fr + b * 3, gh, gh + 3,
                 io.xi_o + b * mpc::NX, io.q_o + b * 6, io.fl_o + b * 3,
                 io.fr_o + b * 3, io.grf_o + b * 6);
}

template <bool KF>
__global__ void __launch_bounds__(HOLD_NT)
standing_tick_hold_kernel(const __grid_constant__ TickParams T,
                          const __grid_constant__ TickIO io, int B) {
  const Leg g = load_leg(T);
  if constexpr (!KF) {
    const int b = blockIdx.x * HOLD_NT + threadIdx.x;
    if (b >= B) return;
    const float* xi = io.xi + b * mpc::NX;
    stand_hold_tick(T, g, io, b, xi + 3, xi + 9);
  } else {
    __shared__ float scratch[HOLD_KF_WARPS][KW_SIZE];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x * HOLD_KF_WARPS + warp;
    if (b >= B) return;   // the whole warp, so its __syncwarp()s stay full
    float* w = scratch[warp];
    kf_tick(T, g, lane, false, true, io.xi + b * mpc::NX, io.q + b * 6,
            io.pv + b * 3, io.pq + b * 6, io.kx + b * 12, io.kp + b * 144, w,
            io.kx_o + b * 12, io.kp_o + b * 144);
    if (lane == 0) stand_hold_tick(T, g, io, b, w + KW_XN, w + KW_XN + 3);
  }
}

// dynamic shared memory of the solving forms: the MPC layout with one Bd,
// and room for the filter's scratch from the K area at any N
__host__ __device__ inline int solve_smem_floats(int N, bool kf) {
  const mpc::Smem L = mpc::smem_layout<NU>(N, 1);
  return (kf && L.K + KW_SIZE > L.total) ? L.K + KW_SIZE : L.total;
}

template <bool KF>
int launch_solve(const TickParams* prm, const TickIO& io, int B,
                 void* stream) {
  if (B <= 0) return 0;
  const int bytes = (int)(solve_smem_floats(prm->mpc.N, KF) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      standing_tick_kernel<KF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  standing_tick_kernel<KF><<<B, NT, bytes, (cudaStream_t)stream>>>(*prm, io);
  return (int)cudaGetLastError();
}

template <bool KF>
int launch_hold(const TickParams* prm, const TickIO& io, int B,
                void* stream) {
  if (B <= 0) return 0;
  const int per_block = KF ? HOLD_KF_WARPS : HOLD_NT;
  standing_tick_hold_kernel<KF>
      <<<(B + per_block - 1) / per_block, HOLD_NT, 0, (cudaStream_t)stream>>>(
          *prm, io, B);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory per block of the solving forms (the hold forms
// use none)
extern "C" int standing_tick_smem_bytes(int N) {
  return (int)(solve_smem_floats(N, false) * sizeof(float));
}

extern "C" int standing_tick_kf_smem_bytes(int N) {
  return (int)(solve_smem_floats(N, true) * sizeof(float));
}

// the C entry points (pointer order in tick_common.cuh)
TICK_ENTRY_SOLVE(standing_tick, launch_solve<false>)
TICK_ENTRY_KF(standing_tick_kf, launch_solve<true>)
TICK_ENTRY_HOLD(standing_tick_hold, launch_hold<false>)
TICK_ENTRY_KF_HOLD(standing_tick_kf_hold, launch_hold<true>)
