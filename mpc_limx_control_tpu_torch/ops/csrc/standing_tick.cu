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
//   standing_tick_inv, standing_tick_kf_inv
//                          the two solving forms with solve_form = "inv"
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
// N = 20: the panel Cholesky of chol_common.cuh (n + n / 8 barrier-
// separated steps, n^3 / 3 = 576k flops shared by 128 threads) and 12
// substitution sweeps of 120 warp-shuffle steps, four rows per lane
// (eight past N = 21; the horizon goes to 42, n <= 256).  One block of 128
// threads per scenario; K is stored as a packed lower triangle, Bd once
// and, instead of the N Gramians, only S_k = W_k Bd_k, so the block's
// 37.5 KB of shared memory at N = 20 lets six scenarios share an SM.  The
// hold forms run no MPC: a half warp per scenario (hold_tick of
// tick_common.cuh, the two legs' IKs at once; the KF forms kf_tick first).
// The "inv" forms take the factor inverse where n = 6 N <= 64 (N <= 10) and
// the substitution kernels beyond, as the TPU kernel does
// (mpc_fused_pallas.py:249).
#include "tick_common.cuh"

namespace {

constexpr int NU = 6;
constexpr int NT = mpc::Dim<NU>::NT;

// ---- the solving forms: one block of NT threads per scenario ------------
// INV: the MPC core's solve_form = "inv" (mpc_core.cuh, n <= 64 only);
// RPL: its solve rows per lane, mpc::rpl<6>(N)
template <bool KF, bool INV, int RPL>
__global__ void __launch_bounds__(NT)
standing_tick_kernel(const __grid_constant__ TickParams T,
                     const __grid_constant__ TickIO io) {
  extern __shared__ float sm[];
  const mpc::MpcParams& P = T.mpc;
  const int b = blockIdx.x, tid = threadIdx.x;
  MPC_STAGE(mpc::ST_START);
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, 1, -1, INV);
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
      kf_tick_smem(T, g, tid, false, true, xi, q6, io.pv + b * 3,
                   io.pq + b * 6, io.kx + b * 12, io.kp + b * 144, w,
                   io.kx_o + b * 12, io.kp_o + b * 144);
      for (int i = 0; i < 6; ++i) xn[i] = w[KWS_XN + i];
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
  MPC_STAGE(mpc::ST_PRE);

  // ---- the prep-fused two-foot MPC solve ------------------------------
  mpc::mpc_prep_solve<NU, INV, RPL>(P, sm, L, 1, io.zw + (size_t)b * n,
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
  MPC_STAGE(mpc::ST_END);
}

// ---- the held-force forms: no MPC ----------------------------------------
// A half warp per scenario, eight a block (tick_common.cuh
// hold_kernel_body).  The force pair is applied as given (no stance-foot
// reassignment: both feet stand); z / y pass through in the wrapper, the
// residual is 0.
template <bool KF>
__global__ void __launch_bounds__(HOLD_NT, HOLD_MIN_BLOCKS)
standing_tick_hold_kernel(const __grid_constant__ TickParams T,
                          const __grid_constant__ TickIO io, int B) {
  hold_kernel_body<true, KF>(T, io, B);
}

// dynamic shared memory of the solving forms: the MPC layout with one Bd
// (with the factor inverse where an "inv" form takes it), and room for the
// filter's scratch from the K area at any N
__host__ __device__ inline int solve_smem_floats(int N, bool kf, bool inv) {
  const mpc::Smem L = mpc::smem_layout<NU>(N, 1, -1, inv);
  return (kf && L.K + KWS_SIZE > L.total) ? L.K + KWS_SIZE : L.total;
}

// the solving kernel for horizon N: the factor-inverse instantiation where
// an "inv" form takes it (n <= 64), else the sweeps with four solve rows
// per lane up to N = 21, eight beyond
template <bool KF>
auto solve_kernel(int N, bool inv) {
  if (mpc::use_inv(inv, NU * N)) return standing_tick_kernel<KF, true, 4>;
  return mpc::rpl<NU>(N) == 4 ? standing_tick_kernel<KF, false, 4>
                               : standing_tick_kernel<KF, false, 8>;
}

template <bool KF, bool INV = false>
int launch_solve(const TickParams* prm, const TickIO& io, int B,
                 void* stream) {
  if (B <= 0) return 0;
  if (prm->mpc.N < 1 || prm->mpc.N > mpc::Dim<NU>::MAX_N)
    return (int)cudaErrorInvalidValue;
  const int bytes =
      (int)(solve_smem_floats(prm->mpc.N, KF, INV) * sizeof(float));
  const auto kernel = solve_kernel<KF>(prm->mpc.N, INV);
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
  standing_tick_hold_kernel<KF><<<(B + HOLD_PER_BLOCK - 1) / HOLD_PER_BLOCK,
                                  HOLD_NT, 0, (cudaStream_t)stream>>>(
      *prm, io, B);
  return (int)cudaGetLastError();
}

}  // namespace

MPC_STAGE_READER(standing_tick_stage_clocks)

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
SOLVE_SIZERS(standing_tick, false, false)
SOLVE_SIZERS(standing_tick_kf, true, false)
SOLVE_SIZERS(standing_tick_inv, false, true)
SOLVE_SIZERS(standing_tick_kf_inv, true, true)
// the blocks of a held-force form an SM holds (no dynamic shared memory)
extern "C" int standing_tick_hold_blocks_per_sm() {
  return mpc::blocks_per_sm(standing_tick_hold_kernel<false>, HOLD_NT, 0);
}
extern "C" int standing_tick_kf_hold_blocks_per_sm() {
  return mpc::blocks_per_sm(standing_tick_hold_kernel<true>, HOLD_NT, 0);
}

// the C entry points (pointer order in tick_common.cuh)
TICK_ENTRY_SOLVE(standing_tick, launch_solve<false>)
TICK_ENTRY_KF(standing_tick_kf, launch_solve<true>)
TICK_ENTRY_HOLD(standing_tick_hold, launch_hold<false>)
TICK_ENTRY_KF_HOLD(standing_tick_kf_hold, launch_hold<true>)
// the solving forms with solve_form = "inv" (the hold forms run no solve)
TICK_ENTRY_SOLVE(standing_tick_inv, (launch_solve<false, true>))
TICK_ENTRY_KF(standing_tick_kf_inv, (launch_solve<true, true>))
