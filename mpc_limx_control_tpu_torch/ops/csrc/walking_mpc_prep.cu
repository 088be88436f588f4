// walking_mpc_prep: the prep-fused walking GRF MPC, one scenario per block.
//
// Replaces mpc_limx_control_tpu/ops/mpc_fused_pallas.py:_mpc_kernel_prep
// (:374; pallas_call at :839 via fused_walking_qp_prep :769 and
// make_walking_fused :894): from (x0, arms, v_des, yaw_rate, warm z / y,
// anchor) it linearizes the SRBD in-kernel, condenses the level-attitude
// walking QP, factors it and runs the warm ADMM (mpc_core.cuh).
//
// Bound on this card: the sequential pivot and substitution steps (~70
// barrier-separated Cholesky steps + 12 x 60 warp-shuffle substitution
// steps per solve at N = 20), i.e. latency per scenario; the design answers
// with one small block per scenario (64 threads, ~15.4 KB of shared memory
// at N = 20) so that many scenarios share each SM, and with warp-only
// synchronization in the substitutions.  Horizon 1 to 85 steps (n = 3 N
// <= 256); the "inv" entry takes the factor inverse up to n = 64 and the
// substitution kernel beyond, as the TPU kernel does.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "mpc_core.cuh"

namespace {

constexpr int NU = 3;
constexpr int NT = mpc::Dim<NU>::NT;

// INV: the core's factor inverse (n <= 64 only); RPL: its solve rows a
// lane, mpc::rpl<3>(N)
template <bool INV, int RPL>
__global__ void __launch_bounds__(NT)
walking_mpc_prep_kernel(const __grid_constant__ mpc::MpcParams P,
                        const float* __restrict__ x0,
                        const float* __restrict__ arms,
                        const float* __restrict__ v_des,
                        const float* __restrict__ yaw_rate,
                        const float* __restrict__ z_warm,
                        const float* __restrict__ y_warm,
                        const float* __restrict__ anchor,
                        float* __restrict__ z_out,
                        float* __restrict__ y_out,
                        float* __restrict__ res_out,
                        float* __restrict__ xp_out) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  MPC_STAGE(mpc::ST_START);
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, N, -1, INV);
  float* aux = sm + L.aux;

  for (int i = tid; i < mpc::NX; i += NT)
    sm[L.x0 + i] = x0[b * mpc::NX + i];
  for (int i = tid; i < 3 * N; i += NT)
    sm[L.arms + i] = arms[b * 3 * N + i];
  if (tid < 3) {
    aux[mpc::AUX_VDES + tid] = v_des[b * 3 + tid];
    aux[mpc::AUX_ANC + tid] = anchor[b * 3 + tid];
  }
  if (tid == 0) aux[mpc::AUX_WDES] = yaw_rate[b];
  __syncthreads();
  MPC_STAGE(mpc::ST_PRE);

  mpc::mpc_prep_solve<NU, INV, RPL>(P, sm, L, N, z_warm + (size_t)b * n,
                                    y_warm + (size_t)b * m);

  for (int c = tid; c < n; c += NT) z_out[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) y_out[(size_t)b * m + r] = sm[L.y + r];
  if (tid < mpc::NX) xp_out[b * mpc::NX + tid] = aux[mpc::AUX_XP + tid];
  if (tid == 0) res_out[b] = aux[mpc::AUX_RES];
  MPC_STAGE(mpc::ST_END);
}

__host__ __device__ inline int smem_floats(int N, bool inv) {
  return mpc::smem_layout<NU>(N, N, -1, inv).total;
}

// the kernel for horizon N: the factor-inverse instantiation where the
// "inv" entry takes it (n <= 64), else the sweeps with mpc::rpl<3>(N)
// solve rows a lane
auto prep_kernel(int N, bool inv) {
  if (mpc::use_inv(inv, NU * N)) return walking_mpc_prep_kernel<true, 2>;
  switch (mpc::rpl<NU>(N)) {
    case 2: return walking_mpc_prep_kernel<false, 2>;
    case 4: return walking_mpc_prep_kernel<false, 4>;
    default: return walking_mpc_prep_kernel<false, 8>;
  }
}

template <bool INV>
int launch(const mpc::MpcParams* prm, const void* x0, const void* arms,
           const void* v_des, const void* yaw_rate, const void* z_warm,
           const void* y_warm, const void* anchor, void* z_out, void* y_out,
           void* res_out, void* xp_out, int B, void* stream) {
  if (B <= 0) return 0;
  if (prm->N < 1 || prm->N > mpc::Dim<NU>::MAX_N)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)(smem_floats(prm->N, INV) * sizeof(float));
  const auto kernel = prep_kernel(prm->N, INV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)x0, (const float*)arms, (const float*)v_des,
      (const float*)yaw_rate, (const float*)z_warm, (const float*)y_warm,
      (const float*)anchor, (float*)z_out, (float*)y_out, (float*)res_out,
      (float*)xp_out);
  return (int)cudaGetLastError();
}

}  // namespace

MPC_STAGE_READER(walking_mpc_prep_stage_clocks)

// dynamic shared memory per block, and the blocks an SM holds, at
// horizon N
extern "C" int walking_mpc_prep_smem_bytes(int N) {
  return (int)(smem_floats(N, false) * sizeof(float));
}

extern "C" int walking_mpc_prep_inv_smem_bytes(int N) {
  return (int)(smem_floats(N, true) * sizeof(float));
}

extern "C" int walking_mpc_prep_blocks_per_sm(int N) {
  return mpc::blocks_per_sm(prep_kernel(N, false), NT,
                            walking_mpc_prep_smem_bytes(N));
}

extern "C" int walking_mpc_prep_inv_blocks_per_sm(int N) {
  return mpc::blocks_per_sm(prep_kernel(N, true), NT,
                            walking_mpc_prep_inv_smem_bytes(N));
}

extern "C" int walking_mpc_params_bytes() {
  return (int)sizeof(mpc::MpcParams);
}

extern "C" int walking_mpc_prep(const mpc::MpcParams* prm, const void* x0,
                                const void* arms, const void* v_des,
                                const void* yaw_rate, const void* z_warm,
                                const void* y_warm, const void* anchor,
                                void* z_out, void* y_out, void* res_out,
                                void* xp_out, int B, void* stream) {
  return launch<false>(prm, x0, arms, v_des, yaw_rate, z_warm, y_warm, anchor,
                       z_out, y_out, res_out, xp_out, B, stream);
}

// solve_form = "inv": the factor inverse instead of the sweeps
extern "C" int walking_mpc_prep_inv(const mpc::MpcParams* prm, const void* x0,
                                    const void* arms, const void* v_des,
                                    const void* yaw_rate, const void* z_warm,
                                    const void* y_warm, const void* anchor,
                                    void* z_out, void* y_out, void* res_out,
                                    void* xp_out, int B, void* stream) {
  return launch<true>(prm, x0, arms, v_des, yaw_rate, z_warm, y_warm, anchor,
                      z_out, y_out, res_out, xp_out, B, stream);
}

extern "C" const char* mpc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
