// walking_mpc_prep: the prep-fused walking GRF MPC, one scenario per block.
//
// Replaces mpc_limx_control_tpu/ops/mpc_fused_pallas.py:_mpc_kernel_prep
// (:374; pallas_call at :839 via fused_walking_qp_prep :769 and
// make_walking_fused :894): from (x0, arms, v_des, yaw_rate, warm z / y,
// anchor) it linearizes the SRBD in-kernel, condenses the level-attitude
// walking QP, factors it and runs the warm ADMM (mpc_core.cuh).
//
// Bound on this card: the sequential pivot and substitution steps (~60
// barrier-separated Cholesky steps + 12 x 60 warp-shuffle substitution
// steps per solve), i.e. latency per scenario; the design answers with one
// small block per scenario so that several scenarios share each SM, and
// with warp-only synchronization in the substitutions.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "mpc_core.cuh"

namespace {

constexpr int NU = 3;
constexpr int NT = mpc::Dim<NU>::NT;

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
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, N);
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

  mpc::mpc_prep_solve<NU>(P, sm, L, N, z_warm + (size_t)b * n,
                          y_warm + (size_t)b * m);

  for (int c = tid; c < n; c += NT) z_out[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) y_out[(size_t)b * m + r] = sm[L.y + r];
  if (tid < mpc::NX) xp_out[b * mpc::NX + tid] = aux[mpc::AUX_XP + tid];
  if (tid == 0) res_out[b] = aux[mpc::AUX_RES];
}

}  // namespace

extern "C" int walking_mpc_prep_smem_bytes(int N) {
  return (int)(mpc::smem_layout<NU>(N, N).total * sizeof(float));
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
  if (B <= 0) return 0;
  const int bytes = walking_mpc_prep_smem_bytes(prm->N);
  cudaError_t err = cudaFuncSetAttribute(
      walking_mpc_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  walking_mpc_prep_kernel<<<B, NT, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)x0, (const float*)arms, (const float*)v_des,
      (const float*)yaw_rate, (const float*)z_warm, (const float*)y_warm,
      (const float*)anchor, (float*)z_out, (float*)y_out, (float*)res_out,
      (float*)xp_out);
  return (int)cudaGetLastError();
}

extern "C" const char* mpc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
