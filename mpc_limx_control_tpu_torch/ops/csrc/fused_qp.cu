// fused_qp: the generic fused condensation + warm ADMM of the stance GRF
// QP, one scenario per block.
//
// Replaces mpc_limx_control_tpu/ops/mpc_fused_pallas.py:_mpc_kernel (:355;
// pallas_call at :716 via fused_walking_qp :644 and make_admm_fused :1001):
// from GIVEN dynamics Ad [13, 13], Bd_k [13, nu] per horizon step, reference
// rows x_ref [N + 1, 13], x0 and the warm (z, y) it condenses the QP in
// band form, factors K = H + rho G'G + reg I and runs the warm ADMM
// (mpc_core.cuh), for nu = 3 (one foot per step, `fused_qp_nu3`) and
// nu = 6 (two feet per step, `fused_qp_nu6`).  Ad is any matrix: every
// product with it is dense (the AdDense policy of the core), as the TPU
// kernel runs its core without the SRBD closed forms; nothing is assumed
// about Bd_k either (the caller's contact-schedule gating is in it).
//
// Bound on this card: latency, as the other kernels of the core (n pivot
// steps with block barriers, 12 n warp-shuffle substitution steps).  The
// dense Ad costs 13 multiply-adds where the closed form costs 1-3, in the
// Gramian recursion (N x 169 elements) and the band emission's Ad' t
// (169 per row and step): at nu = 6, ~0.5 M of the block's ~1.6 M flops.
// Shared memory at N = 20: ~36 KB (nu = 3), ~55 KB (nu = 6, packed K, all
// N Bd blocks).
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "mpc_core.cuh"

namespace {

// after the core's layout (floats): Ad [13][13], then x_ref [N + 1][13]
constexpr int AD_SIZE = 176;

template <int NU>
__host__ __device__ inline int qp_smem_floats(int N) {
  return mpc::smem_layout<NU>(N, N).total + AD_SIZE + (N + 1) * mpc::NX;
}

template <int NU>
__global__ void __launch_bounds__(mpc::Dim<NU>::NT)
fused_qp_kernel(const __grid_constant__ mpc::MpcParams P,
                const float* __restrict__ Ad, const float* __restrict__ Bd_t,
                const float* __restrict__ x_ref, const float* __restrict__ x0,
                const float* __restrict__ z_warm,
                const float* __restrict__ y_warm, float* __restrict__ z_out,
                float* __restrict__ y_out, float* __restrict__ res_out) {
  constexpr int NT = mpc::Dim<NU>::NT, NX = mpc::NX;
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = mpc::smem_layout<NU>(N, N);
  float* ad_s = sm + L.total;
  float* xr_s = ad_s + AD_SIZE;

  for (int i = tid; i < NX * NX; i += NT)
    ad_s[i] = Ad[(size_t)b * NX * NX + i];
  for (int i = tid; i < N * NX * NU; i += NT)
    sm[L.Bd + i] = Bd_t[(size_t)b * N * NX * NU + i];
  for (int i = tid; i < (N + 1) * NX; i += NT)
    xr_s[i] = x_ref[(size_t)b * (N + 1) * NX + i];
  for (int i = tid; i < NX; i += NT) sm[L.x0 + i] = x0[b * NX + i];
  __syncthreads();

  const mpc::AdDense ad{ad_s};
  const mpc::RefGiven ref{xr_s};
  mpc::mpc_condense_solve<NU>(P, sm, L, ad, ref, NX * NU,
                              z_warm + (size_t)b * n, y_warm + (size_t)b * m);

  for (int c = tid; c < n; c += NT) z_out[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) y_out[(size_t)b * m + r] = sm[L.y + r];
  if (tid == 0) res_out[b] = sm[L.aux + mpc::AUX_RES];
}

template <int NU>
int launch(const mpc::MpcParams* prm, const void* Ad, const void* Bd_t,
           const void* x_ref, const void* x0, const void* z_warm,
           const void* y_warm, void* z_out, void* y_out, void* res_out,
           int B, void* stream) {
  if (B <= 0) return 0;
  const int bytes = (int)(qp_smem_floats<NU>(prm->N) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fused_qp_kernel<NU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  fused_qp_kernel<NU><<<B, mpc::Dim<NU>::NT, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)Ad, (const float*)Bd_t, (const float*)x_ref,
      (const float*)x0, (const float*)z_warm, (const float*)y_warm,
      (float*)z_out, (float*)y_out, (float*)res_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_qp_nu3_smem_bytes(int N) {
  return (int)(qp_smem_floats<3>(N) * sizeof(float));
}

extern "C" int fused_qp_nu6_smem_bytes(int N) {
  return (int)(qp_smem_floats<6>(N) * sizeof(float));
}

extern "C" int fused_qp_nu3(const mpc::MpcParams* prm, const void* Ad,
                            const void* Bd_t, const void* x_ref,
                            const void* x0, const void* z_warm,
                            const void* y_warm, void* z_out, void* y_out,
                            void* res_out, int B, void* stream) {
  return launch<3>(prm, Ad, Bd_t, x_ref, x0, z_warm, y_warm, z_out, y_out,
                   res_out, B, stream);
}

extern "C" int fused_qp_nu6(const mpc::MpcParams* prm, const void* Ad,
                            const void* Bd_t, const void* x_ref,
                            const void* x0, const void* z_warm,
                            const void* y_warm, void* z_out, void* y_out,
                            void* res_out, int B, void* stream) {
  return launch<6>(prm, Ad, Bd_t, x_ref, x0, z_warm, y_warm, z_out, y_out,
                   res_out, B, stream);
}
