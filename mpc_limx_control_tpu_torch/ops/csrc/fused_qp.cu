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
// Shared memory at N = 20: ~17 KB (nu = 3), 45.2 KB (nu = 6): packed K,
// all N Bd blocks, S_k = W_k Bd_k instead of the Gramians, no arm sets.
// Horizon 1 to 85 steps at nu = 3, 1 to 42 at nu = 6 (n <= 256), the
// core's solve rows a lane chosen at launch (mpc::rpl).
// `fused_qp_nu3_inv` and `fused_qp_nu6_inv` are the solve_form = "inv"
// entries: the factor inverted once, mat-vecs per z-update, where n <= 64
// (its own packed region of shared memory; N <= 21 at nu = 3, N <= 10 at
// nu = 6), the substitution kernel beyond, as the TPU kernel does.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the call returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "mpc_core.cuh"

namespace {

// after the core's layout (floats): Ad [13][13], then x_ref [N + 1][13]
constexpr int AD_SIZE = 176;

// the core's layout for N given Bd blocks and no arm sets; inv: with the
// factor inverse where the core forms it
template <int NU>
__host__ __device__ inline mpc::Smem qp_layout(int N, bool inv) {
  return mpc::smem_layout<NU>(N, N, 0, inv);
}

template <int NU>
__host__ __device__ inline int qp_smem_floats(int N, bool inv) {
  return qp_layout<NU>(N, inv).total + AD_SIZE + (N + 1) * mpc::NX;
}

// INV: the core's factor inverse (n <= 64 only); RPL: its solve rows a
// lane, mpc::rpl<NU>(N)
template <int NU, bool INV, int RPL>
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
  MPC_STAGE(mpc::ST_START);
  const int N = P.N, n = NU * N, m = mpc::Dim<NU>::MU * N;
  const mpc::Smem L = qp_layout<NU>(N, INV);
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
  MPC_STAGE(mpc::ST_PRE);

  const mpc::AdDense ad{ad_s};
  const mpc::RefGiven ref{xr_s};
  mpc::mpc_condense_solve<NU, INV, RPL>(P, sm, L, ad, ref, NX * NU,
                                        z_warm + (size_t)b * n,
                                        y_warm + (size_t)b * m);

  for (int c = tid; c < n; c += NT) z_out[(size_t)b * n + c] = sm[L.z + c];
  for (int r = tid; r < m; r += NT) y_out[(size_t)b * m + r] = sm[L.y + r];
  if (tid == 0) res_out[b] = sm[L.aux + mpc::AUX_RES];
  MPC_STAGE(mpc::ST_END);
}

// the kernel for horizon N: the factor-inverse instantiation where an
// "inv" entry takes it (n <= 64), else the sweeps with mpc::rpl<NU>(N)
// solve rows a lane
template <int NU>
auto qp_kernel(int N, bool inv) {
  if constexpr (NU == 3) {
    if (mpc::use_inv(inv, NU * N)) return fused_qp_kernel<3, true, 2>;
    switch (mpc::rpl<NU>(N)) {
      case 2: return fused_qp_kernel<3, false, 2>;
      case 4: return fused_qp_kernel<3, false, 4>;
      default: return fused_qp_kernel<3, false, 8>;
    }
  } else {
    if (mpc::use_inv(inv, NU * N)) return fused_qp_kernel<6, true, 4>;
    return mpc::rpl<NU>(N) == 4 ? fused_qp_kernel<6, false, 4>
                                : fused_qp_kernel<6, false, 8>;
  }
}

template <int NU, bool INV = false>
int launch(const mpc::MpcParams* prm, const void* Ad, const void* Bd_t,
           const void* x_ref, const void* x0, const void* z_warm,
           const void* y_warm, void* z_out, void* y_out, void* res_out,
           int B, void* stream) {
  if (B <= 0) return 0;
  if (prm->N < 1 || prm->N > mpc::Dim<NU>::MAX_N)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)(qp_smem_floats<NU>(prm->N, INV) * sizeof(float));
  const auto kernel = qp_kernel<NU>(prm->N, INV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, mpc::Dim<NU>::NT, bytes, (cudaStream_t)stream>>>(
      *prm, (const float*)Ad, (const float*)Bd_t, (const float*)x_ref,
      (const float*)x0, (const float*)z_warm, (const float*)y_warm,
      (float*)z_out, (float*)y_out, (float*)res_out);
  return (int)cudaGetLastError();
}

}  // namespace

MPC_STAGE_READER(fused_qp_stage_clocks)

// dynamic shared memory per block, and the blocks an SM holds, at
// horizon N
#define QP_SIZERS(name, nu, inv)                                       \
  extern "C" int name##_smem_bytes(int N) {                            \
    return (int)(qp_smem_floats<nu>(N, inv) * sizeof(float));          \
  }                                                                    \
  extern "C" int name##_blocks_per_sm(int N) {                         \
    return mpc::blocks_per_sm(qp_kernel<nu>(N, inv), mpc::Dim<nu>::NT, \
                              name##_smem_bytes(N));                   \
  }
QP_SIZERS(fused_qp_nu3, 3, false)
QP_SIZERS(fused_qp_nu6, 6, false)
QP_SIZERS(fused_qp_nu3_inv, 3, true)
QP_SIZERS(fused_qp_nu6_inv, 6, true)

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

// solve_form = "inv": the factor inverse instead of the sweeps where
// n <= 64
extern "C" int fused_qp_nu3_inv(const mpc::MpcParams* prm, const void* Ad,
                                const void* Bd_t, const void* x_ref,
                                const void* x0, const void* z_warm,
                                const void* y_warm, void* z_out, void* y_out,
                                void* res_out, int B, void* stream) {
  return launch<3, true>(prm, Ad, Bd_t, x_ref, x0, z_warm, y_warm, z_out,
                         y_out, res_out, B, stream);
}

extern "C" int fused_qp_nu6_inv(const mpc::MpcParams* prm, const void* Ad,
                                const void* Bd_t, const void* x_ref,
                                const void* x0, const void* z_warm,
                                const void* y_warm, void* z_out, void* y_out,
                                void* res_out, int B, void* stream) {
  return launch<6, true>(prm, Ad, Bd_t, x_ref, x0, z_warm, y_warm, z_out,
                         y_out, res_out, B, stream);
}
