// pdip_fused: the whole fixed-iteration primal-dual interior-point solve of
// a batch of dense QPs in one kernel, one block per QP.
//
//     min_z 1/2 z'Hz + f'z   s.t.   G z <= h
//
// Replaces mpc_limx_control_tpu/ops/qp_pallas.py:pdip_fused (pallas_call
// :206 -> _pdip_kernel :54 -> _pdip_body :84).  Inputs H [B,n,n], f [B,n],
// G [B,m,n], h / s0 / lam0 [B,m], z0 [B,n], float32; outputs z_best [B,n],
// merit_best [B], z_final [B,n], lam_final [B,m].  Constants eps = 1e-8,
// d_cap = 1e7, reg = 1e-6 (qp_pallas.py:172).  Each of the `iters`
// Mehrotra steps, in _pdip_body's order: the residuals, d = min(lam /
// max(s, eps), d_cap), M = H + G' diag(d) G + reg I, the Cholesky of M
// (pivot clamp 1e-30), an affine and a corrector direction (a G' mat-vec,
// both sweeps and a G mat-vec each), fraction-to-boundary steps, sigma =
// (mu_aff / max(mu, eps))^3, the damped step 0.99 alpha with s and lam
// clamped at eps, the merit max|r_dual| / (1 + max|f|) + max(r_prim+) +
// mu / mu0 and a strict `merit < merit_best` best-iterate pick.  The TPU
// wrapper pads n to a multiple of 8 and B to one of 128 (Mosaic tiling);
// the padded coordinates stay exactly zero, so this kernel takes any n and
// B >= 1 unpadded and computes the same function.
//
// Design.  G, M and every vector live in dynamic shared memory for the
// whole solve; G is loaded once.  H does not fit beside them at the
// standing width (n = 120, m = 240: G 116,160 + H 58,080 + M 58,080 bytes
// with odd strides already pass the 232,448 a block can opt in to), so H
// stays in device memory and is read through the read-only path twice a
// Newton step (H z and the formation of M); a block's H is 57.6 KB, and
// the ~132 resident blocks' H (7.6 MB) stay in the 50 MB L2.  M has an
// odd leading dimension and is factored by the K8 device functions of
// chol_common.cuh; only its lower triangle is formed (the factorization
// and both sweeps read nothing else).  Mat-vecs: a warp per row with a
// shuffle sum (H z, G z), a thread per column (G' v).  Max, min and sum
// over a block are per-thread strided partials, a fixed xor-shuffle tree
// and the warps' partials combined in warp order: deterministic.  Max and
// min propagate NaN (as jnp.max / torch.amax do): a NaN merit is never
// "better".  The two sweeps run in warp 0 (one right-hand side).
//
// What bounds it on this card: operations.  The formation of G' diag(d) G
// costs m n (n + 1) operations a step (3.5 MFLOP at n = 120, m = 240), the
// factorization n^3 / 3, the rest O(m n); the inputs are read once (H about
// twice a step, from L2).  The serial chain of a block (the factorization's
// n pivots with one barrier each plus one per 8-column panel, whose
// trailing update is spread over the block in register tiles; 4 n
// dependent shuffle steps of the sweeps, ~15 block reductions per step)
// sets the latency.  20 Newton steps at B = 4096 on an H100 (700 W,
// tools/time_chol_kernels.py): 20.4 ms walking (n / m = 60 / 120, four
// blocks an SM), 169 ms standing (120 / 240, one); PERF.md section 6.
//
// Limits: n <= 256 (eight rows per lane in a sweep) and the shared memory
// of pdip_fused_smem_bytes within 232448 bytes; the Python wrapper raises
// beyond.  Plain C interface for ctypes; the entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "chol_common.cuh"

// Host and device share this layout; ops/qp_cuda.py mirrors it.
struct PdipParams {
  int n;      // variables
  int m;      // inequality rows
  int iters;  // Newton steps
};

namespace {

constexpr int PDIP_NT = 256;        // threads per block
constexpr float EPS = 1e-8f;        // slack / multiplier floor
constexpr float D_CAP = 1e7f;       // cap on lam / s
constexpr float REG = 1e-6f;        // added to M's diagonal
constexpr int N_VEC = 5;            // n-vectors in shared memory
constexpr int M_VEC = 13;           // m-vectors in shared memory
constexpr int RED = 32;             // reduction scratch (one per warp)

// NaN-propagating max / min (fmaxf / fminf drop a NaN)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

enum Op { SUM, MAX, MIN };

template <int OP>
__device__ __forceinline__ float comb(float a, float b) {
  if constexpr (OP == SUM) return a + b;
  else if constexpr (OP == MAX) return nmax(a, b);
  else return nmin(a, b);
}

// Block reduction of each thread's partial v; every thread returns the
// same value (the warps' results combined in warp order).
template <int OP>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = comb<OP>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = comb<OP>(r, red[w]);
  __syncthreads();
  return r;
}

// Row-wise mat-vec, a warp per row: out(i, (A x)_i) for i < rows, called
// on lane 0 of the row's warp.  A row-major with leading dimension lda
// (global when GLOBAL: read through the read-only path).
template <bool GLOBAL, typename Out>
__device__ __forceinline__ void mv_rows(const float* A, int lda,
                                        const float* x, int rows, int cols,
                                        Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nw) {
    float acc = 0.0f;
    for (int j = lane; j < cols; j += 32) {
      if constexpr (GLOBAL) acc += __ldg(A + (size_t)i * lda + j) * x[j];
      else acc += A[i * lda + j] * x[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out(i, acc);
  }
}

// (G' v)_j for j < n, a thread per column (G in shared memory, [m][ld]).
__device__ __forceinline__ float mtv_col(const float* G, int ld, int m,
                                         const float* v, int j) {
  float acc = 0.0f;
  for (int k = 0; k < m; ++k) acc += G[k * ld + j] * v[k];
  return acc;
}

// Largest step in (0, 1] keeping v + a dv >= 0, over two (v, dv) pairs:
// min(1, min_k -v_k / dv_k over dv_k < 0).
__device__ float max_step2(const float* v1, const float* d1, const float* v2,
                           const float* d2, int m, float* red) {
  float part = INFINITY;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    part = nmin(part, d1[k] < 0.0f ? -v1[k] / d1[k] : INFINITY);
    part = nmin(part, d2[k] < 0.0f ? -v2[k] / d2[k] : INFINITY);
  }
  return nmin(1.0f, block_reduce<MIN>(part, red));
}

// n <= 64 (RPL <= 2): at most 64 registers a thread, so that the four
// blocks whose shared memory fits an SM at n / m = 60 / 120 are resident
// (the factorization's register tiles took it to 123 and two blocks: 30.2
// ms against 20.4 at B = 4096, tools/time_chol_kernels.py, H100)
template <int RPL>
__global__ void __launch_bounds__(PDIP_NT, RPL <= 2 ? 4 : 1)
pdip_kernel(const float* __restrict__ Hg, const float* __restrict__ fg,
            const float* __restrict__ Gg, const float* __restrict__ hg,
            const float* __restrict__ z0g, const float* __restrict__ s0g,
            const float* __restrict__ lam0g, float* __restrict__ zb_out,
            float* __restrict__ merit_out, float* __restrict__ zf_out,
            float* __restrict__ lamf_out, int n, int m, int iters) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int ld = odd(n);
  const size_t b = blockIdx.x;
  const float* Hb = Hg + b * n * n;

  float* G = sm;                    // [m][ld]
  float* M = G + m * ld;            // [n][ld], lower triangle, then L
  float* dg = M + n * ld;
  float* dginv = dg + n;
  float* f = dginv + n;             // n-vectors
  float* z = f + n;
  float* zb = z + n;
  float* rd = zb + n;               // r_dual = H z + f + G' lam
  float* w = rd + n;                // right-hand side, then dz
  float* h = w + n;                 // m-vectors
  float* s = h + m;
  float* lam = s + m;
  float* gz = lam + m;              // G z
  float* rp = gz + m;               // r_prim = G z + s - h
  float* sf = rp + m;               // max(s, eps)
  float* d = sf + m;                // min(lam / sf, d_cap)
  float* rc = d + m;                // complementarity right-hand side
  float* wv = rc + m;               // (rc - lam rp) / sf
  float* dsa = wv + m;              // affine direction
  float* dla = dsa + m;
  float* ds = dla + m;              // corrector direction
  float* dl = ds + m;
  float* red = dl + m;              // [RED]

  {
    const float* Gb = Gg + b * m * n;
    for (int k = warp; k < m; k += nw)
      for (int j = lane; j < n; j += 32) G[k * ld + j] = Gb[k * n + j];
    for (int j = tid; j < n; j += nt) {
      f[j] = fg[b * n + j];
      z[j] = z0g[b * n + j];
      zb[j] = z[j];
    }
    for (int k = tid; k < m; k += nt) {
      h[k] = hg[b * m + k];
      s[k] = s0g[b * m + k];
      lam[k] = lam0g[b * m + k];
    }
  }
  __syncthreads();

  float part = -INFINITY;
  for (int j = tid; j < n; j += nt) part = nmax(part, fabsf(f[j]));
  const float f_scale = 1.0f + block_reduce<MAX>(part, red);
  const float mf = (float)m;

  // rd, gz and the merit of the current (z, s, lam); returns the merit
  // and leaves mu = sum(s lam) / m in *mu
  auto residuals = [&](float* mu) {
    mv_rows<true>(Hb, n, z, n, n, [&](int i, float hz) {
      rd[i] = hz + f[i];
    });
    mv_rows<false>(G, ld, z, m, n, [&](int k, float v) { gz[k] = v; });
    __syncthreads();
    for (int j = tid; j < n; j += nt) rd[j] += mtv_col(G, ld, m, lam, j);
    __syncthreads();
    float p_sum = 0.0f, p_prim = -INFINITY, p_dual = -INFINITY;
    for (int k = tid; k < m; k += nt) {
      p_sum += s[k] * lam[k];
      p_prim = nmax(p_prim, nmax(gz[k] - h[k], 0.0f));
    }
    for (int j = tid; j < n; j += nt) p_dual = nmax(p_dual, fabsf(rd[j]));
    *mu = block_reduce<SUM>(p_sum, red) / mf;
    const float prim = block_reduce<MAX>(p_prim, red);
    const float dual = block_reduce<MAX>(p_dual, red);
    return dual / f_scale + prim;
  };

  // one direction for the complementarity right-hand side rc: dz into w,
  // ds_out = -rp - G dz, dl_out = -(rc + lam ds) / sf
  auto direction = [&](float* ds_out, float* dl_out) {
    for (int k = tid; k < m; k += nt)
      wv[k] = (rc[k] - lam[k] * rp[k]) / sf[k];
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      w[j] = -rd[j] + mtv_col(G, ld, m, wv, j);
    __syncthreads();
    if (warp == 0) {
      float bv[RPL];
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = lane + 32 * q;
        bv[q] = r < n ? w[r] : 0.0f;
      }
      float dv[RPL];
      load_dinv<RPL>(dginv, n, lane, dv);
      sweep_forward<ROWS, RPL>(M, dv, n, ld, lane, bv);
      sweep_backward<ROWS, RPL>(M, dv, n, ld, lane, bv);
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = lane + 32 * q;
        if (r < n) w[r] = bv[q];
      }
    }
    __syncthreads();
    mv_rows<false>(G, ld, w, m, n, [&](int k, float gdz) {
      const float dsk = -rp[k] - gdz;
      ds_out[k] = dsk;
      dl_out[k] = -(rc[k] + lam[k] * dsk) / sf[k];
    });
    __syncthreads();
  };

  float mu;
  float merit_best = residuals(&mu);
  const float mu0 = mu;
  merit_best += mu / mu0;
  const int tri = n * (n + 1) / 2;

  for (int it = 0; it < iters; ++it) {
    // rd, gz and mu hold the current iterate's (computed with its merit)
    for (int k = tid; k < m; k += nt) {
      rp[k] = gz[k] + s[k] - h[k];
      sf[k] = nmax(s[k], EPS);
      d[k] = nmin(lam[k] / sf[k], D_CAP);
      rc[k] = s[k] * lam[k];
    }
    __syncthreads();
    // lower triangle of M = H + G' diag(d) G + reg I, entry e = i(i+1)/2 + j
    for (int e = tid; e < tri; e += nt) {
      int i = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int j = e - i * (i + 1) / 2;
      float acc = 0.0f;
      for (int k = 0; k < m; ++k) acc += (G[k * ld + i] * d[k]) * G[k * ld + j];
      float v = __ldg(Hb + (size_t)i * n + j) + acc;
      if (i == j) v += REG;
      M[i * ld + j] = v;
    }
    __syncthreads();
    factor<ROWS>(M, dg, dginv, n, n, ld);

    direction(dsa, dla);                                  // affine
    const float a_aff = max_step2(s, dsa, lam, dla, m, red);
    float p = 0.0f;
    for (int k = tid; k < m; k += nt)
      p += (s[k] + a_aff * dsa[k]) * (lam[k] + a_aff * dla[k]);
    const float mu_aff = block_reduce<SUM>(p, red) / mf;
    const float ratio = mu_aff / nmax(mu, EPS);
    const float sigma = ratio * ratio * ratio;
    for (int k = tid; k < m; k += nt)
      rc[k] = s[k] * lam[k] - sigma * mu + dsa[k] * dla[k];
    __syncthreads();
    direction(ds, dl);                                    // corrector
    const float alpha = 0.99f * max_step2(s, ds, lam, dl, m, red);
    for (int j = tid; j < n; j += nt) z[j] = z[j] + alpha * w[j];
    for (int k = tid; k < m; k += nt) {
      s[k] = nmax(s[k] + alpha * ds[k], EPS);
      lam[k] = nmax(lam[k] + alpha * dl[k], EPS);
    }
    __syncthreads();
    const float merit = residuals(&mu) + mu / mu0;
    if (merit < merit_best) {          // uniform: every thread holds merit
      merit_best = merit;
      for (int j = tid; j < n; j += nt) zb[j] = z[j];
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    zb_out[b * n + j] = zb[j];
    zf_out[b * n + j] = z[j];
  }
  for (int k = tid; k < m; k += nt) lamf_out[b * m + k] = lam[k];
  if (tid == 0) merit_out[b] = merit_best;
}

using PdipFn = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, float*, float*, float*, float*, int,
                        int, int);

// The instantiation whose rows per lane (1, 2, 4 or 8) cover n; nullptr
// beyond n = 256.
PdipFn pdip_fn(int n) {
  const int rpl = (n + 31) / 32;
  if (rpl <= 1) return pdip_kernel<1>;
  if (rpl <= 2) return pdip_kernel<2>;
  if (rpl <= 4) return pdip_kernel<4>;
  if (rpl <= MAX_RPL) return pdip_kernel<8>;
  return nullptr;
}

}  // namespace

extern "C" int pdip_params_bytes() { return (int)sizeof(PdipParams); }

// dynamic shared memory per block: G and M with odd strides, the factor's
// diagonal and its reciprocal, the vectors and the reduction scratch
extern "C" int pdip_fused_smem_bytes(int n, int m) {
  return (int)(sizeof(float)
               * ((size_t)m * odd(n) + (size_t)n * odd(n) + 2 * n
                  + N_VEC * n + M_VEC * m + RED));
}

extern "C" int pdip_fused(const PdipParams* prm, const void* H, const void* f,
                          const void* G, const void* h, const void* z0,
                          const void* s0, const void* lam0, void* z_best,
                          void* merit, void* z_final, void* lam_final, int B,
                          void* stream) {
  const int n = prm->n, m = prm->m;
  if (B <= 0) return 0;
  PdipFn fn = n >= 1 && m >= 1 && prm->iters >= 0 ? pdip_fn(n) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = pdip_fused_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, PDIP_NT, bytes, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)f, (const float*)G, (const float*)h,
      (const float*)z0, (const float*)s0, (const float*)lam0,
      (float*)z_best, (float*)merit, (float*)z_final, (float*)lam_final, n, m,
      prm->iters);
  return (int)cudaGetLastError();
}
