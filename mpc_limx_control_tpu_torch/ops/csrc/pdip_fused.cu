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
// Design.  M and every vector live in dynamic shared memory for the whole
// solve.  M is the packed lower triangle of chol_common.cuh (row i at
// i (i + 1) / 2: 29 KB at n = 120, half a square panel), formed in place
// and factored there by the K8 device functions (factor<PACKED>, the
// sweeps); nothing reads above its diagonal.  The formation is a
// register-tiled SYRK: a thread owns 4 x 4 tiles of the lower block
// triangle (enumerated row-tile by row-tile, walked by subtraction, no
// index recovery) and for each of the m rows of G loads four G[k][i] and
// four G[k][j] (two 16-byte loads and d[k]) for 16 fused multiply-adds.
// Every element keeps the chain of one entry a thread: t = G[k][i] d[k]
// rounded, acc = fma(t, G[k][j], acc) for k = 0 .. m - 1, then H[i][j] +
// acc (+ reg on the diagonal), so M is the element-wise formation's bit for
// bit.  H stays in device memory and is read through the read-only path
// (H z and the formation).  Mat-vecs: a warp per row with a shuffle sum
// (H z, G z; four rows a warp at once, all their loads before the first
// multiply-add), a thread per column (G' v).  Max, min and sum over a
// block are per-thread strided partials, a fixed xor-shuffle tree and the
// warps' partials combined in warp order: deterministic.  Max and min
// propagate NaN (as jnp.max / torch.amax do): a NaN merit is never
// "better".  The two sweeps run in warp 0 (one right-hand side).
//
// Where G lives (Shape): for n <= 64 in shared memory, loaded once, rows
// padded to a multiple of four floats; 128 threads and five blocks an SM
// on the walking QP (n / m = 60 / 120: 44,168 bytes).  Beyond, G alone
// (115 KB at the standing width, 120 / 240) would hold a block alone on
// its SM, where the factorization's and the sweeps' latency is all there
// is: so G stays in device memory, the formation streams it through two
// 16-row chunk buffers (cp.async, the next chunk in flight) and the
// mat-vecs read it from L2 (G' v 32 loads ahead of its chain); 60,368
// bytes and 256 threads a block, two blocks an SM at 128 registers (the
// two blocks' G and H, ~46 MB, stay in the 50 MB L2).
//
// What bounds it on this card: operations.  The formation of G' diag(d) G
// costs m n (n + 1) operations a step (3.5 MFLOP at n = 120, m = 240), the
// factorization n^3 / 3, the rest O(m n); the inputs are read once (G and
// H several times a step, from L2).  The serial chain of a block (the
// factorization's n pivots with one barrier each plus one per 8-column
// panel, whose trailing update is spread over the block in register
// tiles; 4 n dependent shuffle steps of the sweeps, ~15 block reductions
// per step) sets the latency, hidden by the blocks an SM holds; PERF.md
// section 6 has the times and the stage split (tools/time_chol_kernels.py
// --stages).

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

constexpr float EPS = 1e-8f;        // slack / multiplier floor
constexpr float D_CAP = 1e7f;       // cap on lam / s
constexpr float REG = 1e-6f;        // added to M's diagonal
constexpr int N_VEC = 5;            // n-vectors in shared memory
constexpr int M_VEC = 13;           // m-vectors in shared memory
constexpr int RED = 32;             // reduction scratch (one per warp)

// ---- stage clocks, compiled in only for a timing build ---------------------
// A build that defines MPC_STAGE_CLOCKS (tools/time_chol_kernels.py --stages;
// ops/_build.py's normal build never does) sums thread 0's clock64() time of
// each stage over the Newton steps, per block b < PDIP_STAGE_MAX_B;
// pdip_fused_stage_clocks copies the [PDIP_STAGE_MAX_B][PDIP_SLOTS] int64
// sums to the host.  The stages: the loads and the first merit, then per
// step the right-hand sides (rp, d, rc), the formation of M, the
// factorization, the affine direction with sigma, the corrector direction,
// the step and the merit with the pick, and the outputs; slot PS_TOTAL is
// kernel start to end.
constexpr int PDIP_STAGE_MAX_B = 4096;
constexpr int PDIP_SLOTS = 16;
enum PdipStage { PS_LOAD, PS_PREP, PS_FORM, PS_FACTOR, PS_AFFINE,
                 PS_CORRECTOR, PS_STEP, PS_MERIT, PS_END, PS_TOTAL };

#ifdef MPC_STAGE_CLOCKS
__device__ long long g_pdip_clock[PDIP_STAGE_MAX_B * PDIP_SLOTS];

struct StageClock {
  long long sum[PS_TOTAL] = {}, start = 0, prev = 0;
  __device__ StageClock() {
    if (threadIdx.x == 0) start = prev = clock64();
  }
  __device__ void mark(int stage) {
    if (threadIdx.x != 0) return;
    const long long t = clock64();
    sum[stage] += t - prev;
    prev = t;
  }
  __device__ void store() {
    if (threadIdx.x != 0 || blockIdx.x >= PDIP_STAGE_MAX_B) return;
    long long* out = g_pdip_clock + (size_t)blockIdx.x * PDIP_SLOTS;
    for (int s = 0; s < PS_TOTAL; ++s) out[s] = sum[s];
    out[PS_TOTAL] = prev - start;
  }
};
#else
struct StageClock {
  __device__ void mark(int) {}
  __device__ void store() {}
};
#endif

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
// on lane 0 of the row's warp; cols <= 32 RPL.  A row-major with leading
// dimension lda (global when GLOBAL: read through the read-only path).  A
// warp takes MV_ROWS rows at once and loads all their elements before the
// first multiply-add, so that one memory round trip serves them; each row
// keeps its chain (lane-strided fused multiply-adds, then the xor tree).
constexpr int MV_ROWS = 4;

template <int RPL, bool GLOBAL, typename Out>
__device__ __forceinline__ void mv_rows(const float* A, int lda,
                                        const float* x, int rows, int cols,
                                        Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float xv[RPL];
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int j = lane + 32 * s;
    xv[s] = j < cols ? x[j] : 0.0f;
  }
  for (int i0 = MV_ROWS * warp; i0 < rows; i0 += MV_ROWS * nw) {
    float a[MV_ROWS][RPL];
#pragma unroll
    for (int u = 0; u < MV_ROWS; ++u)
#pragma unroll
      for (int s = 0; s < RPL; ++s) {
        const int i = i0 + u, j = lane + 32 * s;
        const float* e = A + (size_t)i * lda + j;
        a[u][s] = i < rows && j < cols ? (GLOBAL ? __ldg(e) : *e) : 0.0f;
      }
    float acc[MV_ROWS];
#pragma unroll
    for (int u = 0; u < MV_ROWS; ++u) {
      acc[u] = 0.0f;
#pragma unroll
      for (int s = 0; s < RPL; ++s)
        if (lane + 32 * s < cols) acc[u] += a[u][s] * xv[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < MV_ROWS; ++u)
        if (i0 + u < rows) out(i0 + u, acc[u]);
  }
}

// (G' v)_j for j < n, a thread per column: G [m][ld] in shared memory, or
// in device memory when GLOBAL (MTV_BATCH loads in flight ahead of their
// fused multiply-adds, which stay in k order).
constexpr int MTV_BATCH = 32;

template <bool GLOBAL>
__device__ __forceinline__ float mtv_col(const float* G, int ld, int m,
                                         const float* v, int j) {
  float acc = 0.0f;
  if constexpr (GLOBAL) {
    for (int k = 0; k < m; k += MTV_BATCH) {
      float g[MTV_BATCH];
#pragma unroll
      for (int u = 0; u < MTV_BATCH; ++u)
        g[u] = k + u < m ? __ldg(G + (size_t)(k + u) * ld + j) : 0.0f;
#pragma unroll
      for (int u = 0; u < MTV_BATCH; ++u)
        if (k + u < m) acc += g[u] * v[k + u];
    }
  } else {
    for (int k = 0; k < m; ++k) acc += G[k * ld + j] * v[k];
  }
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

// The block's shape by width.  n <= 64 (RPL <= 2): G in shared memory, 128
// threads, and the five blocks whose shared memory fits an SM at n / m =
// 60 / 120 (so at most 96 registers a thread: uncapped, the
// factorization's register tiles once took 123 and halved the resident
// blocks).  Beyond: G streamed from device memory (L2) through two chunk
// buffers of KC rows, 256 threads, two blocks an SM (128 registers; two
// blocks of 384 or 512 threads, capped at 80 or 64 registers, spilled and
// took 90.5 and 87.5 ms against 86.4 at B = 4096, PERF.md section 6),
// each thread holding TMAX tiles of M at once (one pass of G forms the
// 465 tiles of n = 120).
template <int RPL>
struct Shape {
  static constexpr bool G_SHARED = RPL <= 2;
  static constexpr int NT = RPL <= 2 ? 128 : 256;
  static constexpr int MIN_BLOCKS = RPL <= 2 ? 5 : 2;
};

constexpr int KC = 16;    // rows of G a chunk buffer holds (G streamed)
constexpr int TMAX = 2;   // tiles of M a thread holds at once (G streamed)

__host__ __device__ inline bool g_shared(int n) { return n <= 64; }

__host__ __device__ inline int g_stride(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int tile_count(int n) {
  const int nt4 = (n + 3) >> 2;
  return nt4 * (nt4 + 1) / 2;
}

// Tile t + step of the lower block triangle from tile t = (a, b), b <= a,
// numbered row-tile by row-tile (t = a (a + 1) / 2 + b).
__device__ __forceinline__ void next_tile(int& a, int& b, int step) {
  b += step;
  while (b > a) {
    b -= a + 1;
    ++a;
  }
}

// Row k's term of a 4 x 4 tile: x = G[k][i0..], y = G[k][j0..].
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], float4 x,
                                         float4 y, float dk) {
  const float r[4] = {__fmul_rn(x.x, dk), __fmul_rn(x.y, dk),
                      __fmul_rn(x.z, dk), __fmul_rn(x.w, dk)};
  const float c[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(r[u], c[v], acc[u][v]);
}

// M[i][j] = H[i][j] + acc (+ reg on the diagonal) for the tile's elements
// on or below the diagonal, into the packed panel.
__device__ __forceinline__ void tile_store(float* M, const float* Hb, int n,
                                           int i0, int j0,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + u, j = j0 + v;
      if (i < n && j <= i) {
        float e = __ldg(Hb + (size_t)i * n + j) + acc[u][v];
        if (i == j) e += REG;
        M[at<PACKED>(i, j, 0)] = e;
      }
    }
}

// The lower triangle of M = H + G' diag(d) G + reg I into the packed panel,
// a 4 x 4 register tile of M at a time (see the design note: each element
// keeps the one-entry chain of fused multiply-adds over k in order).  The
// thread's first tile (a0, b0) is tile threadIdx.x.
__device__ __forceinline__ void form_m(float* __restrict__ M,
                                       const float* __restrict__ G,
                                       const float* __restrict__ d,
                                       const float* __restrict__ Hb, int n,
                                       int m, int a0, int b0) {
  const int ldg = g_stride(n), nt = blockDim.x;
  const int ntile = tile_count(n);
  int a = a0, bt = b0;
  for (int t = threadIdx.x; t < ntile; t += nt, next_tile(a, bt, nt)) {
    const int i0 = 4 * a, j0 = 4 * bt;
    const float* gi = G + i0;
    const float* gj = G + j0;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < m; ++k)
      tile_fma(acc, *reinterpret_cast<const float4*>(gi + k * ldg),
               *reinterpret_cast<const float4*>(gj + k * ldg), d[k]);
    tile_store(M, Hb, n, i0, j0, acc);
  }
}

// Rows [k0, k0 + kn) of G [m][n] in device memory into a chunk buffer
// [KC][ldg], a warp per row; one cp.async group, not waited for.
__device__ __forceinline__ void load_chunk(float* buf, const float* Gb,
                                           int n, int ldg, int k0, int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int kk = warp; kk < kn; kk += nw)
    for (int j = lane; j < n; j += 32)
      cp_async4(buf + kk * ldg + j, Gb + (size_t)(k0 + kk) * n + j);
  cp_async_commit();
}

// form_m with G in device memory: the rows of G pass through two chunk
// buffers (the next chunk in flight while the block works on this one);
// each thread holds up to TMAX tiles at once, so that G passes once for
// every TMAX tiles a thread owns.  The same element chains as form_m.
__device__ void form_m_streamed(float* __restrict__ M,
                                float* __restrict__ buf,
                                const float* __restrict__ Gb,
                                const float* __restrict__ d,
                                const float* __restrict__ Hb, int n, int m,
                                int a0, int b0) {
  const int ldg = g_stride(n), nt = blockDim.x, tid = threadIdx.x;
  const int ntile = tile_count(n);
  const int nch = (m + KC - 1) / KC;
  const int rounds = (ntile + TMAX * nt - 1) / (TMAX * nt);
  int a = a0, bt = b0;
  for (int r = 0; r < rounds; ++r) {
    int i0[TMAX], j0[TMAX];
    bool live[TMAX];
#pragma unroll
    for (int q = 0; q < TMAX; ++q) {
      live[q] = tid + (r * TMAX + q) * nt < ntile;
      i0[q] = 4 * a;
      j0[q] = 4 * bt;
      next_tile(a, bt, nt);
    }
    float acc[TMAX][4][4];
#pragma unroll
    for (int q = 0; q < TMAX; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[q][u][v] = 0.0f;
    load_chunk(buf, Gb, n, ldg, 0, m < KC ? m : KC);
    for (int c = 0; c < nch; ++c) {
      const int k0 = c * KC, kn = m - k0 < KC ? m - k0 : KC;
      if (c + 1 < nch) {
        const int k1 = k0 + KC;
        load_chunk(buf + ((c + 1) & 1) * KC * ldg, Gb, n, ldg, k1,
                   m - k1 < KC ? m - k1 : KC);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* B = buf + (c & 1) * KC * ldg;
#pragma unroll
      for (int q = 0; q < TMAX; ++q) {
        if (!live[q]) continue;
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk)
          tile_fma(acc[q],
                   *reinterpret_cast<const float4*>(B + kk * ldg + i0[q]),
                   *reinterpret_cast<const float4*>(B + kk * ldg + j0[q]),
                   d[k0 + kk]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < TMAX; ++q)
      if (live[q]) tile_store(M, Hb, n, i0[q], j0[q], acc[q]);
  }
}

template <int RPL>
__global__ void __launch_bounds__(Shape<RPL>::NT, Shape<RPL>::MIN_BLOCKS)
pdip_kernel(const float* __restrict__ Hg, const float* __restrict__ fg,
            const float* __restrict__ Gg, const float* __restrict__ hg,
            const float* __restrict__ z0g, const float* __restrict__ s0g,
            const float* __restrict__ lam0g, float* __restrict__ zb_out,
            float* __restrict__ merit_out, float* __restrict__ zf_out,
            float* __restrict__ lamf_out, int n, int m, int iters) {
  constexpr bool GS = Shape<RPL>::G_SHARED;
  extern __shared__ float sm[];
  StageClock clk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int ld = g_stride(n);
  const size_t b = blockIdx.x;
  const float* Hb = Hg + b * n * n;
  const float* Gb = Gg + b * m * n;

  float* G = sm;                    // GS: [m][ld]; else two [KC][ld] chunks
  float* M = G + (GS ? m : 2 * KC) * ld;   // packed lower triangle, then L
  // the G that the mat-vecs read: shared, or device memory [m][n]
  const float* Gv = GS ? G : Gb;
  const int ldv = GS ? ld : n;
  float* dg = M + n * (n + 1) / 2;
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
    // G's rows with zero padding to ld; streamed, the buffers' padding
    for (int k = warp; k < (GS ? m : 2 * KC); k += nw)
      for (int j = lane; j < ld; j += 32)
        if (GS || j >= n) G[k * ld + j] = j < n ? Gb[k * n + j] : 0.0f;
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
    mv_rows<RPL, true>(Hb, n, z, n, n, [&](int i, float hz) {
      rd[i] = hz + f[i];
    });
    mv_rows<RPL, !GS>(Gv, ldv, z, m, n, [&](int k, float v) { gz[k] = v; });
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      rd[j] += mtv_col<!GS>(Gv, ldv, m, lam, j);
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
      w[j] = -rd[j] + mtv_col<!GS>(Gv, ldv, m, wv, j);
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
      sweep_forward<PACKED, RPL>(M, dv, n, 0, lane, bv);
      sweep_backward<PACKED, RPL>(M, dv, n, 0, lane, bv);
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = lane + 32 * q;
        if (r < n) w[r] = bv[q];
      }
    }
    __syncthreads();
    mv_rows<RPL, !GS>(Gv, ldv, w, m, n, [&](int k, float gdz) {
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
  int a0 = 0, b0 = 0;                  // this thread's first tile of M
  next_tile(a0, b0, tid);
  clk.mark(PS_LOAD);

  for (int it = 0; it < iters; ++it) {
    // rd, gz and mu hold the current iterate's (computed with its merit)
    for (int k = tid; k < m; k += nt) {
      rp[k] = gz[k] + s[k] - h[k];
      sf[k] = nmax(s[k], EPS);
      d[k] = nmin(lam[k] / sf[k], D_CAP);
      rc[k] = s[k] * lam[k];
    }
    __syncthreads();
    clk.mark(PS_PREP);
    if constexpr (GS) form_m(M, G, d, Hb, n, m, a0, b0);
    else form_m_streamed(M, G, Gb, d, Hb, n, m, a0, b0);
    __syncthreads();
    clk.mark(PS_FORM);
    factor<PACKED>(M, dg, dginv, n, n, 0);
    clk.mark(PS_FACTOR);

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
    clk.mark(PS_AFFINE);
    direction(ds, dl);                                    // corrector
    clk.mark(PS_CORRECTOR);
    const float alpha = 0.99f * max_step2(s, ds, lam, dl, m, red);
    for (int j = tid; j < n; j += nt) z[j] = z[j] + alpha * w[j];
    for (int k = tid; k < m; k += nt) {
      s[k] = nmax(s[k] + alpha * ds[k], EPS);
      lam[k] = nmax(lam[k] + alpha * dl[k], EPS);
    }
    __syncthreads();
    clk.mark(PS_STEP);
    const float merit = residuals(&mu) + mu / mu0;
    if (merit < merit_best) {          // uniform: every thread holds merit
      merit_best = merit;
      for (int j = tid; j < n; j += nt) zb[j] = z[j];
    }
    clk.mark(PS_MERIT);
  }
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    zb_out[b * n + j] = zb[j];
    zf_out[b * n + j] = z[j];
  }
  for (int k = tid; k < m; k += nt) lamf_out[b * m + k] = lam[k];
  if (tid == 0) merit_out[b] = merit_best;
  clk.mark(PS_END);
  clk.store();
}

using PdipFn = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, float*, float*, float*, float*, int,
                        int, int);

struct PdipLaunch {
  PdipFn fn;
  int nt;  // threads per block
};

template <int RPL>
PdipLaunch launch_of() {
  return {pdip_kernel<RPL>, Shape<RPL>::NT};
}

// The instantiation whose rows per lane (1, 2, 4 or 8) cover n; fn nullptr
// beyond n = 256.
PdipLaunch pdip_fn(int n) {
  const int rpl = (n + 31) / 32;
  if (rpl <= 1) return launch_of<1>();
  if (rpl <= 2) return launch_of<2>();
  if (rpl <= 4) return launch_of<4>();
  if (rpl <= MAX_RPL) return launch_of<8>();
  return {nullptr, 0};
}

}  // namespace

extern "C" int pdip_params_bytes() { return (int)sizeof(PdipParams); }

#ifdef MPC_STAGE_CLOCKS
extern "C" int pdip_fused_stage_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_pdip_clock, sizeof(g_pdip_clock));
}
#endif

// dynamic shared memory per block: G (n <= 64) or its two chunk buffers,
// rows of a multiple of four floats; M's packed lower triangle, the
// factor's diagonal and its reciprocal, the vectors and the reduction
// scratch
extern "C" int pdip_fused_smem_bytes(int n, int m) {
  const size_t g_rows = g_shared(n) ? m : 2 * KC;
  return (int)(sizeof(float)
               * (g_rows * g_stride(n) + (size_t)n * (n + 1) / 2 + 2 * n
                  + N_VEC * n + M_VEC * m + RED));
}

extern "C" int pdip_fused(const PdipParams* prm, const void* H, const void* f,
                          const void* G, const void* h, const void* z0,
                          const void* s0, const void* lam0, void* z_best,
                          void* merit, void* z_final, void* lam_final, int B,
                          void* stream) {
  const int n = prm->n, m = prm->m;
  if (B <= 0) return 0;
  const PdipLaunch l = n >= 1 && m >= 1 && prm->iters >= 0
                           ? pdip_fn(n) : PdipLaunch{nullptr, 0};
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = pdip_fused_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  l.fn<<<B, l.nt, bytes, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)f, (const float*)G, (const float*)h,
      (const float*)z0, (const float*)s0, (const float*)lam0,
      (float*)z_best, (float*)merit, (float*)z_final, (float*)lam_final, n, m,
      prm->iters);
  return (int)cudaGetLastError();
}
