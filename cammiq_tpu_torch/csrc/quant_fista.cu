// The quantification solver's FISTA chunk: n_it iterations of projected
// FISTA with the gradient restart, for a batch of S problems, one launch.
//
// Replaces the body of cammiq_tpu/models/quant.py:solve_quant's fista
// (412-428, jax.lax.fori_loop over al_grad and two projections), run by
// vmap over the 2^m subsets in solve_subsets (511-523): XLA work with no
// Pallas original.  The plain version, and the oracle, is
// kernels/quant_fista.py:fista_chunk_plain.
//
// The terms come folded (kernels/quant_fista.py:fold_terms): the
// gradient of the quadratic objective is H y - hb (H in CSR by row), the
// doubly coverage rows' sums are M y (CSR, C2 rows), and their augmented
// Lagrangian multipliers reach the gradient as R mults (CSR by genome).
// H, hb and M are float64 and the gradient and the rows' sums are taken in
// float64: near the optimum H y and hb cancel to a few digits, where the
// plain version's per-term residuals do not.  A problem's iteration is
// then O(n + nnz(H) + nnz(M) + nnz(R)) work:
//
//   mults = max(lam + rho (c2_rhs - M y), 0)
//   g     = H y - hb - R mults;  z = y - step g;  x' = P(z)
//   restart when g . (x' - x) > 0: t' = 1, y' = x'
//   else t' = (1 + sqrt(1 + 4 t^2)) / 2, y' = P(x' + (t - 1) / t' (x' - x))
//
// P projects onto the box [lb, ub] and {tg . x <= rhs}: when the clipped
// point violates the row, three rounds of a 256-point grid over the
// multiplier bracket [0, hi] (hi over every coordinate), each round taking
// the first feasible point, as the plain version does; the grid points
// are the plain version's bits (the same float32 operations in the same
// order, no contraction).  A coordinate with lb >= ub is ub whatever the
// multiplier, so the grid's sums run over the coordinates with lb < ub
// (compacted once a chunk) plus their constant.
//
// Design: one block of 256 threads a problem (thread k owns grid point k
// and coordinates k, k + 256, ...).  The problem's vectors (x, y, z, g,
// lb, ub, tg, the compacted list, the multipliers: 8n + C2 words) sit in
// shared memory when they fit in kSmemCap bytes, else in the wrapper's
// device-memory scratch, through the same code.  An iteration takes 10
// block barriers (11 with C2 rows): every reduction is a warp butterfly
// and one barrier over double-buffered warp slots.  Sums are taken in a
// fixed order, so a launch is deterministic, but not in torch's order.
//
// Bound on the card: the chunk is a chain of n_it dependent iterations
// of a few barriers each, for one problem on one SM; the least time by
// bytes (inputs once, x written once) or operations (float operations of
// the iterations at 67 TFLOP/s) is far below it at every shape the solver
// gives.  What the design does about it: nothing crosses the block, and
// nothing goes through device memory inside the chunk while the vectors
// fit in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // = the projection's grid points
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 3;
constexpr float kGrid = 256.0f;
constexpr int kSmemCap = 200 * 1024;

struct Args {
  const float *x0, *lam, *lb, *ub, *tg;
  const int *h_ptr, *h_col;
  const double *h_val, *hb;
  const int *m_ptr, *m_col;
  const double* m_val;
  const float* c2_rhs;
  const int *r_ptr, *r_row;
  const float* r_val;
  int n, C2, has_c2, n_it;
  float step, rho, rhs;
  float* out;
  int* stats;
  float* scratch;
};

// Block reductions: warp butterflies, then one barrier over slots that
// alternate between two buffers (a slot is written again only after a
// later barrier that every reader of its last value has passed).
struct Reducer {
  float (*red)[2][kWarps];
  int (*first)[kWarps];
  int rpar = 0, fpar = 0;

  // a <- max of a over the block, b <- sum of b; every thread gets both
  __device__ void max_sum(float& a, float& b) {
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      a = fmaxf(a, __shfl_xor_sync(0xFFFFFFFFu, a, d));
      b += __shfl_xor_sync(0xFFFFFFFFu, b, d);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red[rpar][0][warp] = a;
      red[rpar][1][warp] = b;
    }
    __syncthreads();
    a = red[rpar][0][0];
    b = red[rpar][1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a = fmaxf(a, red[rpar][0][w]);
      b += red[rpar][1][w];
    }
    rpar ^= 1;
  }

  __device__ float sum(float b) {
    float a = 0.0f;
    max_sum(a, b);
    return b;
  }

  // the smallest thread index whose f holds, kThreads when none
  __device__ int first_true(bool f) {
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, f);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) first[fpar][warp] = bal ? warp * 32 + __ffs(bal) - 1 : kThreads;
    __syncthreads();
    int k = kThreads;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) k = min(k, first[fpar][w]);
    fpar ^= 1;
    return k;
  }
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// grid point k of the bracket [a, b]: a + (b - a) * ((k + 1) / 256)
__device__ __forceinline__ float grid_mu(float a, float b, int k) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), (float)(k + 1) / kGrid));
}

struct Problem {
  float *lb, *ub, *tg;
  const int* fidx;
  int nf, n;
  float c0, rhs;
};

// the partials P needs of one coordinate of the point v: the bracket's
// top (v - lb) / tg where tg > 0, and tg . clip(v)
__device__ __forceinline__ void partials(const Problem& p, int i, float v,
                                         float& hi, float& s) {
  const float t = p.tg[i];
  if (t > 0.0f) hi = fmaxf(hi, __fdiv_rn(__fsub_rn(v, p.lb[i]), t));
  s += clip(v, p.lb[i], p.ub[i]) * t;
}

// v <- P(v) in place.  On entry each thread has written its own
// coordinates of v and holds their partials (hi from 1, s from 0).
// Returns whether the grid ran.
__device__ bool project(float* v, const Problem& p, Reducer& r, float hi,
                        float s) {
  r.max_sum(hi, s);  // also publishes v to the block
  const int tid = threadIdx.x;
  if (!(__fsub_rn(s, p.rhs) > 0.0f)) {
    for (int i = tid; i < p.n; i += kThreads) v[i] = clip(v[i], p.lb[i], p.ub[i]);
    return false;
  }
  float a = 0.0f, b = hi;
  for (int round = 0; round < kRounds; ++round) {
    const float mu = grid_mu(a, b, tid);
    float f = p.c0;
    for (int j = 0; j < p.nf; ++j) {
      const int i = p.fidx[j];
      const float t = p.tg[i];
      f += clip(__fsub_rn(v[i], __fmul_rn(mu, t)), p.lb[i], p.ub[i]) * t;
    }
    const int k = r.first_true(__fsub_rn(f, p.rhs) <= 0.0f);
    if (k < kThreads) {
      const float nb = grid_mu(a, b, k);
      a = k > 0 ? grid_mu(a, b, k - 1) : a;
      b = nb;
    } else {
      a = b;
    }
  }
  // every read of v by the grid ended at the last round's barrier
  for (int i = tid; i < p.n; i += kThreads)
    v[i] = clip(__fsub_rn(v[i], __fmul_rn(b, p.tg[i])), p.lb[i], p.ub[i]);
  return true;
}

__global__ void __launch_bounds__(kThreads) quant_fista_kernel(Args A) {
  extern __shared__ float smem[];
  __shared__ float red[2][2][kWarps];
  __shared__ int first[2][kWarps];
  __shared__ int wcount[kWarps];
  Reducer r{red, first};
  const int n = A.n, C2 = A.C2, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t words = 8 * (size_t)n + C2;
  float* base = A.scratch ? A.scratch + blockIdx.x * words : smem;
  float* x = base;
  float* y = x + n;
  float* z = y + n;
  float* g = z + n;
  Problem p;
  p.lb = g + n;
  p.ub = p.lb + n;
  p.tg = p.ub + n;
  int* fidx = reinterpret_cast<int*>(p.tg + n);
  float* mults = reinterpret_cast<float*>(fidx + n);
  p.fidx = fidx;
  p.n = n;
  p.rhs = A.rhs;

  const size_t row = (size_t)blockIdx.x * n;
  for (int i = tid; i < n; i += kThreads) {
    x[i] = y[i] = A.x0[row + i];
    p.lb[i] = A.lb[row + i];
    p.ub[i] = A.ub[row + i];
    p.tg[i] = A.tg[i];
  }
  // compact the coordinates with lb < ub, in order; the rest add tg * ub
  int nf = 0;
  float c0 = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const bool fr = i < n && p.lb[i] < p.ub[i];
    if (i < n && !fr) c0 += p.tg[i] * p.ub[i];
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, fr);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (fr) fidx[nf + before + __popc(bal & ((1u << lane) - 1u))] = i;
    nf += total;
    __syncthreads();
  }
  p.nf = nf;
  p.c0 = r.sum(c0);

  const float* lam = A.lam + (size_t)blockIdx.x * C2;
  const float step = A.step;
  float t = 1.0f;
  int grids = 0;
  for (int it = 0; it < A.n_it; ++it) {
    __syncthreads();  // y complete
    if (A.has_c2) {
      for (int q = tid; q < C2; q += kThreads) {
        double e2 = 0.0;
        for (int k = A.m_ptr[q]; k < A.m_ptr[q + 1]; ++k)
          e2 += A.m_val[k] * (double)y[A.m_col[k]];
        mults[q] = (float)fmax(lam[q] + (double)A.rho * (A.c2_rhs[q] - e2), 0.0);
      }
      __syncthreads();
    }
    float hi = 1.0f, s = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      // in float64: H y and hb nearly cancel near the optimum
      double gd = -A.hb[i];
      for (int k = A.h_ptr[i]; k < A.h_ptr[i + 1]; ++k)
        gd += A.h_val[k] * (double)y[A.h_col[k]];
      if (A.has_c2)
        for (int k = A.r_ptr[i]; k < A.r_ptr[i + 1]; ++k)
          gd -= (double)A.r_val[k] * mults[A.r_row[k]];
      const float gi = (float)gd;
      g[i] = gi;
      const float zi = __fsub_rn(y[i], __fmul_rn(step, gi));
      z[i] = zi;
      partials(p, i, zi, hi, s);
    }
    grids += project(z, p, r, hi, s);  // z = x'
    float dot = 0.0f;
    for (int i = tid; i < n; i += kThreads) dot += g[i] * __fsub_rn(z[i], x[i]);
    const bool restart = r.sum(dot) > 0.0f;
    if (restart) {
      for (int i = tid; i < n; i += kThreads) y[i] = z[i];
      t = 1.0f;
    } else {
      const float tn = 0.5f * (1.0f + sqrtf(1.0f + __fmul_rn(__fmul_rn(4.0f, t), t)));
      const float c = __fdiv_rn(t - 1.0f, tn);
      hi = 1.0f;
      s = 0.0f;
      for (int i = tid; i < n; i += kThreads) {
        const float w = __fadd_rn(z[i], __fmul_rn(c, __fsub_rn(z[i], x[i])));
        y[i] = w;
        partials(p, i, w, hi, s);
      }
      grids += project(y, p, r, hi, s);
      t = tn;
    }
    float* old = x;
    x = z;
    z = old;
  }
  for (int i = tid; i < n; i += kThreads) A.out[row + i] = x[i];
  if (tid == 0) {
    A.stats[2 * blockIdx.x] = grids;
    A.stats[2 * blockIdx.x + 1] = nf;
  }
}

}  // namespace

extern "C" int cammiq_quant_fista_smem_cap() { return kSmemCap; }

// x0, lb, ub: float32 [S, n]; lam: float32 [S, C2]; tg: float32 [n];
// hb: float64 [n]; H (h_ptr [n + 1], h_col, h_val) and M (m_ptr [C2 + 1],
// m_col, m_val): CSR, int32 / float64; R (r_ptr [n + 1], r_row, r_val):
// CSR, int32 / float32; c2_rhs: float32 [C2];
// out: float32 [S, n]; stats: int32 [S, 2] (projections that ran the grid,
// coordinates with lb < ub); scratch: null when (8n + C2) * 4 bytes fit
// in kSmemCap, else float32 [S, 8n + C2].
extern "C" int cammiq_quant_fista(
    const void* x0, const void* lam, const void* lb, const void* ub,
    const void* tg, const void* h_ptr, const void* h_col, const void* h_val,
    const void* hb, const void* m_ptr, const void* m_col, const void* m_val,
    const void* c2_rhs, const void* r_ptr, const void* r_row,
    const void* r_val, int S, int n, int C2, int has_c2, int n_it,
    float step, float rho, float rhs, void* out, void* stats, void* scratch,
    void* stream) {
  if (S <= 0 || n <= 0) return 0;
  const long long bytes = 4LL * (8LL * n + C2);
  if (!scratch && bytes > kSmemCap) return (int)cudaErrorInvalidValue;
  const int smem = scratch ? 0 : (int)bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        quant_fista_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{(const float*)x0,     (const float*)lam,    (const float*)lb,
         (const float*)ub,     (const float*)tg,     (const int*)h_ptr,
         (const int*)h_col,    (const double*)h_val, (const double*)hb,
         (const int*)m_ptr,    (const int*)m_col,    (const double*)m_val,
         (const float*)c2_rhs, (const int*)r_ptr,   (const int*)r_row,
         (const float*)r_val,  n,                   C2,
         has_c2,               n_it,                step,
         rho,                  rhs,                 (float*)out,
         (int*)stats,          (float*)scratch};
  quant_fista_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
