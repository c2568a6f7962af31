// Fused Newton contact solve: the whole Newton loop of the constraint solver
// for B independent envs in one launch, f32.
//
// Replaces the TPU kernels scripts/experimental/newton_solve.py::kernel (in
// _kernel_call; the loop of physics/solver.py `solve` vmapped inside the
// kernel, each env stopping early) and scripts/experimental/newton_bt.py::
// _solver_kernel (the same math batch-trailing, a fixed iteration count).
// They differ only in the stopping rule, so one kernel serves both: an env
// stops once its accepted step satisfies max|step| < tol (1 + max|a_new|),
// and tol = 0 runs exactly `iterations` iterations.
//
// Each iteration, per env (the port's gym_quadruped_tpu_torch/physics/
// solver.py `solve`, whose force laws and zone tests this mirrors exactly):
//   rows    us = J a - aref (ns simple rows), uc = cJ a - caref (C blocks of 6)
//   forces  Huber / one-sided simple rows, the elliptic cone force per block
//   g       M (a - a_smooth) - J' fs - cJ' fc
//   H       M + J' diag(cw) J + sum_c cJ_c' Hc_c cJ_c + 1e-10 tr(M)/nv I,
//           Hc the closed-form cone curvature
//   p       -H^-1 g: Cholesky with the pivot clamped to sqrt(max(s, 1e-30))
//           and a reciprocal diagonal, as csrc/spd_solve.cu
//   t       phi'(t) on the grid geomspace(1e-3, 256, 15), bracket, then
//           ls_iterations bisections; a += t p
// and at the end the forces and qfrc = J' fs + cJ' fc at the final a.
//
// What bounds it on an H100, at (B 4096, nv 18, ns 24, C 10): it must read
// 8,730 B of inputs and write 480 B of outputs per env, 37.7 MB in all
// (11.3 us at 3.35 TB/s), and compute about 86 kFLOP per env and iteration
// (H's cone quadratic form and J' W J 33 k, Hc cJ 13 k, the 21 evaluations of
// phi' 23 k, the Cholesky and solves 3 k, rows, g and the rest 14 k): 3.5
// GFLOP at 10 iterations (53 us at 67 TFLOP/s f32). It is bound by
// operations, and this first version by the latency of its many small
// dependent steps: one env's work is too small to fill a block.
//
// Design (simple first): one block of 128 threads runs one env's whole
// solve, so a ragged batch needs no masking and no env waits for another.
// The block stages the env's inputs into shared memory once (17.4 KB at the
// sizes above, 78 KB at nv 32, ns 64, C 32) and keeps every intermediate
// there. Rows, forces, g, Hc cJ and the lower triangle of H are spread over
// the threads; warp 0 factors H column by column (lane i owns row i) and
// solves with shuffles; the 15 grid points of phi' go to the 4 warps, then
// warp 0 brackets, bisects and takes the stopping test for the block. Each
// sum runs in a fixed order and the warp sums are xor butterflies, which give
// every lane the same bits: repeated runs are bitwise identical. The block
// leaves its loop when its env converges: there is no host sync. The kernel
// launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GRID = 15;          // step-length grid points
constexpr float T_MAX = 256.0f;   // the grid's last point
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory floats of one env (the layout of newton_kernel below).
__host__ __device__ int smem_floats(int nv, int ns, int C) {
  const int rows = ns + 6 * C;
  return 2 * nv * nv + ns * nv + 2 * 6 * C * nv + 36 * C + 5 * rows + 3 * ns +
         5 * C + 6 * C + 7 * nv + 2 * 16;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Row-separable force: one-sided quadratic (uni = 1) or Huber clamp.
__device__ __forceinline__ float simple_force(float u, float D, float fl, float uni) {
  const float f_uni = -D * fminf(u, 0.0f);
  const float f_hub = -fminf(fmaxf(D * u, -fl), fl);
  return uni * f_uni + (1.0f - uni) * f_hub;
}

// Diagonal curvature of the simple-row costs at u.
__device__ __forceinline__ float simple_weight(float u, float D, float fl, float uni) {
  const float c_uni = u < 0.0f ? D : 0.0f;
  const float c_hub = fabsf(D * u) < fl ? D : 0.0f;
  return uni * c_uni + (1.0f - uni) * c_hub;
}

// The scalars both cone laws share: mu0 T and the masked friction rows uf.
struct Cone {
  float mu0, N, Dn, rho, T;
  float uf[5];
};

__device__ __forceinline__ Cone cone_setup(const float* u, const float* D, const float* mu,
                                           const float* dm) {
  Cone k;
  k.mu0 = mu[0];
  k.N = u[0];
  k.Dn = D[0];
  k.rho = k.mu0 * k.mu0 / fmaxf(D[1], 1e-30f);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    k.uf[i] = u[1 + i] * dm[1 + i];
    const float x = k.uf[i] * mu[i] / k.mu0;
    ss += x * x;
  }
  k.T = sqrtf(fmaxf(ss, 1e-30f));
  return k;
}

// Elliptic force of one block: zones top (f = 0), bottom (f = -D u) and
// middle, tested in that order.
__device__ __forceinline__ void cone_force(const float* u, const float* D, const float* mu,
                                           const float* dm, float* f) {
  const Cone k = cone_setup(u, D, mu, dm);
  const float w = (k.mu0 * k.T + k.rho * k.Dn * k.N) / (1.0f + k.rho * k.Dn);
  if (k.N >= k.mu0 * k.T) {
#pragma unroll
    for (int d = 0; d < 6; ++d) f[d] = 0.0f;
  } else if (w <= 0.0f) {
#pragma unroll
    for (int d = 0; d < 6; ++d) f[d] = -D[d] * u[d] * dm[d];
  } else {
    const float ratio = w / fmaxf(k.mu0 * k.T, 1e-30f);
    f[0] = k.Dn * (w - k.N) * dm[0];
#pragma unroll
    for (int i = 0; i < 5; ++i) f[1 + i] = -D[1 + i] * k.uf[i] * (1.0f - ratio) * dm[1 + i];
  }
}

// Closed-form curvature -df/du of one block, row-major 6 x 6 (the port's
// cone_hessian_rows).
__device__ __forceinline__ void cone_hessian(const float* u, const float* D, const float* mu,
                                             const float* dm, float* H) {
  const Cone k = cone_setup(u, D, mu, dm);
  const float s = k.mu0 * k.T;
  const float s_safe = fmaxf(s, 1e-30f);
  const float rd1 = 1.0f + k.rho * k.Dn;
  const float alpha = k.rho * k.Dn / rd1;
  const float W = (s + k.rho * k.Dn * k.N) / rd1;
  if (k.N >= k.mu0 * k.T) {
    for (int i = 0; i < 36; ++i) H[i] = 0.0f;
    return;
  }
  if (W <= 0.0f) {
    for (int i = 0; i < 36; ++i) H[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < 6; ++d) H[d * 7] = D[d] * dm[d] * dm[d];
    return;
  }
  float gamma[5], beta[5], Df[5];
  const float Ws = W / s_safe;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    gamma[j] = mu[j] * mu[j] * k.uf[j] / s_safe;
    beta[j] = gamma[j] / rd1;
    Df[j] = D[1 + j] * dm[1 + j];
  }
  H[0] = k.Dn * (1.0f - alpha) * dm[0] * dm[0];
#pragma unroll
  for (int j = 0; j < 5; ++j) H[1 + j] = -k.Dn * beta[j] * dm[0] * dm[1 + j];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float col0 = -Df[i] * k.uf[i] * (alpha / s_safe);
    H[(1 + i) * 6] = col0 * dm[1 + i] * dm[0];
    const float Dfuf = Df[i] * k.uf[i];
    const float diag = Df[i] * (1.0f - Ws);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float right = (beta[j] - Ws * gamma[j]) / s_safe;
      const float ff = (i == j ? diag : 0.0f) + -Dfuf * right;
      H[(1 + i) * 6 + 1 + j] = ff * dm[1 + i] * dm[1 + j];
    }
  }
}

// Everything one env keeps in shared memory.
struct Env {
  int nv, ns, C;
  float *M, *H, *J, *cJ, *T, *Hc;
  float *u, *du, *f, *aref, *D;   // ns simple rows, then 6 C cone rows
  float *fl, *uni, *cw, *mu, *dm;
  float *as, *a, *r, *g, *p, *Mp, *Mr, *grid, *vals;
};

// u = J a - aref over the simple rows and the cone rows.
__device__ void compute_rows(const Env& e) {
  const int rows = e.ns + 6 * e.C;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const float* row = i < e.ns ? e.J + i * e.nv : e.cJ + (i - e.ns) * e.nv;
    float s = 0.0f;
    for (int k = 0; k < e.nv; ++k) s += row[k] * e.a[k];
    e.u[i] = s - e.aref[i];
  }
}

// Forces at the current rows; with `curvature`, also the simple-row weights
// and the cone blocks' curvature.
__device__ void compute_forces(const Env& e, bool curvature) {
  for (int i = threadIdx.x; i < e.ns + e.C; i += THREADS) {
    if (i < e.ns) {
      e.f[i] = simple_force(e.u[i], e.D[i], e.fl[i], e.uni[i]);
      if (curvature) e.cw[i] = simple_weight(e.u[i], e.D[i], e.fl[i], e.uni[i]);
    } else {
      const int c = i - e.ns, o = e.ns + 6 * c;
      cone_force(e.u + o, e.D + o, e.mu + 5 * c, e.dm + 6 * c, e.f + o);
      if (curvature) cone_hessian(e.u + o, e.D + o, e.mu + 5 * c, e.dm + 6 * c, e.Hc + 36 * c);
    }
  }
}

// J' fs + cJ' fc at dof k.
__device__ __forceinline__ void constraint_force(const Env& e, int k, float* jf, float* cf) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = 0; i < e.ns; ++i) s1 += e.J[i * e.nv + k] * e.f[i];
  for (int r = 0; r < 6 * e.C; ++r) s2 += e.cJ[r * e.nv + k] * e.f[e.ns + r];
  *jf = s1;
  *cf = s2;
}

// phi'(t) of the line search, summed by one warp (every lane gets the value).
__device__ float dphi(const Env& e, float t, float pMr, float pMp, int lane) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < e.ns; i += 32) {
    const float ut = e.u[i] + t * e.du[i];
    s1 += simple_force(ut, e.D[i], e.fl[i], e.uni[i]) * e.du[i];
  }
  for (int c = lane; c < e.C; c += 32) {
    const int o = e.ns + 6 * c;
    float ut[6], ft[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) ut[d] = e.u[o + d] + t * e.du[o + d];
    cone_force(ut, e.D + o, e.mu + 5 * c, e.dm + 6 * c, ft);
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < 6; ++d) s += ft[d] * e.du[o + d];
    s2 += s;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  return pMr + t * pMp - s1 - s2;
}

// Warp 0: p = -H^-1 g. Lane i owns row i; L overwrites H's lower triangle.
__device__ void chol_solve(const Env& e, int lane) {
  const int n = e.nv;
  float* L = e.H;
  float inv = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float r = 1.0f / sqrtf(fmaxf(L[j * n + j], 1e-30f));
    if (lane == j) inv = r;
    if (lane > j && lane < n) L[lane * n + j] *= r;
    __syncwarp();
    if (lane > j && lane < n) {
      const float l = L[lane * n + j];
      for (int k = j + 1; k <= lane; ++k) L[lane * n + k] -= l * L[k * n + j];
    }
    __syncwarp();
  }
  float v = lane < n ? e.g[lane] : 0.0f;
  for (int i = 0; i < n; ++i) {                      // L y = g
    const float yi = __shfl_sync(FULL, v, i) * __shfl_sync(FULL, inv, i);
    if (lane == i) v = yi;
    else if (lane > i && lane < n) v -= L[lane * n + i] * yi;
  }
  for (int i = n - 1; i >= 0; --i) {                 // L' x = y
    const float xi = __shfl_sync(FULL, v, i) * __shfl_sync(FULL, inv, i);
    if (lane == i) v = xi;
    else if (lane < i) v -= L[i * n + lane] * xi;
  }
  if (lane < n) e.p[lane] = -v;
}

__global__ void __launch_bounds__(THREADS)
newton_kernel(const float* __restrict__ gM, const float* __restrict__ gAs,
              const float* __restrict__ gA0, const float* __restrict__ gJ,
              const float* __restrict__ gAref, const float* __restrict__ gR,
              const unsigned char* __restrict__ gAct, const float* __restrict__ gFl,
              const float* __restrict__ gCJ, const float* __restrict__ gCaref,
              const float* __restrict__ gCR, const unsigned char* __restrict__ gCact,
              const float* __restrict__ gMu, const float* __restrict__ gDm,
              const float* __restrict__ gGrid, float* __restrict__ qacc,
              float* __restrict__ fs_out, float* __restrict__ fc_out,
              float* __restrict__ qfrc_out, int* __restrict__ iters_out, int nv, int ns,
              int C, int iterations, int ls_iterations, float tol) {
  extern __shared__ float smem[];
  __shared__ float s_t;           // the accepted step length
  __shared__ bool s_converged;    // the env's stopping test, one value for the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nn = nv * nv, R6 = 6 * C, rows = ns + R6, ncj = R6 * nv;
  Env e;
  e.nv = nv;
  e.ns = ns;
  e.C = C;
  e.M = smem;
  e.H = e.M + nn;
  e.J = e.H + nn;
  e.cJ = e.J + ns * nv;
  e.T = e.cJ + ncj;
  e.Hc = e.T + ncj;
  e.u = e.Hc + 36 * C;
  e.du = e.u + rows;
  e.f = e.du + rows;
  e.aref = e.f + rows;
  e.D = e.aref + rows;
  e.fl = e.D + rows;
  e.uni = e.fl + ns;
  e.cw = e.uni + ns;
  e.mu = e.cw + ns;
  e.dm = e.mu + 5 * C;
  e.as = e.dm + R6;
  e.a = e.as + nv;
  e.r = e.a + nv;
  e.g = e.r + nv;
  e.p = e.g + nv;
  e.Mp = e.p + nv;
  e.Mr = e.Mp + nv;
  e.grid = e.Mr + nv;
  e.vals = e.grid + 16;

  // ---- stage the env's inputs once ---------------------------------------------
  const long long env = blockIdx.x;
  for (int i = tid; i < nn; i += THREADS) e.M[i] = gM[env * nn + i];
  for (int i = tid; i < nv; i += THREADS) {
    e.as[i] = gAs[env * nv + i];
    e.a[i] = gA0[env * nv + i];
  }
  for (int i = tid; i < ns * nv; i += THREADS) e.J[i] = gJ[env * ns * nv + i];
  for (int i = tid; i < ns; i += THREADS) {
    const long long g = env * ns + i;
    e.aref[i] = gAref[g];
    e.D[i] = static_cast<float>(gAct[g]) * (1.0f / gR[g]);
    e.fl[i] = gFl[g];
    e.uni[i] = gFl[g] <= 0.0f ? 1.0f : 0.0f;
  }
  for (int i = tid; i < ncj; i += THREADS) e.cJ[i] = gCJ[env * ncj + i];
  for (int i = tid; i < R6; i += THREADS) {
    const long long g = env * R6 + i;
    e.aref[ns + i] = gCaref[g];
    e.dm[i] = gDm[g];
    e.D[ns + i] = static_cast<float>(gCact[env * C + i / 6]) * (1.0f / gCR[g]) * gDm[g];
  }
  for (int i = tid; i < 5 * C; i += THREADS) e.mu[i] = gMu[env * 5 * C + i];
  for (int i = tid; i < GRID; i += THREADS) e.grid[i] = gGrid[i];
  __syncthreads();

  float trace = 0.0f;
  for (int k = 0; k < nv; ++k) trace += e.M[k * nv + k];
  const float reg = 1e-10f * trace / static_cast<float>(nv);

  int it = 0;
  while (it < iterations) {
    compute_rows(e);
    for (int k = tid; k < nv; k += THREADS) e.r[k] = e.a[k] - e.as[k];
    __syncthreads();
    compute_forces(e, true);
    __syncthreads();

    // g = M r - J' fs - cJ' fc; T = Hc cJ per block
    for (int k = tid; k < nv; k += THREADS) {
      float mr = 0.0f, jf, cf;
      for (int j = 0; j < nv; ++j) mr += e.M[k * nv + j] * e.r[j];
      constraint_force(e, k, &jf, &cf);
      e.Mr[k] = mr;
      e.g[k] = mr - jf - cf;
    }
    for (int idx = tid; idx < ncj; idx += THREADS) {
      const int k = idx % nv, cd = idx / nv, c = cd / 6;
      const float* h = e.Hc + 36 * c + 6 * (cd % 6);
      const float* cj = e.cJ + 6 * c * nv + k;
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += h[q] * cj[q * nv];
      e.T[idx] = s;
    }
    __syncthreads();

    // lower triangle of H = M + J' diag(cw) J + cJ' T + reg I
    for (int idx = tid; idx < nn; idx += THREADS) {
      const int i = idx / nv, j = idx % nv;
      if (j > i) continue;
      float s1 = 0.0f, s2 = 0.0f;
      for (int q = 0; q < ns; ++q) s1 += e.J[q * nv + i] * (e.cw[q] * e.J[q * nv + j]);
      for (int q = 0; q < R6; ++q) s2 += e.cJ[q * nv + i] * e.T[q * nv + j];
      float h = e.M[idx] + s1;
      if (C) h = h + s2;
      if (i == j) h = h + reg;
      e.H[idx] = h;
    }
    __syncthreads();

    if (warp == 0) chol_solve(e, lane);
    __syncthreads();

    // projections for the line search: M p, J p, cJ p
    for (int i = tid; i < nv + rows; i += THREADS) {
      const float* row = i < nv ? e.M + i * nv
                                : (i - nv < ns ? e.J + (i - nv) * nv : e.cJ + (i - nv - ns) * nv);
      float s = 0.0f;
      for (int k = 0; k < nv; ++k) s += row[k] * e.p[k];
      if (i < nv) e.Mp[i] = s;
      else e.du[i - nv] = s;
    }
    __syncthreads();

    float pMp = 0.0f, pMr = 0.0f;
    for (int k = 0; k < nv; ++k) {
      pMp += e.p[k] * e.Mp[k];
      pMr += e.p[k] * e.Mr[k];
    }
    for (int q = warp; q < GRID; q += WARPS) {
      const float v = dphi(e, e.grid[q], pMr, pMp, lane);
      if (lane == 0) e.vals[q] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // lo = the largest grid t with phi' < 0 (else 0), hi = the smallest
      // with phi' >= 0 (else the grid's end), then the bisections
      float lo = 0.0f, hi = T_MAX;
      for (int q = 0; q < GRID; ++q) {
        const bool neg = e.vals[q] < 0.0f;
        lo = fmaxf(lo, neg ? e.grid[q] : 0.0f);
        hi = fminf(hi, neg ? T_MAX : e.grid[q]);
      }
      for (int b = 0; b < ls_iterations; ++b) {
        const float mid = 0.5f * (lo + hi);
        if (dphi(e, mid, pMr, pMp, lane) < 0.0f) lo = mid;
        else hi = mid;
      }
      if (lane == 0) {
        // accept a + t p; converged once max|t p| < tol (1 + max|a + t p|)
        const float t = 0.5f * (lo + hi);
        float max_step = 0.0f, max_a = 0.0f;
        bool finite = true;
        for (int k = 0; k < nv; ++k) {
          const float st = __fmul_rn(t, e.p[k]);
          const float an = __fadd_rn(e.a[k], st);
          finite = finite && st == st && an == an;
          max_step = fmaxf(max_step, fabsf(st));
          max_a = fmaxf(max_a, fabsf(an));
        }
        s_t = t;
        s_converged = finite && max_step < tol * (1.0f + max_a);
      }
    }
    __syncthreads();
    const float t = s_t;
    for (int k = tid; k < nv; k += THREADS) e.a[k] = __fadd_rn(e.a[k], __fmul_rn(t, e.p[k]));
    __syncthreads();
    ++it;
    if (s_converged) break;
  }

  // ---- forces at the final a, and the outputs ---------------------------------
  compute_rows(e);
  __syncthreads();
  compute_forces(e, false);
  __syncthreads();
  for (int k = tid; k < nv; k += THREADS) {
    float jf, cf;
    constraint_force(e, k, &jf, &cf);
    qacc[env * nv + k] = e.a[k];
    qfrc_out[env * nv + k] = jf + cf;
  }
  for (int i = tid; i < ns; i += THREADS) fs_out[env * ns + i] = e.f[i];
  for (int i = tid; i < R6; i += THREADS) fc_out[env * R6 + i] = e.f[ns + i];
  if (tid == 0 && iters_out != nullptr) iters_out[env] = it;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every array is row-major,
// contiguous and batch-leading: M (B, nv, nv), a_smooth and a0 (B, nv), J
// (B, ns, nv), aref, R, frictionloss (B, ns), active (B, ns) bool, cJ (B, C,
// 6, nv), caref, cR, dm (B, C, 6), cactive (B, C) bool, mu (B, C, 5), grid
// (15,); outputs qacc, qfrc (B, nv), fs (B, ns), fc (B, C, 6) and, unless
// null, iters (B,) int32. Returns the CUDA error code of the launch (0 on
// success); the caller raises on anything else.
extern "C" int gqt_newton_fused_f32(
    const float* M, const float* a_smooth, const float* a0, const float* J,
    const float* aref, const float* R, const unsigned char* active, const float* fl,
    const float* cJ, const float* caref, const float* cR, const unsigned char* cactive,
    const float* mu, const float* dm, const float* grid, float* qacc, float* fs, float* fc,
    float* qfrc, int* iters, int B, int nv, int ns, int C, int iterations,
    int ls_iterations, float tol, void* stream) {
  if (B <= 0) return 0;
  if (nv < 1 || nv > 32 || ns < 0 || ns > 64 || C < 0 || C > 32 || iterations < 0 ||
      ls_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * smem_floats(nv, ns, C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  newton_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      M, a_smooth, a0, J, aref, R, active, fl, cJ, caref, cR, cactive, mu, dm, grid, qacc,
      fs, fc, qfrc, iters, nv, ns, C, iterations, ls_iterations, tol);
  return static_cast<int>(cudaGetLastError());
}
