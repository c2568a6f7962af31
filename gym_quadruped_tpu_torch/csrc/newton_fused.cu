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
//   rows    us = J a - aref (simple rows), uc = cJ a - caref (blocks of 6)
//   forces  Huber / one-sided simple rows, the elliptic cone force per block
//   g       M (a - a_smooth) - J' fs - cJ' fc
//   H       M + J' diag(cw) J + sum_c cJ_c' Hc_c cJ_c + 1e-10 tr(M)/nv I,
//           Hc the closed-form cone curvature
//   p       -H^-1 g: the warp Cholesky of csrc/chol_warp.cuh
//   t       phi'(t) on the grid geomspace(1e-3, 256, 15), bracket, then
//           ls_iterations bisections; a += t p
// and at the end the forces and qfrc = J' fs + cJ' fc at the final a. With
// no rows at all (ns = C = 0) the cost is 1/2 r'M r and its minimiser is
// a_smooth: the kernel writes it with 0 iterations, as `solve` does.
//
// What bounds it on an H100, at (B 4096, nv 18, ns 24, C 10): it must read
// 8,730 B of inputs and write 480 B of outputs per env, 37.7 MB in all
// (11.3 us at 3.35 TB/s). Counted densely it computes about 86 kFLOP per env
// and iteration, 3.5 GFLOP at 10 iterations (53 us at 67 TFLOP/s f32). But a
// row whose `active` flag is off has D = 0, and then its force, its
// curvature and its line-search term are exact zeros (simple_force gives
// +-0; cone_force gives 0 in all three zones when Dn and D are 0;
// cone_hessian too). On spot/flat the 12 joint-limit rows are inactive except
// near a joint's range and only the feet touching the floor of the 10 cone
// slots are active; and every simple row has one nonzero in J, and M has
// zeros between the legs. Over the active rows and these nonzeros the work
// these inputs need is about a quarter of the dense count, and the bytes
// bound it (chip_smoke.py phase 8 prints both bounds). The kernel is bound
// by the latency of its small dependent steps: one env's work is too small
// for many threads.
//
// Design: one warp runs one env's whole solve, one or two envs to a block, and
// warps never wait for each other (no block barrier), so a converged env is a
// warp that leaves its loop and a ragged last block's spare warps return at
// once. Two envs to a block where two envs' shared memory fits in one block,
// else one (envs_per_block, chosen at launch from nv, ns and C): a block keeps
// its shared memory until its slowest env is done, so small blocks waste
// little of it. At staging the warp compacts the active rows with a ballot
// per 32 rows and a prefix count (up to MAX_NS = 1,088 simple rows: the
// 148-158 of a pyramidal model's 32 culled slots x 4 facets, and the unculled
// per-slot rows of the frictionless and mixed-condim models, up to 1,058 on
// mini_cheetah/perlin, each with its friction-loss and limit rows): only the
// na active simple rows and the nc active cone blocks are staged, in their
// original order, and every loop walks only those. Dropping a row drops exact
// zeros from each sum, and adding a zero does not change an f32 sum, so
// compaction changes no result; inactive rows get zero forces. Everything the
// loop reads lives in the warp's part of shared memory (13.5 KB at the sizes
// above; 8 blocks = 16 envs per SM, where the launch bounds' 128 registers a
// thread allow 16 warps too). Each phase spreads over the lanes: rows, forces
// and the cone curvature over the active rows and blocks; g and M p over the
// dofs; H's lower triangle over its pairs (with an exact shortcut when every
// active simple row has one nonzero, which a pyramidal facet row, dense over
// the dofs of its bodies, does not; and each active block's Hc_c cJ_c formed
// in a 6 x nv scratch and folded into H straight away); the Cholesky column
// by column with lane i owning row i in registers; the 15 grid points of phi'
// on lane pairs, each lane summing half the rows. The 6 bisections stay serial, each
// phi' summed over the active rows across the lanes: on spot/flat about 16-23
// rows and blocks are active, so one warp-wide evaluation costs one cone
// block and a butterfly, where evaluating the 63 nodes of the bisection tree
// speculatively would cost every lane two serial sums over all the rows. Each
// sum runs in a fixed order and the warp sums are xor butterflies, which give
// every lane the same bits: repeated runs are bitwise identical. The kernel
// is compiled for one nv = GQT_NV (ops/newton_fused.py builds one library per
// nv), so every loop over the dofs has a known trip count and each lane's
// pairs of H are unrolled. There is no host sync. The kernel launches on the
// caller's stream and allocates nothing.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

#ifndef GQT_NV
#error "compile with -DGQT_NV=<nv>, the dofs (1 to 32)"
#endif
static_assert(GQT_NV >= 1 && GQT_NV <= chol_warp::MAX_N, "GQT_NV must be in 1..32");

namespace {

constexpr int MAX_WARPS = 2;      // envs per block, at most (envs_per_block)
constexpr int GRID = 15;          // step-length grid points
constexpr float T_MAX = 256.0f;   // the grid's last point
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NS = 1088;      // simple rows: 34 words of the active-row ballot
constexpr int MAX_C = 32;         // cone blocks: 1 word

// One env's shared memory, as float offsets (M, H, J, cJ and Tc have the
// odd row stride ld = nv | 1; the row arrays hold the active simple rows,
// then the active cone blocks' rows; slot, an int per simple row, is the
// row's place among the active rows or -1).
struct Layout {
  int ld, M, H, J, cJ, Hc, Tc, u, du, f, aref, D, fl, cw, col, slot, mu, dm, as, a, r, p, Mp,
      grid, total;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += n;
  return at;
}

__host__ __device__ Layout layout(int nv, int ns, int C) {
  Layout s;
  const int ld = nv | 1, rows = ns + 6 * C;
  int o = 0;
  s.ld = ld;
  s.M = take(o, nv * ld);
  s.H = take(o, nv * ld);
  s.J = take(o, ns * ld);
  s.cJ = take(o, 6 * C * ld);
  s.Hc = take(o, 36 * C);
  s.Tc = take(o, 6 * ld);
  s.u = take(o, rows);
  s.du = take(o, rows);
  s.f = take(o, rows);
  s.aref = take(o, rows);
  s.D = take(o, rows);
  s.fl = take(o, ns);
  s.cw = take(o, ns);
  s.col = take(o, ns);
  s.slot = take(o, ns);
  s.mu = take(o, 5 * C);
  s.dm = take(o, 6 * C);
  s.as = take(o, nv);
  s.a = take(o, nv);
  s.r = take(o, nv);
  s.p = take(o, nv);
  s.Mp = take(o, nv);
  s.grid = take(o, 16);
  s.total = o;
  return s;
}

size_t env_bytes(int nv, int ns, int C) { return sizeof(float) * layout(nv, ns, C).total; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The count of set bits of m below bit i (i < 32).
__device__ __forceinline__ int rank(unsigned m, int i) { return __popc(m & ((1u << i) - 1u)); }

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

__device__ __forceinline__ float unilateral(float fl) { return fl <= 0.0f ? 1.0f : 0.0f; }

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

// One env in its warp's part of shared memory: na active simple rows and nc
// active cone blocks, compacted; the cone rows follow the simple rows in the
// row arrays (row na + 6 m + d is dimension d of block m).
struct Env {
  int nv, ld, na, nc;
  bool unit;   // every active simple row has at most one nonzero, at col
  float *M, *H, *J, *cJ, *Hc, *Tc;
  float *u, *du, *f, *aref, *D, *fl, *cw, *mu, *dm;
  float *as, *a, *r, *p, *Mp, *grid;
  int* col;

  __device__ __forceinline__ const float* row(int i) const {
    return i < na ? J + i * ld : cJ + (i - na) * ld;
  }
};

// u = J a - aref over the active rows.
__device__ __forceinline__ void compute_rows(const Env& e, int lane) {
  for (int i = lane; i < e.na + 6 * e.nc; i += 32) {
    const float* row = e.row(i);
    float s = 0.0f;
    for (int k = 0; k < e.nv; ++k) s += row[k] * e.a[k];
    e.u[i] = s - e.aref[i];
  }
}

// Forces at the current rows; with `curvature`, also the simple-row weights
// and the cone blocks' curvature.
__device__ __forceinline__ void compute_forces(const Env& e, bool curvature, int lane) {
  for (int i = lane; i < e.na + e.nc; i += 32) {
    if (i < e.na) {
      const float uni = unilateral(e.fl[i]);
      e.f[i] = simple_force(e.u[i], e.D[i], e.fl[i], uni);
      if (curvature) e.cw[i] = simple_weight(e.u[i], e.D[i], e.fl[i], uni);
    } else {
      const int m = i - e.na, o = e.na + 6 * m;
      cone_force(e.u + o, e.D + o, e.mu + 5 * m, e.dm + 6 * m, e.f + o);
      if (curvature) cone_hessian(e.u + o, e.D + o, e.mu + 5 * m, e.dm + 6 * m, e.Hc + 36 * m);
    }
  }
}

// J' fs + cJ' fc at dof k, over the active rows.
__device__ __forceinline__ float constraint_force(const Env& e, int k) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int q = 0; q < e.na; ++q) s1 += e.J[q * e.ld + k] * e.f[q];
  for (int q = 0; q < 6 * e.nc; ++q) s2 += e.cJ[q * e.ld + k] * e.f[e.na + q];
  return s1 + s2;
}

// One simple row's and one cone block's term f(u + t du) . du of phi'(t).
__device__ __forceinline__ float simple_term(const Env& e, int k, float t) {
  const float ut = e.u[k] + t * e.du[k];
  return simple_force(ut, e.D[k], e.fl[k], unilateral(e.fl[k])) * e.du[k];
}

__device__ __forceinline__ float cone_term(const Env& e, int m, float t) {
  const int o = e.na + 6 * m;
  float ut[6], ft[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) ut[d] = e.u[o + d] + t * e.du[o + d];
  cone_force(ut, e.D + o, e.mu + 5 * m, e.dm + 6 * m, ft);
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < 6; ++d) s += ft[d] * e.du[o + d];
  return s;
}

// phi'(t) summed by two lanes, lane and lane ^ 16: each half of the warp
// sums its half of the simple rows and of the cone blocks in order, and one
// shuffle adds the halves (both lanes get the value).
__device__ __forceinline__ float dphi_pair(const Env& e, float t, float pMr, float pMp,
                                           int lane) {
  const int half = lane >> 4, sa = (e.na + 1) / 2, sc = (e.nc + 1) / 2;
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = half ? sa : 0, end = half ? e.na : sa; k < end; ++k) s1 += simple_term(e, k, t);
  for (int m = half ? sc : 0, end = half ? e.nc : sc; m < end; ++m) s2 += cone_term(e, m, t);
  s1 += __shfl_xor_sync(FULL, s1, 16);
  s2 += __shfl_xor_sync(FULL, s2, 16);
  return pMr + t * pMp - s1 - s2;
}

// phi'(t) summed across the warp (every lane gets the value).
__device__ __forceinline__ float dphi_warp(const Env& e, float t, float pMr, float pMp,
                                           int lane) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < e.na + e.nc; i += 32) {
    if (i < e.na) s1 += simple_term(e, i, t);
    else s2 += cone_term(e, i - e.na, t);
  }
  return pMr + t * pMp - warp_sum(s1 + s2);
}

// The lower triangle of H = M + J' diag(cw) J + sum_c cJ_c' (Hc_c cJ_c) +
// reg I. Its pairs (0,0), (1,0), (1,1), (2,0), ... go round the lanes. When
// every simple row has one nonzero J_qc (a dof's friction loss, a hinge's
// limit), J' diag(cw) J adds only to H_cc, and every other term of the
// dense sum is an exact zero: lane c sums its diagonal's terms in row order
// and the other pairs take M as it is. Then each active block's Hc_c cJ_c
// is formed in the 6 x nv scratch Tc, lane k holding column k of cJ_c, and
// added to every pair before the next block's: a lane's P pairs are
// unrolled and their sums kept in registers across the blocks.
__device__ __forceinline__ void next_pair(int& i, int& j) {
  while (j > i) {
    j -= i + 1;
    ++i;
  }
}

__device__ __forceinline__ void compute_hessian(const Env& e, float reg, int lane) {
  const int ld = e.ld, nv = e.nv;
  if (e.unit) {
    for (int i = 0, j = lane; next_pair(i, j), i < nv; j += 32) {
      if (i != j) e.H[i * ld + j] = e.M[i * ld + j];
    }
    if (lane < nv) {
      float s1 = 0.0f;
      for (int q = 0; q < e.na; ++q) {
        if (e.col[q] == lane) {
          const float x = e.J[q * ld + lane];
          s1 += x * (e.cw[q] * x);
        }
      }
      e.H[lane * ld + lane] = e.M[lane * ld + lane] + s1;
    }
  } else {
    for (int i = 0, j = lane; next_pair(i, j), i < nv; j += 32) {
      float s1 = 0.0f;
      for (int q = 0; q < e.na; ++q) s1 += e.J[q * ld + i] * (e.cw[q] * e.J[q * ld + j]);
      e.H[i * ld + j] = e.M[i * ld + j] + s1;
    }
  }
  constexpr int P = (GQT_NV * (GQT_NV + 1) / 2 + 31) / 32;
  int pair[P];   // i << 8 | j, or -1 past the triangle's end
  float acc[P];
  __syncwarp();
  {
    int i = 0, j = lane;
#pragma unroll
    for (int p = 0; p < P; ++p, j += 32) {
      next_pair(i, j);
      pair[p] = i < nv ? i << 8 | j : -1;
      acc[p] = i < nv ? e.H[i * ld + j] : 0.0f;
    }
  }
  for (int m = 0; m < e.nc; ++m) {
    const float* hc = e.Hc + 36 * m;
    const float* cj = e.cJ + 6 * m * ld;
    __syncwarp();   // the previous block's Tc has been read
    if (lane < nv) {
      float cjk[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) cjk[q] = cj[q * ld + lane];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; ++q) s += hc[6 * d + q] * cjk[q];
        e.Tc[d * ld + lane] = s;
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (pair[p] < 0) continue;
      const int i = pair[p] >> 8, j = pair[p] & 255;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < 6; ++d) s += cj[d * ld + i] * e.Tc[d * ld + j];
      acc[p] += s;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (pair[p] < 0) continue;
    const int i = pair[p] >> 8, j = pair[p] & 255;
    e.H[i * ld + j] = i == j ? acc[p] + reg : acc[p];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * MAX_WARPS, 16 / MAX_WARPS)
newton_kernel(const float* __restrict__ gM, const float* __restrict__ gAs,
              const float* __restrict__ gA0, const float* __restrict__ gJ,
              const float* __restrict__ gAref, const float* __restrict__ gR,
              const unsigned char* __restrict__ gAct, const float* __restrict__ gFl,
              const float* __restrict__ gCJ, const float* __restrict__ gCaref,
              const float* __restrict__ gCR, const unsigned char* __restrict__ gCact,
              const float* __restrict__ gMu, const float* __restrict__ gDm,
              const float* __restrict__ gGrid, float* __restrict__ qacc,
              float* __restrict__ fs_out, float* __restrict__ fc_out,
              float* __restrict__ qfrc_out, int* __restrict__ iters_out, int B, int ns,
              int C, int iterations, int ls_iterations, float tol) {
  extern __shared__ float smem[];
  constexpr int nv = GQT_NV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long env = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (env >= B) return;
  if (ns == 0 && C == 0) {
    if (lane < nv) {
      qacc[env * nv + lane] = gAs[env * nv + lane];
      qfrc_out[env * nv + lane] = 0.0f;
    }
    if (lane == 0 && iters_out != nullptr) iters_out[env] = 0;
    return;
  }

  const Layout s = layout(nv, ns, C);
  float* base = smem + warp * s.total;
  const int ld = s.ld, nn = nv * nv, R6 = 6 * C;

  // ---- compact the active rows: one ballot per word of 32 simple rows, the
  // active rows before a row and its own word's bits below it give its slot,
  // kept in shared memory (a dynamic index would put an array of words in
  // local memory); bit c of cm is cone block c, its rank its slot ------------------
  const unsigned char* act = gAct + env * ns;
  int* slot = reinterpret_cast<int*>(base + s.slot);
  int na = 0;
  for (int w = 0; w < (ns + 31) / 32; ++w) {
    const int i = 32 * w + lane;
    const bool on = i < ns && act[i];
    const unsigned bits = __ballot_sync(FULL, on);
    if (i < ns) slot[i] = on ? na + rank(bits, lane) : -1;
    na += __popc(bits);
  }
  const unsigned cm = __ballot_sync(FULL, lane < C && gCact[env * C + lane]);
  __syncwarp();

  Env e;
  e.nv = nv;
  e.ld = ld;
  e.na = na;
  e.nc = __popc(cm);
  e.M = base + s.M;
  e.H = base + s.H;
  e.J = base + s.J;
  e.cJ = base + s.cJ;
  e.Hc = base + s.Hc;
  e.Tc = base + s.Tc;
  e.u = base + s.u;
  e.du = base + s.du;
  e.f = base + s.f;
  e.aref = base + s.aref;
  e.D = base + s.D;
  e.fl = base + s.fl;
  e.cw = base + s.cw;
  e.col = reinterpret_cast<int*>(base + s.col);
  e.mu = base + s.mu;
  e.dm = base + s.dm;
  e.as = base + s.as;
  e.a = base + s.a;
  e.r = base + s.r;
  e.p = base + s.p;
  e.Mp = base + s.Mp;
  e.grid = base + s.grid;

  // ---- stage the env's inputs once: M, the active rows, the vectors --------------
  for (int i = lane; i < nn; i += 32) e.M[(i / nv) * ld + i % nv] = gM[env * nn + i];
  if (lane < nv) {
    e.as[lane] = gAs[env * nv + lane];
    e.a[lane] = gA0[env * nv + lane];
  }
  for (int i = lane; i < ns * nv; i += 32) {
    const int q = i / nv, k = slot[q];
    if (k >= 0) e.J[k * ld + i - q * nv] = gJ[env * ns * nv + i];
  }
  for (int i = lane; i < ns; i += 32) {
    const int k = slot[i];
    if (k < 0) continue;
    const long long g = env * ns + i;
    e.aref[k] = gAref[g];
    e.D[k] = 1.0f / gR[g];
    e.fl[k] = gFl[g];
  }
  for (int i = lane; i < R6 * nv; i += 32) {
    const int q = i / nv, c = q / 6;
    if ((cm >> c) & 1u) {
      e.cJ[(6 * rank(cm, c) + q - 6 * c) * ld + i - q * nv] = gCJ[env * R6 * nv + i];
    }
  }
  for (int i = lane; i < R6; i += 32) {
    const int c = i / 6;
    if (!((cm >> c) & 1u)) continue;
    const long long g = env * R6 + i;
    const int o = 6 * rank(cm, c) + i - 6 * c;
    e.aref[e.na + o] = gCaref[g];
    e.dm[o] = gDm[g];
    e.D[e.na + o] = 1.0f / gCR[g] * gDm[g];
  }
  for (int i = lane; i < 5 * C; i += 32) {
    const int c = i / 5;
    if ((cm >> c) & 1u) e.mu[5 * rank(cm, c) + i - 5 * c] = gMu[env * 5 * C + i];
  }
  if (lane < GRID) e.grid[lane] = gGrid[lane];
  __syncwarp();
  bool unit = true;
  for (int k = lane; k < e.na; k += 32) {
    int c = -1, nnz = 0;
    for (int j = 0; j < nv; ++j) {
      if (e.J[k * ld + j] != 0.0f) {
        c = j;
        ++nnz;
      }
    }
    e.col[k] = c;
    unit = unit && nnz <= 1;
  }
  e.unit = __all_sync(FULL, unit);
  __syncwarp();

  float trace = 0.0f;
  for (int k = 0; k < nv; ++k) trace += e.M[k * ld + k];
  const float reg = 1e-10f * trace / static_cast<float>(nv);

  int it = 0;
  while (it < iterations) {
    compute_rows(e, lane);
    if (lane < nv) e.r[lane] = e.a[lane] - e.as[lane];
    __syncwarp();
    compute_forces(e, true, lane);
    __syncwarp();

    // g = M r - J' fs - cJ' fc, lane k holding g_k and (M r)_k
    float g = 0.0f, Mr = 0.0f;
    if (lane < nv) {
      for (int j = 0; j < nv; ++j) Mr += e.M[lane * ld + j] * e.r[j];
      float s1 = 0.0f, s2 = 0.0f;
      for (int q = 0; q < e.na; ++q) s1 += e.J[q * ld + lane] * e.f[q];
      for (int q = 0; q < 6 * e.nc; ++q) s2 += e.cJ[q * ld + lane] * e.f[e.na + q];
      g = Mr - s1 - s2;
    }
    compute_hessian(e, reg, lane);

    float Lrow[chol_warp::MAX_N];
    chol_warp::load_row(Lrow, e.H, nv, ld, lane);
    const float inv = chol_warp::factor(Lrow, e.H, nv, ld, lane);
    const float p = -chol_warp::solve(Lrow, e.H, nv, ld, inv, g, lane);
    if (lane < nv) e.p[lane] = p;
    __syncwarp();

    // projections for the line search: M p, J p, cJ p
    for (int i = lane; i < nv + e.na + 6 * e.nc; i += 32) {
      const float* row = i < nv ? e.M + i * ld : e.row(i - nv);
      float s1 = 0.0f;
      for (int k = 0; k < nv; ++k) s1 += row[k] * e.p[k];
      if (i < nv) e.Mp[i] = s1;
      else e.du[i - nv] = s1;
    }
    __syncwarp();
    const float pMp = warp_sum(lane < nv ? p * e.Mp[lane] : 0.0f);
    const float pMr = warp_sum(lane < nv ? p * Mr : 0.0f);

    // lo = the largest grid t with phi' < 0 (else 0), hi = the smallest with
    // phi' >= 0 (else the grid's end): grid point q on lanes q and q + 16,
    // then the bisections across the warp
    const int q = lane & 15;
    const float tq = q < GRID ? e.grid[q] : T_MAX;
    const bool neg = dphi_pair(e, tq, pMr, pMp, lane) < 0.0f && q < GRID;
    float lo = warp_max(neg ? tq : 0.0f);
    float hi = warp_min(neg ? T_MAX : tq);
    for (int b = 0; b < ls_iterations; ++b) {
      const float mid = 0.5f * (lo + hi);
      if (dphi_warp(e, mid, pMr, pMp, lane) < 0.0f) lo = mid;
      else hi = mid;
    }

    // accept a + t p; converged once max|t p| < tol (1 + max|a + t p|)
    const float t = 0.5f * (lo + hi);
    float st = 0.0f, an = 0.0f;
    if (lane < nv) {
      st = __fmul_rn(t, p);
      an = __fadd_rn(e.a[lane], st);
    }
    const bool finite = __all_sync(FULL, st == st && an == an);
    const float max_step = warp_max(fabsf(st));
    const float max_a = warp_max(fabsf(an));
    if (lane < nv) e.a[lane] = an;
    __syncwarp();
    ++it;
    if (finite && max_step < tol * (1.0f + max_a)) break;
  }

  // ---- forces at the final a, and the outputs ---------------------------------
  compute_rows(e, lane);
  __syncwarp();
  compute_forces(e, false, lane);
  __syncwarp();
  if (lane < nv) {
    qacc[env * nv + lane] = e.a[lane];
    qfrc_out[env * nv + lane] = constraint_force(e, lane);
  }
  for (int i = lane; i < ns; i += 32) {
    fs_out[env * ns + i] = slot[i] >= 0 ? e.f[slot[i]] : 0.0f;
  }
  for (int i = lane; i < R6; i += 32) {
    const int c = i / 6;
    const bool on = (cm >> c) & 1u;
    fc_out[env * R6 + i] = on ? e.f[e.na + 6 * rank(cm, c) + i - 6 * c] : 0.0f;
  }
  if (lane == 0 && iters_out != nullptr) iters_out[env] = it;
}

// Let a block take more than 48 KB of shared memory, and the SM give shared
// memory all it can. The attributes are set on a device's first launch and
// again only for a larger block, not before every launch.
constexpr int MAX_DEVICES = 64;
size_t configured[MAX_DEVICES] = {};   // the largest block allowed so far

cudaError_t configure(size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && configured[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(newton_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < MAX_DEVICES) configured[dev] = smem;
  return e;
}

// Envs per block at (nv, ns, C): MAX_WARPS where that many envs' shared
// memory fits in the most a block of the current device may take, else 1
// (cudaErrorInvalidValue where not even one env fits).
cudaError_t envs_per_block(int nv, int ns, int C, int* warps) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t per_env = env_bytes(nv, ns, C);
  if (per_env > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  *warps = MAX_WARPS * per_env <= static_cast<size_t>(optin) ? MAX_WARPS : 1;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every array is row-major,
// contiguous and batch-leading: M (B, nv, nv), a_smooth and a0 (B, nv), J
// (B, ns, nv), aref, R, frictionloss (B, ns), active (B, ns) bool, cJ (B, C,
// 6, nv), caref, cR, dm (B, C, 6), cactive (B, C) bool, mu (B, C, 5), grid
// (15,); outputs qacc, qfrc (B, nv), fs (B, ns), fc (B, C, 6) and, unless
// null, iters (B,) int32. nv must be the one the library was built for.
// Returns the CUDA error code of the launch (0 on success); the caller raises
// on anything else.
extern "C" int gqt_newton_fused_f32(
    const float* M, const float* a_smooth, const float* a0, const float* J,
    const float* aref, const float* R, const unsigned char* active, const float* fl,
    const float* cJ, const float* caref, const float* cR, const unsigned char* cactive,
    const float* mu, const float* dm, const float* grid, float* qacc, float* fs, float* fc,
    float* qfrc, int* iters, int B, int nv, int ns, int C, int iterations,
    int ls_iterations, float tol, void* stream) {
  if (B <= 0) return 0;
  if (nv != GQT_NV || ns < 0 || ns > MAX_NS || C < 0 || C > MAX_C || iterations < 0 ||
      ls_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = 0;
  cudaError_t e = envs_per_block(nv, ns, C, &warps);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = warps * env_bytes(nv, ns, C);
  e = configure(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + warps - 1) / warps;
  newton_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      M, a_smooth, a0, J, aref, R, active, fl, cJ, caref, cR, cactive, mu, dm, grid, qacc,
      fs, fc, qfrc, iters, B, ns, C, iterations, ls_iterations, tol);
  return static_cast<int>(cudaGetLastError());
}

// Residency at (nv, ns, C): blocks of one launch that one SM holds at a time,
// envs per block and shared-memory bytes per block. Returns the CUDA error
// code.
extern "C" int gqt_newton_fused_occupancy(int nv, int ns, int C, int* blocks_per_sm,
                                          int* envs_per_block_out, int* smem_per_block) {
  if (nv != GQT_NV || ns < 0 || ns > MAX_NS || C < 0 || C > MAX_C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = 0;
  cudaError_t e = envs_per_block(nv, ns, C, &warps);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = warps * env_bytes(nv, ns, C);
  *envs_per_block_out = warps;
  *smem_per_block = static_cast<int>(smem);
  e = configure(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, newton_kernel, 32 * warps, smem));
}
