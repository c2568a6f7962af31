// Batched tiny-SPD solve A x = b for B independent systems, n <= 32, f32.
//
// Replaces the TPU kernel gym_quadruped_tpu/ops/spd_solve.py::_solve_kernel
// (an unrolled Cholesky on entry-major vectors, the env batch on the lanes).
// Same algorithm and numerics: Cholesky with the pivot clamped to
// sqrtf(fmaxf(s, 1e-30f)), a separately kept reciprocal diagonal that every
// division becomes a multiplication by, then forward and back substitution.
// Unlike the TPU version it reads the public layout as it is, A (B, n, n) and
// b (B, n) row-major and contiguous, with no transpose and no padding of the
// batch.
//
// What bounds it on an H100: at B = 4096, n = 18 it must move
// 4096 * (324 + 18 + 18) * 4 B = 5.9 MB (1.8 us at 3.35 TB/s) and compute
// about 4096 * (n^3/3 + 2 n^2) = 10.6 MFLOP (0.16 us at 67 TFLOP/s f32), so
// it is bound by memory, and at this size by the latency of the Cholesky's
// dependent steps and of the launch.
//
// Design: one warp factors and solves one system, WARPS systems to a block.
// Each warp stages its own A with coalesced loads into shared memory (row
// stride n | 1, odd, so the lanes owning rows hit different banks), runs the
// column-parallel warp Cholesky of csrc/chol_warp.cuh (lane i owns row i, in
// registers), solves with shuffles and writes x back, one float per lane. At
// B = 4096 that is 4,096 warps, all resident in one wave (4 blocks, 32 warps
// per SM), where one thread per system gave one warp per SM and nothing to
// hide the latency with. Warps never wait for each other: there is no block
// barrier, and the warps past the end of a ragged batch return at once. The
// kernel is compiled for one size, n = GQT_N (ops/spd_solve.py builds one
// library per size), so the Cholesky's loops have known trip counts and the
// compiler can overlap their steps. It launches on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

#ifndef GQT_N
#error "compile with -DGQT_N=<n>, the systems' size (1 to 32)"
#endif
static_assert(GQT_N >= 1 && GQT_N <= chol_warp::MAX_N, "GQT_N must be in 1..32");

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int B) {
  extern __shared__ float smem[];
  constexpr int n = GQT_N, ld = n | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sys = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (sys >= B) return;
  float* L = smem + warp * n * ld;
  const int nn = n * n;
  const float* gA = A + sys * nn;
  for (int i = lane, r = lane / n, c = lane % n; i < nn; i += 32) {
    L[r * ld + c] = gA[i];
    for (c += 32; c >= n; c -= n) ++r;
  }
  const float v = lane < n ? b[sys * n + lane] : 0.0f;
  __syncwarp();
  float row[chol_warp::MAX_N];
  chol_warp::load_row(row, L, n, ld, lane);
  const float inv = chol_warp::factor(row, L, n, ld, lane);
  const float xi = chol_warp::solve(row, L, n, ld, inv, v, lane);
  if (lane < n) x[sys * n + lane] = xi;
}

constexpr size_t SMEM_BYTES = sizeof(float) * WARPS * GQT_N * (GQT_N | 1);

}  // namespace

// Plain C entry point, loaded with ctypes. n must be the size the library was
// built for. Returns the CUDA error code of the launch (0 on success); the
// caller raises on anything else.
extern "C" int gqt_spd_solve_f32(const float* A, const float* b, float* x,
                                 int B, int n, void* stream) {
  if (B <= 0) return 0;
  if (n != GQT_N) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + WARPS - 1) / WARPS;
  spd_solve_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      A, b, x, B);
  return static_cast<int>(cudaGetLastError());
}

// Residency at size n: blocks of one launch that one SM holds at a time, and
// systems per block. Returns the CUDA error code.
extern "C" int gqt_spd_solve_occupancy(int n, int* blocks_per_sm, int* systems_per_block) {
  if (n != GQT_N) return static_cast<int>(cudaErrorInvalidValue);
  *systems_per_block = WARPS;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, spd_solve_kernel, THREADS, SMEM_BYTES));
}
