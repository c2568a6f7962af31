// One warp factors and solves one SPD system A x = b, n <= 32, f32.
//
// Shared by csrc/spd_solve.cu and csrc/newton_fused.cu, so the two kernels
// run one Cholesky code. The numerics are those of the reference's unrolled
// solve (gym_quadruped_tpu/ops/spd_solve.py) and of the port's plain version
// (ops/spd_solve.py::unrolled_chol_solve_torch): the pivot is clamped to
// sqrtf(fmaxf(s, 1e-30f)) and a reciprocal diagonal is kept, so every
// division is a multiplication.
//
// Column-parallel form: lane i owns row i of the matrix and keeps it in
// registers (`row`, fully unrolled loops to 32 with a uniform exit at n, so
// every index is a constant). Column j is scaled by the reciprocal pivot,
// each lane k > j broadcasts its l_kj with a shuffle, and every lane i >= k
// subtracts l_ij l_kj from its entry k: the subtractions of the plain
// version's trailing update, in its order. The forward substitution moves
// one value per step between lanes with a shuffle; the back substitution
// reads L's columns from the lower triangle the factor leaves in shared
// memory (row stride `ld`, odd, so the lanes hit 32 different banks). Every
// lane of the warp must call these functions.

#pragma once

#include <cuda_runtime.h>

namespace chol_warp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 32;

// Load the lane's row i of the n x n matrix at A (row stride ld) into row.
__device__ __forceinline__ void load_row(float (&row)[MAX_N], const float* A, int n, int ld,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < MAX_N; ++k) {
    if (k >= n) break;
    row[k] = lane < n ? A[lane * ld + k] : 0.0f;
  }
}

// L L' = A in the lanes' rows: row k < i becomes L_ik, row i keeps the pivot
// before its square root. Returns the lane's reciprocal pivot 1 / L_ii (0 on
// lanes i >= n). Then stores the lower triangle to L (row stride ld) for the
// back substitution.
__device__ __forceinline__ float factor(float (&row)[MAX_N], float* L, int n, int ld,
                                        int lane) {
  float inv = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j >= n) break;
    const float r = 1.0f / sqrtf(fmaxf(__shfl_sync(FULL, row[j], j), 1e-30f));
    if (lane == j) inv = r;
    const float l = row[j] * r;
    if (lane > j) row[j] = l;
#pragma unroll
    for (int k = j + 1; k < MAX_N; ++k) {
      if (k >= n) break;
      const float lk = __shfl_sync(FULL, l, k);
      if (lane >= k) row[k] -= l * lk;
    }
  }
  if (lane < n) {
#pragma unroll
    for (int k = 0; k < MAX_N; ++k) {
      if (k > lane) break;
      L[lane * ld + k] = row[k];
    }
  }
  __syncwarp();
  return inv;
}

// x = (L L')^-1 b from the factor above: lane i holds b_i in v and gets x_i
// back (lanes i >= n get 0).
__device__ __forceinline__ float solve(const float (&row)[MAX_N], const float* L, int n, int ld,
                                       float inv, float v, int lane) {
  if (lane >= n) v = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_N; ++i) {                  // L y = b
    if (i >= n) break;
    const float yi = __shfl_sync(FULL, v * inv, i);
    if (lane == i) v = yi;
    else if (lane > i) v -= row[i] * yi;
  }
  for (int i = n - 1; i >= 0; --i) {                 // L' x = y
    const float xi = __shfl_sync(FULL, v * inv, i);
    if (lane == i) v = xi;
    else if (lane < i) v -= L[i * ld + lane] * xi;
  }
  return v;
}

}  // namespace chol_warp
