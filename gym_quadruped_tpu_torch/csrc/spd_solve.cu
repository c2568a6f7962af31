// Batched tiny-SPD solve A x = b for B independent systems, n <= 32, f32.
//
// Replaces the TPU kernel gym_quadruped_tpu/ops/spd_solve.py::_solve_kernel
// (an unrolled Cholesky on entry-major vectors, the env batch on the lanes).
// Same algorithm and numerics: Cholesky with the pivot clamped to
// sqrtf(fmaxf(s, 1e-30f)), a separately kept reciprocal diagonal that every
// division becomes a multiplication by, then forward and back substitution.
// Unlike the TPU version it reads the public layout as it is, A (B, n, n) and
// b (B, n) row-major and contiguous, with no transpose and no padding of the
// batch: a block masks the ragged end of the batch itself.
//
// What bounds it on an H100: at B = 4096, n = 18 it must move
// 4096 * (324 + 18 + 18) * 4 B = 5.9 MB (1.8 us at 3.35 TB/s) and compute
// about 4096 * (n^3/3 + 2 n^2) = 10.6 MFLOP (0.16 us at 67 TFLOP/s f32), so
// it is bound by memory, and at this size by launch latency.
//
// Design (simple first): one block stages a tile of TILE systems into shared
// memory with coalesced loads, one thread then factors and solves one system
// in place, and the block writes the solutions back coalesced. Each system's
// stride in shared memory is odd, so the 32 threads of a warp, each reading
// the same entry of its own system, hit 32 different banks. At n = 18 a tile
// takes 32 * (325 + 2 * 19) * 4 B = 46 KB; B = 4096 gives 128 blocks on 132
// SMs. The kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;

__global__ void spd_solve_kernel(const float* __restrict__ A,
                                 const float* __restrict__ b,
                                 float* __restrict__ x, int B, int n,
                                 int strideA, int strideV) {
  extern __shared__ float smem[];
  float* sA = smem;                            // TILE systems, stride strideA
  float* sV = sA + TILE * strideA;             // b, then y, then x, stride strideV
  float* sInv = sV + TILE * strideV;           // reciprocal diagonal

  const int first = blockIdx.x * TILE;
  const int count = min(TILE, B - first);
  const int nn = n * n;

  // coalesced staging: consecutive threads read consecutive floats
  const float* gA = A + static_cast<long long>(first) * nn;
  for (int i = threadIdx.x; i < count * nn; i += blockDim.x) {
    sA[(i / nn) * strideA + i % nn] = gA[i];
  }
  const float* gb = b + static_cast<long long>(first) * n;
  for (int i = threadIdx.x; i < count * n; i += blockDim.x) {
    sV[(i / n) * strideV + i % n] = gb[i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < count) {
    float* a = sA + t * strideA;
    float* v = sV + t * strideV;
    float* inv = sInv + t * strideV;
    // Cholesky: L overwrites the lower triangle of a
    for (int j = 0; j < n; ++j) {
      float s = a[j * n + j];
      for (int k = 0; k < j; ++k) s = s - a[j * n + k] * a[j * n + k];
      const float d = sqrtf(fmaxf(s, 1e-30f));
      const float r = 1.0f / d;
      a[j * n + j] = d;
      inv[j] = r;
      for (int i = j + 1; i < n; ++i) {
        float s2 = a[i * n + j];
        for (int k = 0; k < j; ++k) s2 = s2 - a[i * n + k] * a[j * n + k];
        a[i * n + j] = s2 * r;
      }
    }
    // forward substitution L y = b
    for (int i = 0; i < n; ++i) {
      float s = v[i];
      for (int k = 0; k < i; ++k) s = s - a[i * n + k] * v[k];
      v[i] = s * inv[i];
    }
    // back substitution L' x = y
    for (int i = n - 1; i >= 0; --i) {
      float s = v[i];
      for (int k = i + 1; k < n; ++k) s = s - a[k * n + i] * v[k];
      v[i] = s * inv[i];
    }
  }
  __syncthreads();

  float* gx = x + static_cast<long long>(first) * n;
  for (int i = threadIdx.x; i < count * n; i += blockDim.x) {
    gx[i] = sV[(i / n) * strideV + i % n];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the CUDA error code of the
// launch (0 on success); the caller raises on anything else.
extern "C" int gqt_spd_solve_f32(const float* A, const float* b, float* x,
                                 int B, int n, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int strideA = (n * n) | 1;
  const int strideV = n | 1;
  const size_t smem = sizeof(float) * TILE * (strideA + 2 * strideV);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + TILE - 1) / TILE;
  spd_solve_kernel<<<blocks, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      A, b, x, B, n, strideA, strideV);
  return static_cast<int>(cudaGetLastError());
}
