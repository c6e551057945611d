// k-means assignment for Hopper (sm_90a): argmin_k ||x_i - c_k||^2 and its
// minimum, one thread per point.
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kmeans.py
// (kmeans_assign_kernel, pl.pallas_call at :47, body _kernel at :26).
//
// What bounds it on an H100: bytes. On the pipeline's path D is 2 or 3 and
// K <= 6, so each point costs D*K (<= 18) fused subtract/multiply/adds
// against 4*D + 8 bytes of device-memory traffic (read x_i, write assign_i
// and min_d2_i): about 2 operations per byte, far below the card's ~20
// float32 operations per byte. The design therefore reads each point once,
// keeps the K*D centroids in shared memory (staged in chunks of at most
// 48 KB when they are larger, or read through the cache when a single
// centroid row exceeds that), and writes two 4-byte results per point.
//
// Not carried over from the TPU kernel: the ||x||^2 - 2 x.c + ||c||^2
// expansion (it feeds the TPU's matrix unit and loses digits at small D),
// and the padding of D to 128 lanes and K to 8 rows. This kernel uses the
// direct sum of (x - c)^2 in float32, the form of the host backend and of
// the plain version, accumulated over d in order with rounded multiplies
// and adds (no fused multiply-add), so the three differ at most in the order
// of D additions. A running minimum with a strict '<' keeps the first index
// on ties, as argmin does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

__global__ void kmeans_assign_kernel(const float* __restrict__ x,
                                     const float* __restrict__ cent,
                                     int32_t* __restrict__ assign,
                                     float* __restrict__ min_d2, int64_t n,
                                     int64_t d, int64_t k,
                                     int64_t chunk_k) {
  extern __shared__ float staged[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float* xi = x + (live ? i : 0) * d;
  float best = INFINITY;
  int32_t best_k = 0;
  // chunk_k == 0: a centroid row does not fit in shared memory; read the
  // centroids through the cache (every thread reads the same address).
  const int64_t step = chunk_k > 0 ? chunk_k : k;
  for (int64_t k0 = 0; k0 < k; k0 += step) {
    const int64_t kc = imin(step, k - k0);
    const float* c = cent + k0 * d;
    if (chunk_k > 0) {
      __syncthreads();  // previous chunk fully consumed
      for (int64_t j = threadIdx.x; j < kc * d; j += blockDim.x) {
        staged[j] = c[j];
      }
      __syncthreads();
      c = staged;
    }
    if (live) {
      for (int64_t kk = 0; kk < kc; ++kk) {
        const float* ck = c + kk * d;
        float acc = 0.0f;
        for (int64_t j = 0; j < d; ++j) {
          const float t = __fsub_rn(xi[j], ck[j]);
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        }
        if (acc < best) {
          best = acc;
          best_k = static_cast<int32_t>(k0 + kk);
        }
      }
    }
  }
  if (live) {
    assign[i] = best_k;
    min_d2[i] = fmaxf(best, 0.0f);
  }
}

}  // namespace

// x (n, d), cent (k, d) float32 row-major; assign (n,) int32, min_d2 (n,)
// float32. chunk_k centroids are staged per pass (0: none are staged).
// Returns the cudaError_t of the launch.
extern "C" int kmeans_assign_f32(const float* x, const float* cent,
                                 int32_t* assign, float* min_d2, int64_t n,
                                 int64_t d, int64_t k, int64_t chunk_k,
                                 cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(chunk_k * d) * sizeof(float);
  kmeans_assign_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(x, cent, assign, min_d2, n, d, k, chunk_k);
  return static_cast<int>(cudaGetLastError());
}
