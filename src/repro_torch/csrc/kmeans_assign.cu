// k-means assignment for Hopper (sm_90a): argmin_k ||x_i - c_k||^2 and its
// minimum.
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kmeans.py
// (kmeans_assign_kernel, pl.pallas_call at :47, body _kernel at :26).
//
// What bounds it on an H100: bytes. On the pipeline's path N is 500,000, D
// is 2 or 3 and K <= 6, so each point costs D*K (<= 18) subtract/multiply/
// adds against 4*D + 8 bytes of traffic (read x_i, write assign_i and
// min_d2_i): about 2 operations per byte, far below the card's ~20 float32
// operations per byte. The whole call moves 8-10 MB, a few microseconds at
// the memory's rate, so what remains is the latency of a short kernel:
// little memory in flight per thread, a second wave of blocks, barriers.
//
// Two kernels; the wrapper picks one by shape (kmeans_plan in ops.py):
//
// * tiled (D <= 4, K <= 16; every call of the pipeline): templated on D and
//   on a bound KMAX >= K, so both loops unroll and a thread keeps its points
//   and all K*D centroids in registers. A thread owns 4 consecutive points:
//   it reads their 4*D floats as D 16-byte loads (a scalar variant serves an
//   x whose data_ptr is not 16-byte aligned, e.g. the view x[1:]), and writes
//   its 4 assignments and 4 distances as one int4 and one float4. 128
//   threads a block give 977 blocks at N = 500,000, one wave on 132 SMs. The
//   centroids stay on the device between Lloyd steps (the update writes
//   them), so passing them by value would cost a copy to the host and a
//   synchronisation per step; instead every thread reads them once from
//   device memory at one address across the warp (a broadcast, from L1 after
//   the first warp of the SM), with no shared memory and no barrier. The
//   ragged tail (N % 4 != 0) takes scalar loads and stores.
// * general (any D, K; the port's first kernel): one thread per point, the
//   K*D centroids staged in shared memory in chunks of at most 48 KB, or
//   read through the cache when one centroid row exceeds that.
//
// Not carried over from the TPU kernel: the ||x||^2 - 2 x.c + ||c||^2
// expansion (it feeds the TPU's matrix unit and loses digits at small D),
// and the padding of D to 128 lanes and K to 8 rows. Both kernels take the
// direct sum of (x - c)^2 in float32, the form of the host backend and of
// the plain version, accumulated over d in order with rounded multiplies
// and adds (no fused multiply-add), so the three differ at most in the order
// of D additions, and the two kernels give the same bits. A running minimum
// with a strict '<' keeps the first index on ties, as argmin does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// -- tiled kernel --------------------------------------------------------------

constexpr int kTiledThreads = 128;
constexpr int kPoints = 4;  // consecutive points a thread owns

template <int D, int KMAX, bool VEC>
__global__ void __launch_bounds__(kTiledThreads)
    kmeans_tiled_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                        int32_t* __restrict__ assign, float* __restrict__ min_d2,
                        int64_t n, int k) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kTiledThreads + threadIdx.x) * kPoints;
  if (i0 >= n) return;
  float c[KMAX * D];
#pragma unroll
  for (int j = 0; j < KMAX * D; ++j) c[j] = j < k * D ? __ldg(cent + j) : 0.0f;

  const bool full = i0 + kPoints <= n;
  const float* src = x + i0 * D;
  float xv[kPoints * D];
  if (VEC && full) {  // 4 points = D float4s, 16-byte aligned
#pragma unroll
    for (int q = 0; q < D; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
      xv[4 * q] = v.x;
      xv[4 * q + 1] = v.y;
      xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
  } else {
    const int64_t avail = (n - i0) * D;  // floats left from src
#pragma unroll
    for (int j = 0; j < kPoints * D; ++j) xv[j] = j < avail ? __ldg(src + j) : 0.0f;
  }

  float best[kPoints];
  int32_t best_k[kPoints];
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    best[p] = INFINITY;
    best_k[p] = 0;
  }
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= k) break;
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float t = __fsub_rn(xv[p * D + j], c[kk * D + j]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
      if (acc < best[p]) {
        best[p] = acc;
        best_k[p] = kk;
      }
    }
  }
  if (full) {  // outputs are fresh allocations: i0 * 4 bytes is 16-byte aligned
    *reinterpret_cast<int4*>(assign + i0) = make_int4(best_k[0], best_k[1], best_k[2], best_k[3]);
    *reinterpret_cast<float4*>(min_d2 + i0) =
        make_float4(fmaxf(best[0], 0.0f), fmaxf(best[1], 0.0f), fmaxf(best[2], 0.0f),
                    fmaxf(best[3], 0.0f));
  } else {
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      if (i0 + p < n) {
        assign[i0 + p] = best_k[p];
        min_d2[i0 + p] = fmaxf(best[p], 0.0f);
      }
    }
  }
}

// The instance for (d, kmax, vec), or nullptr outside the templates.
template <int D, int KMAX>
void* pick_vec(bool vec) {
  return vec ? reinterpret_cast<void*>(kmeans_tiled_kernel<D, KMAX, true>)
             : reinterpret_cast<void*>(kmeans_tiled_kernel<D, KMAX, false>);
}

template <int D>
void* pick_kmax(int64_t kmax, bool vec) {
  switch (kmax) {
    case 4: return pick_vec<D, 4>(vec);
    case 8: return pick_vec<D, 8>(vec);
    case 16: return pick_vec<D, 16>(vec);
    default: return nullptr;
  }
}

void* tiled_instance(int64_t d, int64_t kmax, bool vec) {
  switch (d) {
    case 1: return pick_kmax<1>(kmax, vec);
    case 2: return pick_kmax<2>(kmax, vec);
    case 3: return pick_kmax<3>(kmax, vec);
    case 4: return pick_kmax<4>(kmax, vec);
    default: return nullptr;
  }
}

// -- general kernel --------------------------------------------------------------

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

// Tiled kernel: x (n, d), cent (k, d) float32 row-major, 1 <= d <= 4,
// 1 <= k <= kmax, kmax in {4, 8, 16}; vec != 0 reads x in 16-byte loads
// (x 16-byte aligned); assign (n,) int32 and min_d2 (n,) float32 16-byte
// aligned; `blocks` blocks of 128 threads, 4 points a thread. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue outside the templates).
extern "C" int kmeans_assign_tiled_f32(const float* x, const float* cent,
                                       int32_t* assign, float* min_d2, int64_t n,
                                       int64_t d, int64_t k, int64_t kmax,
                                       int64_t vec, int64_t blocks,
                                       cudaStream_t stream) {
  void* fn = tiled_instance(d, kmax, vec != 0);
  if (fn == nullptr || k < 1 || k > kmax) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int k32 = static_cast<int>(k);
  void* args[] = {&x, &cent, &assign, &min_d2, &n, &k32};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                                           dim3(kTiledThreads), args, 0, stream));
}

// General kernel: x (n, d), cent (k, d) float32 row-major; assign (n,)
// int32, min_d2 (n,) float32. chunk_k centroids are staged per pass (0:
// none are staged). Returns the cudaError_t of the launch.
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

// Registers a thread, static shared memory a block and local (spill) bytes
// a thread of the tiled instance (d, kmax, vec), or of the general kernel
// when tiled == 0; into out[0..2]. Returns the cudaError_t of the query.
extern "C" int kmeans_assign_attributes(int64_t tiled, int64_t d, int64_t kmax,
                                        int64_t vec, int* out) {
  const void* fn = tiled ? tiled_instance(d, kmax, vec != 0)
                         : reinterpret_cast<const void*>(kmeans_assign_kernel);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
