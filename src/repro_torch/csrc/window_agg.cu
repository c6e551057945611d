// Causal sliding-window sum / mean / max for Hopper (sm_90a):
// out[t, c] = agg(x[lo..t, c]) with lo = max(t - w + 1, 0).
//
// Replaces the TPU kernel src/repro/kernels/window_agg/window_agg.py
// (window_agg_kernel, pl.pallas_call at :74, body _kernel at :26).
//
// What bounds it on an H100: bytes. Each output needs w adds (or maxes) and
// the whole call moves 8 bytes per element (read x once, write out once):
// at w = 16 that is 2 operations per byte, below the card's ~20 float32
// operations per byte.
//
// Design: a block owns tile_rows consecutive rows. It copies those rows and
// the w - 1 rows before them (the halo, clamped at row 0) into shared
// memory in one coalesced pass, then every thread reduces its outputs' <= w
// values from shared memory. Blocks carry nothing between them, so every
// input byte is read from device memory (1 + (w - 1) / tile_rows) times,
// about once. The TPU kernel instead mapped the previous block in as a
// second view and took cumulative-sum differences; that is a layout choice
// for its sequential grid, not part of the semantics. Direct window sums in
// float32 are also more exact than differences of a global prefix sum.
// The wrapper picks tile_rows and refuses a window whose halo does not fit
// in the 227 KB of shared memory a block may use.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

enum Agg : int64_t { kSum = 0, kMean = 1, kMax = 2 };

__global__ void window_agg_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t s,
                                  int64_t c64, int64_t w64, int64_t agg,
                                  int64_t tile_rows) {
  extern __shared__ float tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t r1 = imin(r0 + tile_rows, s);  // one past the tile's last row
  const int64_t first = imax(r0 - (w64 - 1), 0);
  // Inside the tile every index fits in 32 bits: the wrapper keeps
  // (tile_rows + w - 1) * c floats within a block's shared memory.
  const int c = static_cast<int>(c64);
  const int w = static_cast<int>(w64);
  const int halo = static_cast<int>(r0 - first);  // rows before the tile
  const int n_load = static_cast<int>((r1 - first) * c64);
  const float* src = x + first * c64;
  for (int e = threadIdx.x; e < n_load; e += blockDim.x) {
    tile[e] = src[e];
  }
  __syncthreads();
  float* dst = out + r0 * c64;
  const int n_out = static_cast<int>((r1 - r0) * c64);
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int row = e / c;  // output row within the tile
    const int col = e - row * c;
    const int hi = halo + row;  // its row in shared memory
    const int lo = max(hi - (w - 1), 0);  // clamps at sequence row 0 too
    const float* v = tile + lo * c + col;
    const int cnt = hi - lo + 1;
    float acc;
    if (agg == kMax) {
      acc = -INFINITY;
      for (int j = 0; j < cnt; ++j) acc = fmaxf(acc, v[j * c]);
    } else {
      acc = 0.0f;
      for (int j = 0; j < cnt; ++j) acc += v[j * c];
      if (agg == kMean) acc /= static_cast<float>(cnt);
    }
    dst[e] = acc;
  }
}

}  // namespace

// x, out (s, c) float32 row-major; 1 <= w; agg 0 sum, 1 mean, 2 max.
// Shared memory per block is (tile_rows + w - 1) * c floats; above 48 KB the
// kernel is opted in to the larger dynamic allocation first. Returns the
// cudaError_t of the launch.
extern "C" int window_agg_f32(const float* x, float* out, int64_t s,
                              int64_t c, int64_t w, int64_t agg,
                              int64_t tile_rows, cudaStream_t stream) {
  if (s <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>((tile_rows + w - 1) * c) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (s + tile_rows - 1) / tile_rows;
  window_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, out, s, c, w, agg, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
