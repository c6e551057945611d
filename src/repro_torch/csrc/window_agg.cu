// Causal sliding-window sum / mean / max for Hopper (sm_90a):
// out[t, c] = agg(x[lo..t, c]) with lo = max(t - w + 1, 0).
//
// Replaces the TPU kernel src/repro/kernels/window_agg/window_agg.py
// (window_agg_kernel, pl.pallas_call at :74, body _kernel at :26).
//
// What bounds it on an H100: bytes. The call moves 8 bytes per element (read
// x once, write out once): 16 MB at the pipeline's (500,000, 4), under 5 us
// at the memory's rate, against O(1) or O(log w) operations per output here.
//
// Two kernels; the wrapper picks one by shape (window_plan in ops.py):
//
// * scan (C = 4, w <= 32, x 16-byte aligned; every call of the pipeline),
//   templated on agg. A warp walks 8 consecutive chunks of 32 rows; lane l
//   holds row 32m + l of chunk m as one float4, so every load and store is
//   one coalesced 512-byte access, and no shared memory or barrier is used.
//   A warp first issues the loads of all its chunks and of the chunk before
//   them (its halo), then works from registers. Sum and mean take, as the
//   TPU kernel does (window_agg.py:35-46), differences of prefix sums that
//   are local to a chunk: P_m is chunk m's inclusive prefix (a Hillis-Steele
//   scan over the warp, 5 shuffles a component), and a window that starts in
//   chunk m - 1 adds the suffix P_{m-1}[31] - P_{m-1}[32 + l - w]:
//       S = l >= w ? P_m[l] - P_m[l - w] : P_m[l] + (P_{m-1}[31] - P_{m-1}[32 + l - w]).
//   The prefix never spans more than 32 rows, so the differences lose no
//   more than a few float32 units of a 32-row sum (the plain version sums
//   in float64; the CPU tests model this order in numpy at the pipeline's
//   size). Rows before row 0 read as 0, and the mean divides by
//   min(t + 1, w) with an IEEE division. Max is exact: doubling over the 64
//   rows of chunks m - 1 and m (M_2d[i] = max(M_d[i], M_d[i - d]), log2 w
//   levels), then max(M_p[t], M_p[t - w + p]) with p the largest power of
//   two <= w; rows before row 0 read as -inf.
// * general (any C, w; the port's first kernel): a block owns tile_rows
//   consecutive rows, copies them and the w - 1 rows before them (the halo,
//   clamped at row 0) into shared memory in one coalesced pass, and every
//   thread reduces its outputs' <= w values from shared memory with direct
//   float32 sums. The wrapper picks tile_rows and refuses a window whose
//   halo does not fit in the 227 KB of shared memory a block may use.
//
// Both kernels are free of atomics: each case gives the same bits on every
// run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Agg : int64_t { kSum = 0, kMean = 1, kMax = 2 };

// -- scan kernel ---------------------------------------------------------------

constexpr int kScanWarps = 4;   // warps a block
constexpr int kChunks = 8;      // 32-row chunks a warp walks
constexpr int kMaxWindow = 32;  // a window spans at most two chunks
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
                     __fsub_rn(a.w, b.w));
}
__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}
__device__ __forceinline__ float4 div4(float4 a, float b) {
  return make_float4(__fdiv_rn(a.x, b), __fdiv_rn(a.y, b), __fdiv_rn(a.z, b),
                     __fdiv_rn(a.w, b));
}
__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}
__device__ __forceinline__ float4 shfl_up4(float4 v, unsigned d) {
  return make_float4(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d),
                     __shfl_up_sync(kFull, v.z, d), __shfl_up_sync(kFull, v.w, d));
}
__device__ __forceinline__ float4 pick4(bool c, float4 a, float4 b) { return c ? a : b; }

// Inclusive prefix sum of v over the warp's lanes (Hillis-Steele).
__device__ __forceinline__ float4 warp_prefix(float4 v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float4 t = shfl_up4(v, d);
    if (lane >= d) v = add4(v, t);
  }
  return v;
}

// Sliding max over the 64 rows prev (rows 0-31) ++ cur (rows 32-63) for the
// windows ending at cur's rows: levels M_d of doubling, d = 1, 2, 4, ...
__device__ __forceinline__ float4 window_max(float4 prev, float4 cur, int lane, int w) {
  int p = 1;
  while (2 * p <= w) {  // M_2p[i] = max(M_p[i], M_p[i - p]); i - p >= 0 where used
    const float4 prev_up = shfl_up4(prev, p);
    const float4 cur_up = shfl_up4(cur, p);
    const float4 wrap = shfl4(prev, (lane - p) & 31);
    cur = max4(cur, pick4(lane >= p, cur_up, wrap));
    prev = max4(prev, prev_up);
    p *= 2;
  }
  const int back = w - p;  // max(M_p[i], M_p[i - (w - p)]), 0 <= w - p < p
  const float4 cur_back = shfl_up4(cur, back);
  const float4 wrap = shfl4(prev, (lane - back) & 31);
  return max4(cur, pick4(lane >= back, cur_back, wrap));
}

template <int AGG>
__global__ void __launch_bounds__(kScanWarps * 32)
    window_scan_kernel(const float4* __restrict__ x, float4* __restrict__ out, int64_t s,
                       int w) {
  const int lane = threadIdx.x & 31;
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kScanWarps + threadIdx.x / 32) * kChunks;
  const int64_t n_chunks = (s + 31) / 32;
  if (m0 >= n_chunks) return;  // the whole warp
  const float fill = AGG == kMax ? -INFINITY : 0.0f;
  const float4 pad = make_float4(fill, fill, fill, fill);
  float4 v[kChunks + 1];  // chunks m0 - 1 .. m0 + kChunks - 1
#pragma unroll
  for (int j = 0; j <= kChunks; ++j) {
    const int64_t row = (m0 - 1 + j) * 32 + lane;
    v[j] = row >= 0 && row < s ? __ldg(x + row) : pad;
  }
  float4 prev = AGG == kMax ? v[0] : warp_prefix(v[0], lane);
#pragma unroll
  for (int j = 1; j <= kChunks; ++j) {
    const int64_t m = m0 - 1 + j;
    if (m >= n_chunks) break;
    const int64_t row = m * 32 + lane;
    float4 r;
    if (AGG == kMax) {
      r = window_max(prev, v[j], lane, w);
      prev = v[j];
    } else {
      const float4 cur = warp_prefix(v[j], lane);
      const int src = (lane - w) & 31;
      const float4 back = shfl4(cur, src);
      const float4 wrap = shfl4(prev, src);
      const float4 total = shfl4(prev, 31);
      r = lane >= w ? sub4(cur, back) : add4(cur, sub4(total, wrap));
      if (AGG == kMean) r = div4(r, static_cast<float>(row + 1 < w ? row + 1 : w));
      prev = cur;
    }
    if (row < s) out[row] = r;
  }
}

void* scan_instance(int64_t agg) {
  switch (agg) {
    case kSum: return reinterpret_cast<void*>(window_scan_kernel<kSum>);
    case kMean: return reinterpret_cast<void*>(window_scan_kernel<kMean>);
    case kMax: return reinterpret_cast<void*>(window_scan_kernel<kMax>);
    default: return nullptr;
  }
}

// -- general kernel --------------------------------------------------------------

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

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

// Scan kernel: x, out (s, 4) float32 row-major, 16-byte aligned;
// 1 <= w <= 32; agg 0 sum, 1 mean, 2 max; `blocks` blocks of 4 warps, 8
// chunks of 32 rows a warp. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue outside the kernel's range).
extern "C" int window_agg_scan_f32(const float* x, float* out, int64_t s, int64_t w,
                                   int64_t agg, int64_t blocks, cudaStream_t stream) {
  void* fn = scan_instance(agg);
  if (fn == nullptr || w < 1 || w > kMaxWindow) return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 0) return static_cast<int>(cudaSuccess);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  int w32 = static_cast<int>(w);
  void* args[] = {&x4, &out4, &s, &w32};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                                           dim3(kScanWarps * 32), args, 0, stream));
}

// General kernel: x, out (s, c) float32 row-major; 1 <= w; agg 0 sum, 1
// mean, 2 max. Shared memory per block is (tile_rows + w - 1) * c floats;
// above 48 KB the kernel is opted in to the larger dynamic allocation first.
// Returns the cudaError_t of the launch.
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

// Registers a thread, static shared memory a block and local (spill) bytes
// a thread of the scan kernel for agg, or of the general kernel when
// scan == 0; into out[0..2]. Returns the cudaError_t of the query.
extern "C" int window_agg_attributes(int64_t scan, int64_t agg, int* out) {
  const void* fn = scan ? scan_instance(agg) : reinterpret_cast<const void*>(window_agg_kernel);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
