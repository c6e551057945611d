// Blockwise online-softmax attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, pl.pallas_call at :112, body _kernel at :29).
// Same function: out = softmax(mask(softcap(q k^T * scale))) v per head,
// with causal, sliding-window (k > q - window) and tanh-softcap masks, keys
// at or past seq_len masked, float32 scores and accumulators, output in the
// input type. GQA: query head h reads kv head h / (Hq / Hkv); the kv heads
// are never repeated in memory (the TPU wrapper repeated them).
//
// What bounds it on an H100: operations. On the serving path (B = 1,
// S = 128..1536, Hq = 16, Hkv = 8, D = 128, bf16, causal) a call does
// ~2 * Hq * S^2 * D floating-point operations (the causal half of q k^T and
// of p v) against S * (Hq + 2 Hkv + Hq) * D * 2 bytes of input and output:
// ~500 operations per byte at S = 1536, above the card's ~295 bf16
// tensor-core operations per byte. This first version
// computes on the CUDA cores in float32 (fused multiply-adds), so its own
// ceiling is the 67 TFLOP/s float32 rate, not the tensor cores'; a
// wgmma/TMA version is later work.
//
// Design: one block of 128 threads per (q tile of 64 rows, b * Hq + h).
// The block keeps its q tile (scaled, float32, transposed) in shared
// memory and walks the k tiles its masks can reach (causal: up to the
// diagonal; window: from q0 - window + 1), staging each 64-row k tile
// (transposed) and v tile in shared memory. Each thread owns a 4 x 8
// micro-tile of the 64 x 64 scores (rows 4 ty .. 4 ty + 3, columns tx + 8 j)
// and the same 4 rows of the output accumulator (columns tx + 8 j of D), so
// the running max and denominator of a row live in the 8 lanes that share
// it and are combined with warp shuffles. Probabilities pass through
// shared memory (transposed) into the P V product. Nothing carries between
// blocks; q tiles are issued longest-first (the causal diagonal makes late
// tiles the longest). Padded rows and keys never leave the block: the
// kernel reads (B, S, H, D) directly and masks the ragged edge itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles (floats)
constexpr float kNeg = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

size_t smem_bytes(int d) {
  // q^T [d][kLd], k^T [d][kLd], v [kBK][d], p^T [kBK][kLd]
  return sizeof(float) * (static_cast<size_t>(2 * d * kLd) + kBK * d + kBK * kLd);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int s_len,
                           int hq, int hkv, int d, int causal, int window,
                           float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [d][kLd]  q * scale, transposed
  float* kt = qt + d * kLd;       // [d][kLd]  k tile, transposed
  float* vs = kt + d * kLd;       // [kBK][d]  v tile
  float* pt = vs + kBK * d;       // [kBK][kLd] probabilities, transposed

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int64_t q_step = static_cast<int64_t>(hq) * d;   // next position
  const int64_t kv_step = static_cast<int64_t>(hkv) * d;
  const T* qb = q + (static_cast<int64_t>(b) * s_len * hq + h) * d;
  const T* kb = k + (static_cast<int64_t>(b) * s_len * hkv + hk) * d;
  const T* vb = v + (static_cast<int64_t>(b) * s_len * hkv + hk) * d;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int pos = q0 + r;
    qt[c * kLd + r] = pos < s_len ? to_f32(qb[pos * q_step + c]) * scale : 0.0f;
  }

  constexpr int kDJ = DMAX / 8;  // output columns per thread
  float m[4], l[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.0f;
  }

  int kt_lo = 0;
  int kt_hi = (s_len + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / kBK);

  for (int kti = kt_lo; kti < kt_hi; ++kti) {
    const int k0 = kti * kBK;
    __syncthreads();  // the previous tile is consumed (and q^T is written)
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const int pos = k0 + r;
      const bool in = pos < s_len;
      kt[c * kLd + r] = in ? to_f32(kb[pos * kv_step + c]) : 0.0f;
      vs[r * d + c] = in ? to_f32(vb[pos * kv_step + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[c * kLd + 4 * ty]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kt[c * kLd + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool ok[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = sc[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        ok[j] = kpos < s_len && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        sc[i][j] = ok[j] ? x : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float row = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        row += p[i][j];
      }
      l[i] = l[i] * alpha + row;  // this lane's share; lanes are summed at the end
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(&pt[(tx + 8 * j) * kLd + 4 * ty]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pt[c * kLd + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int col = tx + 8 * j;
        if (col < d) {
          const float vv = vs[c * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= s_len) continue;
    const float denom = fmaxf(li, 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * s_len + qpos) * hq + h) * d;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int col = tx + 8 * j;
      if (col < d) store(&orow[col], acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const T* q, const T* k, const T* v, T* out, int64_t b, int64_t s,
           int64_t hq, int64_t hkv, int64_t d, int64_t causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = smem_bytes(static_cast<int>(d));
  // opt in above 48 KB once per instantiation and size, so that a launch
  // inside CUDA-graph capture makes no attribute call
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(b * hq));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, static_cast<int>(s),
                                           static_cast<int>(hq), static_cast<int>(hkv),
                                           static_cast<int>(d), static_cast<int>(causal),
                                           static_cast<int>(window), softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int64_t b, int64_t s,
             int64_t hq, int64_t hkv, int64_t d, int64_t causal, int64_t window,
             float softcap, float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 64) return launch<T, 64>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  return launch<T, 256>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

}  // namespace

// q (b, s, hq, d), k and v (b, s, hkv, d), out (b, s, hq, d), all
// contiguous; d <= 256, hq % hkv == 0. softcap <= 0 turns the softcap off,
// window <= 0 the window. Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* out, int64_t b, int64_t s, int64_t hq,
                                   int64_t hkv, int64_t d, int64_t causal,
                                   int64_t window, float softcap, float scale,
                                   cudaStream_t stream) {
  return dispatch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out,
                                    int64_t b, int64_t s, int64_t hq, int64_t hkv,
                                    int64_t d, int64_t causal, int64_t window,
                                    float softcap, float scale, cudaStream_t stream) {
  return dispatch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}
