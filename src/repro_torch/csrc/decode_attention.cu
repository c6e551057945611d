// One-token GQA attention over a KV cache (decode) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/decode_attention.py
// (decode_attention_kernel, pl.pallas_call at :81, body _kernel at :29).
// Same function: for each query head h of row b,
//   out[b, h] = softmax_c(mask(softcap(q[b, h] . k[b, c, h / G] * scale))) v[b, c, h / G]
// over the cache slots c with valid[b, c] set, float32 scores and
// accumulators, output in the input type. A row with no valid slot gives 0,
// as the TPU kernel does (masked probabilities and the 1e-30 clamp on the
// denominator). The model folds its causal and window masks into valid.
//
// What bounds it on an H100: bytes. Each valid slot costs one read of its
// K and V rows (2 * D elements) for 2 * G * D multiply-adds: at G = 2 that
// is about 1 operation per byte, far below the card's ratio. On the
// serving path (B = 8, C = 2048, Hkv = 8, G = 2, D = 128, bf16) the cache
// is 67 MB, so a call is bounded by reading the valid part of it once.
//
// Design: one block of 8 warps per (kv head, b); the G query rows of that
// kv head stay in registers (scaled, float32), so K and V are read once
// per kv head, never once per query head. Each warp walks its own slots,
// 4 at a time with all their loads issued before any use; it reads a
// slot's valid byte first and skips the K and V rows of an invalid slot.
// A slot's dot products are split over the warp's lanes (lane + 32 i of D)
// and summed with shuffles. Each warp keeps its own running max,
// denominator and accumulator; at the end the block merges the 8 partial
// softmaxes in shared memory (rescaling each by exp(m_w - max m)). The TPU
// kernel instead carried one running state across a sequential grid axis.
// Query groups wider than 4 heads are processed 4 heads per pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // slots a warp loads before it computes
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// NI: elements of D per lane (D <= 32 NI); GT: query heads per pass.
template <typename T, int NI, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ valid,
                            T* __restrict__ out, int c_len, int hq, int hkv, int d,
                            float softcap, float scale) {
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  extern __shared__ float sm_acc[];  // [kWarps][GT][d]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g_all = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t slot_step = static_cast<int64_t>(hkv) * d;
  const T* kb = k + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const T* vb = v + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const uint8_t* ok_b = valid + static_cast<int64_t>(b) * c_len;

  for (int g0 = 0; g0 < g_all; g0 += GT) {
    float qr[GT][NI], acc[GT][NI], m[GT], l[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const int head = hk * g_all + g0 + g;
      const bool live = g0 + g < g_all;
      m[g] = kNeg;
      l[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int col = lane + 32 * i;
        const T* qh = q + (static_cast<int64_t>(b) * hq + head) * d;
        qr[g][i] = (live && col < d) ? to_f32(qh[col]) * scale : 0.0f;
        acc[g][i] = 0.0f;
      }
    }

    for (int c0 = warp * kUnroll; c0 < c_len; c0 += kWarps * kUnroll) {
      bool ok[kUnroll];
      float kr[kUnroll][NI], vr[kUnroll][NI];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u;
        ok[u] = c < c_len && ok_b[c] != 0;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int col = lane + 32 * i;
          const bool in = ok[u] && col < d;
          kr[u][i] = in ? to_f32(kb[c * slot_step + col]) : 0.0f;
          vr[u][i] = in ? to_f32(vb[c * slot_step + col]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;  // uniform across the warp
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < NI; ++i) s = fmaf(qr[g][i], kr[u][i], s);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          m[g] = m_new;
#pragma unroll
          for (int i = 0; i < NI; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i] * alpha);
        }
      }
    }

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int col = lane + 32 * i;
        if (col < d) sm_acc[(warp * GT + g) * d + col] = acc[g][i];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < GT * d; e += kThreads) {
      const int g = e / d;
      const int col = e - g * d;
      if (g0 + g >= g_all) continue;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float den = 0.0f, num = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm_m[w][g] - mx);
        den = fmaf(sm_l[w][g], f, den);
        num = fmaf(sm_acc[(w * GT + g) * d + col], f, num);
      }
      const int head = hk * g_all + g0 + g;
      store(&out[(static_cast<int64_t>(b) * hq + head) * d + col], num / fmaxf(den, 1e-30f));
    }
    __syncthreads();  // shared memory is reused by the next pass
  }
}

template <typename T, int NI, int GT>
int launch(const T* q, const T* k, const T* v, const uint8_t* valid, T* out,
           int64_t b, int64_t c, int64_t hq, int64_t hkv, int64_t d, float softcap,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * GT * static_cast<size_t>(d);
  const dim3 grid(static_cast<unsigned>(hkv), static_cast<unsigned>(b));
  decode_attention_kernel<T, NI, GT><<<grid, kThreads, smem, stream>>>(
      q, k, v, valid, out, static_cast<int>(c), static_cast<int>(hq),
      static_cast<int>(hkv), static_cast<int>(d), softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NI>
int by_group(const T* q, const T* k, const T* v, const uint8_t* valid, T* out,
             int64_t b, int64_t c, int64_t hq, int64_t hkv, int64_t d, float softcap,
             float scale, cudaStream_t stream) {
  const int64_t g = hq / hkv;
  if (g == 1) return launch<T, NI, 1>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
  if (g == 2) return launch<T, NI, 2>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
  return launch<T, NI, 4>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const uint8_t* valid, T* out,
             int64_t b, int64_t c, int64_t hq, int64_t hkv, int64_t d, float softcap,
             float scale, cudaStream_t stream) {
  if (b <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 32) return by_group<T, 1>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
  if (d <= 64) return by_group<T, 2>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
  if (d <= 128) return by_group<T, 4>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
  return by_group<T, 8>(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
}

}  // namespace

// q (b, hq, d), k and v (b, c, hkv, d), valid (b, c) bytes (0 = masked),
// out (b, hq, d), all contiguous; d <= 256, hq % hkv == 0. softcap <= 0
// turns the softcap off. Returns the cudaError_t of the launch.
extern "C" int decode_attention_f32(const float* q, const float* k, const float* v,
                                    const uint8_t* valid, float* out, int64_t b,
                                    int64_t c, int64_t hq, int64_t hkv, int64_t d,
                                    float softcap, float scale, cudaStream_t stream) {
  return dispatch(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const uint8_t* valid,
                                     __nv_bfloat16* out, int64_t b, int64_t c,
                                     int64_t hq, int64_t hkv, int64_t d, float softcap,
                                     float scale, cudaStream_t stream) {
  return dispatch(q, k, v, valid, out, b, c, hq, hkv, d, softcap, scale, stream);
}
