// One-token GQA attention over a KV cache (decode) for Hopper (sm_90a),
// split over the cache.
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
// serving path (B = 8, C = 2048, Hkv = 8, G = 2, D = 128, bf16) a call is
// bounded by reading the valid part of the 67 MB cache once at 3.35 TB/s.
// Reaching that rate takes enough bytes in flight on every SM: about
// 20 KB an SM at HBM's latency.
//
// Design: two kernels. The first, decode_split_kernel, runs one block of
// 8 warps per (cache split, kv head, b): the wrapper's split_plan cuts C
// into n_split ranges so that B * Hkv * n_split blocks give every SM at
// least two (512 blocks at the serving shape, where B * Hkv alone is 64).
// (b, kv head) is the fastest grid index, so a cache filled from slot 0
// has its busy low splits scheduled first and its empty high ones last.
// A block reads its split's valid bytes in chunks of 256, one coalesced
// byte per thread, and compacts the valid slots into a list in shared
// memory (warp ballots and a prefix over the warps), so invalid slots cost
// no K or V traffic and scattered masks keep the warps balanced. K and V
// rows arrive as 16-byte vectors: at D = 128 in bf16, 16 lanes hold one
// slot's row, so a warp loads 2 slots an instruction and 4 slots a round,
// into one of two register buffers: the next round's loads are in flight
// while a round is computed, 8 slots a warp. The G query rows of the kv
// head stay in registers (scaled, float32), so K and V are read once per
// kv head. Each group of lanes keeps a running max, denominator and
// accumulator; the block merges them (shuffles within a warp, shared
// memory across warps) and writes its partial (m, l, acc[D]) in float32
// to scratch that the wrapper allocates. A split with no valid slot writes
// m = -1e30, l = 0. The second kernel, decode_combine_kernel, merges the
// n_split partials of each (b, h) in split order (each step rescales the
// running sums and the partial to their common max, so each partial ends
// scaled by exp(m_s - max m)) and divides by the denominator clamped at
// 1e-30: no atomics, so a call is deterministic. A D that does not allow
// 16-byte loads (D not a multiple of 16 bytes, or a misaligned pointer)
// loads element by element inside the same kernel, into the same register
// layout (a uniform branch on a kernel argument). Query groups wider than
// 8 heads are processed 8 heads per pass. The TPU kernel instead carried
// one running state across a sequential grid axis.
//
// D > 256 (float32 and bf16): decode_wide_kernel, a simple CUDA-core
// variant that writes the same partials for the same combine, for head
// dims whose rows would not fit the split kernel's registers (the TPU
// wrapper takes any D). One block of 4 warps per (b * Hq + h, split,
// 128-column chunk of the output): each warp takes every fourth valid
// slot of the split, computes q . k over all of D with its lanes on
// consecutive columns and a shuffle sum, and keeps a running max,
// denominator and 4 output columns a lane; the warps merge through shared
// memory. Each chunk and query head reads K again, so it reads G * D / 128
// times the bytes the split kernel reads. No head config of the repo
// reaches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;  // valid bytes compacted at a time
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// A 16-byte vector of T, unpacked to float32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  __device__ static float scalar(const float* p) { return *p; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 is the top half of a float
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

// Lane l of a slot group (LPS lanes per slot) owns the VEC-element vectors
// nv * LPS + l % LPS of a row, nv < NV.
template <typename T, int LPS, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int d, int sl, bool ok,
                                         bool vector, uint4 (&raw)[NV]) {
  constexpr int VEC = Vec<T>::kN;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    const int col = (nv * LPS + sl) * VEC;
    raw[nv] = make_uint4(0, 0, 0, 0);
    if (!ok || col >= d) continue;
    if (vector) {
      raw[nv] = __ldg(reinterpret_cast<const uint4*>(row + col));
    } else {  // element by element, packed into the same register layout
      T tmp[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = col + e < d ? row[col + e] : T(0.0f);
      memcpy(&raw[nv], tmp, sizeof(tmp));
    }
  }
}

// Merge (m_o, l_o, acc_o) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N], float m_o,
                                      float l_o, const float (&acc_o)[N]) {
  const float m_n = fmaxf(m, m_o);
  const float f = __expf(m - m_n);
  const float f_o = __expf(m_o - m_n);
  l = l * f + l_o * f_o;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * f + acc_o[i] * f_o;
  m = m_n;
}

// LPS: lanes per slot (a power of two); NV: 16-byte vectors per lane;
// GT: query heads per pass; U: slot loads a lane issues before computing.
// vector: K and V rows allow 16-byte loads (else element by element).
template <typename T, int LPS, int NV, int GT, int U>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        float* __restrict__ part_acc, float* __restrict__ part_ml,
                        int b_len, int c_len, int hq, int hkv, int d, int split,
                        int vector, float softcap, float scale) {
  constexpr int VEC = Vec<T>::kN;
  constexpr int NE = NV * VEC;    // elements of a row per lane
  constexpr int SPI = 32 / LPS;   // slots a warp loads per instruction
  constexpr int SPW = SPI * U;    // slots a warp holds in flight
  __shared__ int list[kChunk];    // compacted valid slots of a chunk
  __shared__ int warp_count[kWarps];
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  extern __shared__ float sm_acc[];  // [kWarps][GT][d]

  const int hk = static_cast<int>(blockIdx.x) % hkv;
  const int b = static_cast<int>(blockIdx.x) / hkv;
  const int s_idx = blockIdx.y;
  const int g_all = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sl = lane % LPS;
  const int grp = lane / LPS;
  const int64_t slot_step = static_cast<int64_t>(hkv) * d;
  const T* kb = k + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const T* vb = v + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const uint8_t* ok_b = valid + static_cast<int64_t>(b) * c_len;
  const int c_begin = s_idx * split;
  const int c_end = min(c_len, c_begin + split);

  for (int g0 = 0; g0 < g_all; g0 += GT) {
    float qr[GT][NE], acc[GT][NE], m[GT], l[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const bool live = g0 + g < g_all;
      const T* qh = q + (static_cast<int64_t>(b) * hq + hk * g_all + g0 + g) * d;
      m[g] = kNeg;
      l[g] = 0.0f;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = (nv * LPS + sl) * VEC + e;
          qr[g][nv * VEC + e] = (live && col < d) ? Vec<T>::scalar(qh + col) * scale : 0.0f;
          acc[g][nv * VEC + e] = 0.0f;
        }
    }

    for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
      // compact this chunk's valid slots into list[0, total)
      const int c = c0 + static_cast<int>(threadIdx.x);
      const bool ok = c < c_end && ok_b[c] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int offset = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        offset += w < warp ? warp_count[w] : 0;
        total += warp_count[w];
      }
      if (ok) list[offset + __popc(ballot & ((1u << lane) - 1u))] = c;
      __syncthreads();

      // two register buffers: a round's loads are issued before the
      // previous round is computed, so each warp keeps its loads in flight
      bool live_a[U], live_b[U];
      uint4 k_a[U][NV], v_a[U][NV], k_b[U][NV], v_b[U][NV];
      auto issue = [&](int base, bool (&live)[U], uint4 (&kr)[U][NV], uint4 (&vr)[U][NV]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u * SPI + grp;
          live[u] = e < total;
          const int64_t off = live[u] ? list[e] * slot_step : 0;
          load_row<T, LPS, NV>(kb + off, d, sl, live[u], vector, kr[u]);
          load_row<T, LPS, NV>(vb + off, d, sl, live[u], vector, vr[u]);
        }
      };
      auto consume = [&](const bool (&live)[U], const uint4 (&kr)[U][NV],
                         const uint4 (&vr)[U][NV]) {
        float sc[U][GT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float kf[NE];
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) Vec<T>::unpack(kr[u][nv], kf + nv * VEC);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            float x = 0.0f;
#pragma unroll
            for (int i = 0; i < NE; ++i) x = fmaf(qr[g][i], kf[i], x);
#pragma unroll
            for (int o = 1; o < LPS; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
            if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
            sc[u][g] = live[u] ? x : kNeg;
          }
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, sc[u][g]);
          const float alpha = __expf(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int i = 0; i < NE; ++i) acc[g][i] *= alpha;
          m[g] = m_new;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float vf[NE];
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) Vec<T>::unpack(vr[u][nv], vf + nv * VEC);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float pr = live[u] ? __expf(sc[u][g] - m[g]) : 0.0f;
            l[g] += pr;
#pragma unroll
            for (int i = 0; i < NE; ++i) acc[g][i] = fmaf(pr, vf[i], acc[g][i]);
          }
        }
      };
      constexpr int kRound = kWarps * SPW;  // slots the block loads a round
      int base = warp * SPW;
      if (base < total) issue(base, live_a, k_a, v_a);
      while (base < total) {
        if (base + kRound < total) issue(base + kRound, live_b, k_b, v_b);
        consume(live_a, k_a, v_a);
        base += kRound;
        if (base >= total) break;
        if (base + kRound < total) issue(base + kRound, live_a, k_a, v_a);
        consume(live_b, k_b, v_b);
        base += kRound;
      }
      __syncthreads();  // list and warp_count are rewritten by the next chunk
    }

    // merge the slot groups of a warp, then the warps of the block
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float acc_o[NE];
#pragma unroll
        for (int i = 0; i < NE; ++i) acc_o[i] = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
        merge(m[g], l[g], acc[g], m_o, l_o, acc_o);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (sl == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int col = (nv * LPS + sl) * VEC + e;
            if (col < d) sm_acc[(warp * GT + g) * d + col] = acc[g][nv * VEC + e];
          }
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
        const float f = __expf(sm_m[w][g] - mx);
        den = fmaf(sm_l[w][g], f, den);
        num = fmaf(sm_acc[(w * GT + g) * d + col], f, num);
      }
      const int64_t row = (static_cast<int64_t>(s_idx) * b_len + b) * hq + hk * g_all + g0 + g;
      part_acc[row * d + col] = num;
      if (col == 0) {
        part_ml[2 * row] = mx;
        part_ml[2 * row + 1] = den;
      }
    }
    __syncthreads();  // shared memory is reused by the next pass
  }
}

// One block per (b, h): merge the n_split partials in split order, each
// step rescaling the running sums and the partial to their common max; a
// single pass, so that the loads of several splits are in flight at once.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml, T* __restrict__ out,
                          int n_split, int rows, int d) {
  const int row = blockIdx.x;  // b * hq + h
  for (int col = threadIdx.x; col < d; col += kCombineThreads) {
    float mx = kNeg, den = 0.0f, num = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const int64_t r = static_cast<int64_t>(s) * rows + row;
      const float m_s = part_ml[2 * r];
      const float m_n = fmaxf(mx, m_s);
      const float f = __expf(mx - m_n);
      const float f_s = __expf(m_s - m_n);
      den = den * f + part_ml[2 * r + 1] * f_s;
      num = num * f + part_acc[r * d + col] * f_s;
      mx = m_n;
    }
    store(&out[static_cast<int64_t>(row) * d + col], num / fmaxf(den, 1e-30f));
  }
}

constexpr int kWideWarps = 4;
constexpr int kWideCols = 128;            // output columns a block
constexpr int kWidePer = kWideCols / 32;  // output columns a lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(32 * kWideWarps)
    decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ valid,
                       float* __restrict__ part_acc, float* __restrict__ part_ml, int b_len,
                       int c_len, int hq, int hkv, int d, int split, float softcap,
                       float scale) {
  __shared__ float sm_m[kWideWarps];
  __shared__ float sm_l[kWideWarps];
  __shared__ float sm_acc[kWideWarps][kWideCols];
  const int row = blockIdx.x;  // b * hq + h
  const int b = row / hq;
  const int h = row % hq;
  const int hk = h / (hq / hkv);
  const int s_idx = blockIdx.y;
  const int c0 = blockIdx.z * kWideCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t slot_step = static_cast<int64_t>(hkv) * d;
  const T* qh = q + static_cast<int64_t>(row) * d;
  const T* kb = k + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const T* vb = v + (static_cast<int64_t>(b) * c_len * hkv + hk) * d;
  const uint8_t* ok_b = valid + static_cast<int64_t>(b) * c_len;
  const int c_end = min(c_len, (s_idx + 1) * split);

  float m = kNeg, l = 0.0f, acc[kWidePer];
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) acc[j] = 0.0f;
  for (int c = s_idx * split + warp; c < c_end; c += kWideWarps) {
    if (ok_b[c] == 0) continue;  // the whole warp
    const T* kr = kb + c * slot_step;
    float x = 0.0f;
    for (int e = lane; e < d; e += 32) x = fmaf(to_f32(qh[e]) * scale, to_f32(kr[e]), x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
    const float m_new = fmaxf(m, x);
    const float alpha = __expf(m - m_new);
    const float p = __expf(x - m_new);
    l = l * alpha + p;
    m = m_new;
    const T* vr = vb + c * slot_step;
#pragma unroll
    for (int j = 0; j < kWidePer; ++j) {
      const int col = c0 + lane + 32 * j;
      acc[j] = acc[j] * alpha + (col < d ? p * to_f32(vr[col]) : 0.0f);
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) sm_acc[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  const int col = c0 + static_cast<int>(threadIdx.x);
  if (threadIdx.x >= kWideCols || col >= d) return;
  float mx = kNeg;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float den = 0.0f, num = 0.0f;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) {
    const float f = __expf(sm_m[w] - mx);
    den = fmaf(sm_l[w], f, den);
    num = fmaf(sm_acc[w][threadIdx.x], f, num);
  }
  const int64_t prow = static_cast<int64_t>(s_idx) * b_len * hq + row;
  part_acc[prow * d + col] = num;
  if (col == 0) {
    part_ml[2 * prow] = mx;
    part_ml[2 * prow + 1] = den;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* out;
  float* part_acc;
  float* part_ml;
  int64_t b, c, hq, hkv, d, n_split, split;
  bool vector;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int LPS, int NV, int GT, int U>
int launch(const Args& a) {
  auto kernel = decode_split_kernel<T, LPS, NV, GT, U>;
  const size_t smem = sizeof(float) * kWarps * GT * static_cast<size_t>(a.d);
  // opt in above 48 KB once per instantiation and size, so that a launch
  // inside CUDA-graph capture makes no attribute call
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  // (b, kv head) varies fastest, so the low splits, which a cache filled
  // from slot 0 keeps busiest, are scheduled first
  const dim3 grid(static_cast<unsigned>(a.b * a.hkv), static_cast<unsigned>(a.n_split));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.valid, a.part_acc, a.part_ml, static_cast<int>(a.b), static_cast<int>(a.c),
      static_cast<int>(a.hq), static_cast<int>(a.hkv), static_cast<int>(a.d),
      static_cast<int>(a.split), static_cast<int>(a.vector), a.softcap, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = static_cast<int>(a.b * a.hq);
  decode_combine_kernel<T><<<rows, kCombineThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), static_cast<int>(a.n_split), rows,
      static_cast<int>(a.d));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPS, int NV, int U>
int by_group(const Args& a) {
  const int64_t g = a.hq / a.hkv;
  if (g == 1) return launch<T, LPS, NV, 1, U>(a);
  if (g == 2) return launch<T, LPS, NV, 2, U>(a);
  if (g <= 4) return launch<T, LPS, NV, 4, U>(a);
  return launch<T, LPS, NV, 8, U>(a);
}

template <typename T>
int by_lanes(const Args& a) {
  constexpr int VEC = Vec<T>::kN;
  const int64_t nvec = (a.d + VEC - 1) / VEC;  // vectors in a row
  // U: 4-8 slots a round, so that the two buffers hold at least 8
  if (nvec <= 4) return by_group<T, 4, 1, 1>(a);
  if (nvec <= 8) return by_group<T, 8, 1, 1>(a);
  if (nvec <= 16) return by_group<T, 16, 1, 2>(a);
  if constexpr (VEC == 4) {  // float32, D > 128
    if (nvec > 32) return by_group<T, 32, 2, 4>(a);
  }
  return by_group<T, 32, 1, 4>(a);
}

template <typename T>
int launch_wide(const Args& a) {
  if (a.b <= 0 || a.hq <= 0) return static_cast<int>(cudaSuccess);
  if (a.d <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 || a.n_split <= 0 || a.n_split > 65535 ||
      a.split < 0 || a.n_split * a.split < a.c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = static_cast<int>(a.b * a.hq);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(a.n_split),
                  static_cast<unsigned>((a.d + kWideCols - 1) / kWideCols));
  decode_wide_kernel<T><<<grid, 32 * kWideWarps, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.valid, a.part_acc, a.part_ml, static_cast<int>(a.b), static_cast<int>(a.c),
      static_cast<int>(a.hq), static_cast<int>(a.hkv), static_cast<int>(a.d),
      static_cast<int>(a.split), a.softcap, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<rows, kCombineThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), static_cast<int>(a.n_split), rows,
      static_cast<int>(a.d));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int dispatch(const Args& a) {
  if (a.b <= 0 || a.hq <= 0) return static_cast<int>(cudaSuccess);
  if (a.d <= 0 || a.d > 256 || a.hkv <= 0 || a.hq % a.hkv != 0 || a.n_split <= 0 ||
      a.n_split > 65535 || a.split < 0 || a.n_split * a.split < a.c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args with = a;
  with.vector = a.d % Vec<T>::kN == 0 && aligned16(a.k) && aligned16(a.v);
  return by_lanes<T>(with);
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
          float* part_acc, float* part_ml, int64_t b, int64_t c, int64_t hq, int64_t hkv,
          int64_t d, int64_t n_split, int64_t split, float softcap, float scale,
          cudaStream_t stream, bool wide) {
  const Args a{q, k, v, valid, out, part_acc, part_ml, b, c, hq, hkv, d, n_split, split,
               true, softcap, scale, stream};
  return wide ? launch_wide<T>(a) : dispatch<T>(a);
}

}  // namespace

// q (b, hq, d), k and v (b, c, hkv, d), valid (b, c) bytes (0 = masked),
// out (b, hq, d), all contiguous; d <= 256, hq % hkv == 0. The cache is cut
// into n_split ranges of `split` slots (n_split * split >= c); part_acc
// (n_split, b, hq, d) and part_ml (n_split, b, hq, 2) are float32 scratch.
// softcap <= 0 turns the softcap off. Launches the split and the combine
// kernel; returns the cudaError_t of the launches.
extern "C" int decode_attention_f32(const float* q, const float* k, const float* v,
                                    const uint8_t* valid, float* out, float* part_acc,
                                    float* part_ml, int64_t b, int64_t c, int64_t hq,
                                    int64_t hkv, int64_t d, int64_t n_split,
                                    int64_t split, float softcap, float scale,
                                    cudaStream_t stream) {
  return entry<float>(q, k, v, valid, out, part_acc, part_ml, b, c, hq, hkv, d, n_split,
                      split, softcap, scale, stream, false);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const uint8_t* valid,
                                     __nv_bfloat16* out, float* part_acc, float* part_ml,
                                     int64_t b, int64_t c, int64_t hq, int64_t hkv,
                                     int64_t d, int64_t n_split, int64_t split,
                                     float softcap, float scale, cudaStream_t stream) {
  return entry<__nv_bfloat16>(q, k, v, valid, out, part_acc, part_ml, b, c, hq, hkv, d,
                              n_split, split, softcap, scale, stream, false);
}

// As decode_attention_f32 and decode_attention_bf16, at any d: the wide
// split kernel and the same combine, which the wrapper takes for d > 256.
extern "C" int decode_attention_wide_f32(const float* q, const float* k, const float* v,
                                         const uint8_t* valid, float* out, float* part_acc,
                                         float* part_ml, int64_t b, int64_t c, int64_t hq,
                                         int64_t hkv, int64_t d, int64_t n_split,
                                         int64_t split, float softcap, float scale,
                                         cudaStream_t stream) {
  return entry<float>(q, k, v, valid, out, part_acc, part_ml, b, c, hq, hkv, d, n_split,
                      split, softcap, scale, stream, true);
}

extern "C" int decode_attention_wide_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const uint8_t* valid,
                                          __nv_bfloat16* out, float* part_acc,
                                          float* part_ml, int64_t b, int64_t c, int64_t hq,
                                          int64_t hkv, int64_t d, int64_t n_split,
                                          int64_t split, float softcap, float scale,
                                          cudaStream_t stream) {
  return entry<__nv_bfloat16>(q, k, v, valid, out, part_acc, part_ml, b, c, hq, hkv, d,
                              n_split, split, softcap, scale, stream, true);
}

// Registers, static shared memory, local (spill) bytes and the dynamic
// shared memory of the split kernel that a bf16 (bf16 != 0) or float32
// call with this d and g = hq / hkv launches; into out[0..3]. Returns the cudaError_t of the query.
// For d > 256, the wide kernel's (its shared memory is static).
extern "C" int decode_attention_attributes(int64_t bf16, int64_t d, int64_t g, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaErrorInvalidValue;
  if (d > 256) {
    err = bf16 ? cudaFuncGetAttributes(&attr, decode_wide_kernel<__nv_bfloat16>)
               : cudaFuncGetAttributes(&attr, decode_wide_kernel<float>);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = 0;
    return static_cast<int>(err);
  }
  const int gt = g == 1 ? 1 : g == 2 ? 2 : g <= 4 ? 4 : 8;
#define REPRO_ATTR(T, LPS, NV, U)                                                   \
  err = gt == 1   ? cudaFuncGetAttributes(&attr, decode_split_kernel<T, LPS, NV, 1, U>) \
        : gt == 2 ? cudaFuncGetAttributes(&attr, decode_split_kernel<T, LPS, NV, 2, U>) \
        : gt == 4 ? cudaFuncGetAttributes(&attr, decode_split_kernel<T, LPS, NV, 4, U>) \
                  : cudaFuncGetAttributes(&attr, decode_split_kernel<T, LPS, NV, 8, U>)
  const int64_t vec = bf16 ? 8 : 4;
  const int64_t nvec = (d + vec - 1) / vec;
  if (bf16) {
    if (nvec <= 4) REPRO_ATTR(__nv_bfloat16, 4, 1, 1);
    else if (nvec <= 8) REPRO_ATTR(__nv_bfloat16, 8, 1, 1);
    else if (nvec <= 16) REPRO_ATTR(__nv_bfloat16, 16, 1, 2);
    else REPRO_ATTR(__nv_bfloat16, 32, 1, 4);
  } else {
    if (nvec <= 4) REPRO_ATTR(float, 4, 1, 1);
    else if (nvec <= 8) REPRO_ATTR(float, 8, 1, 1);
    else if (nvec <= 16) REPRO_ATTR(float, 16, 1, 2);
    else if (nvec <= 32) REPRO_ATTR(float, 32, 1, 4);
    else REPRO_ATTR(float, 32, 2, 4);
  }
#undef REPRO_ATTR
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(sizeof(float) * kWarps * gt * d);
  return static_cast<int>(err);
}
