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
// tensor-core operations per byte. So the bf16 entry has to run on the
// tensor cores, and keep them fed.
//
// bf16 entry (flash_attention_tc_kernel): warpgroup MMA (wgmma) fed by
// TMA. One block per (64 query rows, b * Hq + h): one consumer warpgroup
// (128 threads) and one producer warp. The producer's elected lane loads
// the block's q tile once and then the K and V tiles (64 keys each) of the
// key range the masks can reach, through TMA, into a ring of 2 stages
// guarded by mbarriers (full: the bytes have landed; empty: the consumers
// are done with the stage), so the next tile's loads are in flight while
// the consumers compute. Tiles stay bf16 in shared memory in the 128-byte
// swizzled layout that both TMA and wgmma's descriptors use, 64 head-dim
// columns (128 bytes) per row and one 8 KB region per 64 columns: 80 KB a
// block at D = 128, so two blocks share an SM. The consumer computes
// S = q k^T with wgmma.m64n64k16 (q and k K-major from shared memory,
// float32 out), applies scale, softcap and, only on tiles that cross the
// diagonal, the window edge or S, the masks, and runs the online softmax
// in registers: a thread holds 2 rows x 16 columns of S, and a row's max
// is combined over the 4 threads that hold it with shuffles. P is rounded
// to bf16 in registers and is the A operand of O += P V
// (wgmma.m64n{64 NC}k16, V MN-major from shared memory through the
// transposed descriptor), O staying in float32 registers. Tiles wholly
// above the diagonal or outside the window are never loaded. Blocks are
// issued longest-first across all heads (the causal diagonal makes late q
// tiles the longest). At the trace's median prompt (829 tokens, 16 heads)
// that is 13 x 16 = 208 blocks on 132 SMs, two to an SM, so one block's
// softmax overlaps the other's products; overlapping them inside one
// warpgroup as well (S(i+1) and P(i) V(i) in flight during a softmax)
// measured slower on the H100 (PERF.md, section 6). The query heads of a
// GQA group do not share a block: that would halve the block count below
// the SM count at the median prompt, and the second head's K and V come
// from L2.
// D that is a multiple of 16 goes straight through; another multiple of 8
// is zero-filled to the next 64 columns by TMA's out-of-bounds fill, which
// adds nothing to q k^T; the wrapper zero-pads any other D to a multiple
// of 8 (TMA wants 16-byte row strides) and slices the output.
//
// float32 entry (flash_attention_kernel): CUDA cores in float32. The tensor cores would round float32 inputs to TF32 (about
// 1e-3 relative), and the float32 serving check holds prefill logits to
// 2e-4 (tests/test_kernels.py:17). One block of 128 threads per (q tile of
// 64 rows, b * Hq + h) keeps its q tile (scaled, float32, transposed) in
// shared memory and walks the k tiles its masks can reach, staging each
// 64-row k tile (transposed) and v tile in shared memory. Each thread owns
// a 4 x 8 micro-tile of the 64 x 64 scores (rows 4 ty .. 4 ty + 3, columns
// tx + 8 j) and the same 4 rows of the output accumulator (columns tx + 8 j
// of D), so the running max and denominator of a row live in the 8 lanes
// that share it and are combined with warp shuffles. Probabilities pass
// through shared memory (transposed) into the P V product. q tiles are
// issued longest-first.
//
// wide entries (flash_attention_wide_kernel), float32 and bf16 at any D,
// taken for D > 256, where the two kernels above would not fit their
// registers and shared memory (the TPU wrapper pads D to a multiple of 128
// and takes any D). A simple CUDA-core kernel: one warp per query row and
// 4 rows a block, and a grid axis over 128-column chunks of the output. A
// warp keeps its q row (scaled, float32) in shared memory, walks the keys
// its masks reach one at a time, takes q . k over all of D with its lanes
// on consecutive columns (coalesced loads) and a shuffle sum, and keeps the
// online softmax and the 4 output columns a lane owns in registers. Each
// chunk's blocks recompute the scores; K is read once per chunk and row, so
// it is bounded by those loads (L1 and L2 catch the rows the 4 warps of a
// block share), not by operations. No head config of the repo reaches it.
//
// Nothing carries between blocks in any kernel, and padded rows and keys
// never leave a block: the kernels read (B, S, H, D) directly and mask the
// ragged edge themselves.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {


constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles (floats)

static_assert(kBQ == kBK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t f32_smem_bytes(int d) {
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
int f32_launch(const T* q, const T* k, const T* v, T* out, int64_t b, int64_t s,
           int64_t hq, int64_t hkv, int64_t d, int64_t causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = f32_smem_bytes(static_cast<int>(d));
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
int f32_dispatch(const T* q, const T* k, const T* v, T* out, int64_t b, int64_t s,
             int64_t hq, int64_t hkv, int64_t d, int64_t causal, int64_t window,
             float softcap, float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 64) return f32_launch<T, 64>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  if (d <= 128) return f32_launch<T, 128>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  return f32_launch<T, 256>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarriers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 64;            // query rows per block: one consumer warpgroup
constexpr int kBN = 64;            // keys per K/V tile
constexpr int kCols = 64;          // head-dim columns per 128-byte swizzled row
constexpr int kStages = 2;         // K/V ring
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr uint32_t kTileBytes = kBM * kCols * 2;  // one 64 x 64 bf16 region, 8 KB
constexpr uint32_t kAtomBytes = 1024;             // 8 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWatchdogCycles = 20000000000LL;  // ~10 s at 2 GHz

static_assert(kBM == kBN, "q, k and v regions share one box shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A phase
// that never completes is a fault of the kernel: after ~10 s of SM clock
// the block traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 0) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > kWatchdogCycles) {
        __trap();
      }
    }
  }
}

// One box of the 4-D map (d, h, s, b) into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of accumulators across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand. K-major
// (q, k): rows of 128 bytes, 8-row atoms sbo = 1024 bytes apart, lbo
// unused; a k-step of 16 columns adds 32 bytes to the start address.
// MN-major (v): rows are keys, lbo = the stride between 64-column regions
// of D, sbo = 1024 bytes between 8-key atoms.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, float32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T; both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, float32) += A (64 x 16, registers) * B (16 x 192, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, float32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64 NC) += P (registers) V (smem), one k-step of 16 keys.
template <int NC>
__device__ __forceinline__ void wgmma_pv(float (&o)[32 * NC], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NC == 1) wgmma_rs_n64(o, a, db);
  if constexpr (NC == 2) wgmma_rs_n128(o, a, db);
  if constexpr (NC == 3) wgmma_rs_n192(o, a, db);
  if constexpr (NC == 4) wgmma_rs_n256(o, a, db);
}

constexpr size_t smem_bytes(int nc) {
  // q, the K ring, the V ring, 1 + 3 kStages barriers, and slack to align
  // the tiles at 1024 bytes
  return static_cast<size_t>(1 + 2 * kStages) * nc * kTileBytes + 8 * (1 + 3 * kStages) +
         kAtomBytes;
}

// NC: 64-column regions of D (D <= 64 NC). Thread t < 128 is a consumer
// (warp t / 32 holds query rows 16 w .. 16 w + 15 of the tile); warp 4 is
// the producer.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              __nv_bfloat16* __restrict__ out, int b_len, int s_len, int hq,
                              int hkv, int d, int causal, int window, float softcap,
                              float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtomBytes - 1) & ~(kAtomBytes - 1);
  const uint32_t sq = base;                            // [NC] regions of 64 x 64
  const uint32_t sk = sq + NC * kTileBytes;            // [kStages][NC]
  const uint32_t sv = sk + kStages * NC * kTileBytes;  // [kStages][NC]
  const uint32_t bar_q = sv + kStages * NC * kTileBytes;
  const uint32_t bar_k = bar_q + 8;                    // full: [kStages]
  const uint32_t bar_v = bar_k + 8 * kStages;          // full: [kStages]
  const uint32_t bar_e = bar_v + 8 * kStages;          // empty: [kStages]

  const int heads = b_len * hq;
  const int n_tiles = (s_len + kBM - 1) / kBM;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / heads;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = tile * kBM;
  int kt_lo = 0;
  int kt_hi = (s_len + kBN - 1) / kBN;
  if (causal) kt_hi = min(kt_hi, (q0 + kBM - 1) / kBN + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / kBN);
  const int n_kv = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(bar_q, NC * kTileBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load(sq + c * kTileBytes, &tmap_q, bar_q, c * kCols, h, q0, b);
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bar_e + 8 * st, (i / kStages - 1) & 1);
        const int k0 = (kt_lo + i) * kBN;
        const uint32_t ks = sk + st * NC * kTileBytes;
        const uint32_t vs = sv + st * NC * kTileBytes;
        mbar_expect_tx(bar_k + 8 * st, NC * kTileBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(ks + c * kTileBytes, &tmap_k, bar_k + 8 * st, c * kCols, hk, k0, b);
        mbar_expect_tx(bar_v + 8 * st, NC * kTileBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(vs + c * kTileBytes, &tmap_v, bar_v + 8 * st, c * kCols, hk, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup
  const int g = lane / 4;       // row g and g + 8 of the warp's 16
  const int t4 = lane % 4;      // columns 2 t4, 2 t4 + 1 of each 8
  const int row0 = q0 + 16 * warp + g;
  constexpr int NO = 32 * NC;   // O accumulators a thread holds
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (kt_lo + i) * kBN;

    // S = q k^T
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.0f;
    mbar_wait(bar_k + 8 * st, parity);
    wgmma_fence();
    // every k-step of the NC regions: columns past D are TMA's zeros, and a
    // loop with a runtime bound would make ptxas serialize the wgmmas
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + off, 16, kAtomBytes),
                   sw128_desc(sk + st * NC * kTileBytes + off, 16, kAtomBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap, masks (only where the tile crosses an edge), online softmax
    const bool masked = !(k0 + kBN <= s_len && (!causal || k0 + kBN - 1 <= q0) &&
                          (window <= 0 || k0 > q0 + kBM - 1 - window));
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[4 * j + r] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (masked) {
          const int qpos = row0 + (r >= 2 ? 8 : 0);
          const int kpos = k0 + 8 * j + 2 * t4 + (r & 1);
          const bool ok = kpos < s_len && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNeg;
        }
        s[4 * j + r] = x;
        if (r < 2) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
    uint32_t p[16];  // P in bf16: the A fragments of the 4 k-steps of P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[4 * j + r];
        e[r] = exp2f((x - (r < 2 ? mn0 : mn1)) * kLog2e);
        if (masked && x == kNeg) e[r] = 0.0f;  // a row with no key yet keeps 0
      }
      sum0 += e[0] + e[1];
      sum1 += e[2] + e[3];
      p[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(e[0], e[1]);
      p[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(e[2], e[3]);
    }
    l0 = l0 * alpha0 + sum0;  // this thread's share; the 4 are summed at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V
    mbar_wait(bar_v + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_pv<NC>(o, a, sw128_desc(sv + st * NC * kTileBytes + kk * 2 * kAtomBytes, kTileBytes,
                                    kAtomBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_e + 8 * st);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv[2] = {1.0f / fmaxf(l0, 1e-30f), 1.0f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row0 + 8 * half;
    if (qpos >= s_len) continue;
    __nv_bfloat16* orow = out + ((static_cast<int64_t>(b) * s_len + qpos) * hq + h) * d;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] * inv[half], o[4 * j + 2 * half + 1] * inv[half]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A contiguous (b, s, h, d) bf16 tensor as a 4-D map (d, h, s, b) whose
// boxes are 64 columns of one head at 64 consecutive positions, swizzled
// by 128 bytes; out-of-bounds columns and positions read as 0.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int64_t b, int64_t s,
              int64_t h, int64_t d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * d),
                                 static_cast<cuuint64_t>(2 * d * h),
                                 static_cast<cuuint64_t>(2 * d * h * s)};
  const cuuint32_t box[4] = {kCols, 1, kBM, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* out, int64_t b, int64_t s, int64_t hq, int64_t hkv, int64_t d,
           int64_t causal, int64_t window, float softcap, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, b, s, hq, d) || !make_map(encode, &tk, k, b, s, hkv, d) ||
      !make_map(encode, &tv, v, b, s, hkv, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_attention_tc_kernel<NC>;
  const size_t smem = smem_bytes(NC);
  // opt in above 48 KB once per instantiation, so that a launch inside
  // CUDA-graph capture makes no attribute call
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int64_t blocks = (s + kBM - 1) / kBM * b * hq;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, out, static_cast<int>(b), static_cast<int>(s), static_cast<int>(hq),
      static_cast<int>(hkv), static_cast<int>(d), static_cast<int>(causal),
      static_cast<int>(window), softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* out, int64_t b, int64_t s, int64_t hq, int64_t hkv, int64_t d,
             int64_t causal, int64_t window, float softcap, float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nc = (d + kCols - 1) / kCols;
  if (nc == 1) return launch<1>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  if (nc == 2) return launch<2>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  if (nc == 3) return launch<3>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
  return launch<4>(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// D > 256, float32 and bf16: CUDA cores, one warp a query row
// ---------------------------------------------------------------------------

namespace wide {

constexpr int kWarps = 4;                // query rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;               // output columns a block
constexpr int kPer = kCols / 32;         // output columns a lane
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_bytes(int64_t d) { return sizeof(float) * kWarps * static_cast<size_t>(d); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out, int s_len,
                                int hq, int hkv, int d, int causal, int window,
                                float softcap, float scale) {
  extern __shared__ float q_rows[];  // [kWarps][d]: q * scale
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qpos = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;  // longest rows first
  if (qpos >= s_len) return;  // the whole warp; no block barrier follows
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int c0 = blockIdx.z * kCols;
  const int64_t kv_step = static_cast<int64_t>(hkv) * d;
  const T* qr = q + ((static_cast<int64_t>(b) * s_len + qpos) * hq + h) * d;
  const T* kb = k + (static_cast<int64_t>(b) * s_len * hkv + hk) * d;
  const T* vb = v + (static_cast<int64_t>(b) * s_len * hkv + hk) * d;
  float* qs = q_rows + warp * d;
  for (int c = lane; c < d; c += 32) qs[c] = to_f32(qr[c]) * scale;
  __syncwarp();

  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = causal ? qpos + 1 : s_len;
  float m = kNeg, l = 0.0f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  for (int key = lo; key < hi; ++key) {
    const T* kr = kb + key * kv_step;
    float x = 0.0f;
    for (int c = lane; c < d; c += 32) x = fmaf(qs[c], to_f32(kr[c]), x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
    const float m_new = fmaxf(m, x);
    const float alpha = expf(m - m_new);
    const float p = expf(x - m_new);
    l = l * alpha + p;
    m = m_new;
    const T* vr = vb + key * kv_step;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = c0 + lane + 32 * j;
      acc[j] = acc[j] * alpha + (col < d ? p * to_f32(vr[col]) : 0.0f);
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  T* orow = out + ((static_cast<int64_t>(b) * s_len + qpos) * hq + h) * d;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int col = c0 + lane + 32 * j;
    if (col < d) store(&orow[col], acc[j] / denom);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int64_t b, int64_t s, int64_t hq,
           int64_t hkv, int64_t d, int64_t causal, int64_t window, float softcap,
           float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_wide_kernel<T>;
  const size_t smem = smem_bytes(d);
  // opt in above 48 KB once per instantiation and size, so that a launch
  // inside CUDA-graph capture makes no attribute call
  static size_t opted_in = kDefaultSmem;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid(static_cast<unsigned>((s + kWarps - 1) / kWarps),
                  static_cast<unsigned>(b * hq), static_cast<unsigned>((d + kCols - 1) / kCols));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, static_cast<int>(s),
                                           static_cast<int>(hq), static_cast<int>(hkv),
                                           static_cast<int>(d), static_cast<int>(causal),
                                           static_cast<int>(window), softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

}  // namespace

// q (b, s, hq, d), k and v (b, s, hkv, d), out (b, s, hq, d), all
// contiguous; d <= 256, hq % hkv == 0. softcap <= 0 turns the softcap off,
// window <= 0 the window. Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* out, int64_t b, int64_t s, int64_t hq,
                                   int64_t hkv, int64_t d, int64_t causal,
                                   int64_t window, float softcap, float scale,
                                   cudaStream_t stream) {
  return f32::f32_dispatch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale,
                           stream);
}

// As flash_attention_f32, in bf16 on the tensor cores; d must be a
// multiple of 8 and the pointers 16-byte aligned (TMA's rules).
extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out,
                                    int64_t b, int64_t s, int64_t hq, int64_t hkv,
                                    int64_t d, int64_t causal, int64_t window,
                                    float softcap, float scale, cudaStream_t stream) {
  return tc::dispatch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

// As flash_attention_f32 and flash_attention_bf16, at any d: the wide
// kernel on the CUDA cores, which the wrapper takes for d > 256.
extern "C" int flash_attention_wide_f32(const float* q, const float* k, const float* v,
                                        float* out, int64_t b, int64_t s, int64_t hq,
                                        int64_t hkv, int64_t d, int64_t causal,
                                        int64_t window, float softcap, float scale,
                                        cudaStream_t stream) {
  return wide::launch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_wide_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, __nv_bfloat16* out,
                                         int64_t b, int64_t s, int64_t hq, int64_t hkv,
                                         int64_t d, int64_t causal, int64_t window,
                                         float softcap, float scale, cudaStream_t stream) {
  return wide::launch(q, k, v, out, b, s, hq, hkv, d, causal, window, softcap, scale, stream);
}

// Registers, static shared memory, local (spill) bytes and dynamic shared
// memory of the kernel that a bf16 (bf16 != 0) or float32 call with this d
// launches (the wide kernel for d > 256); into out[0..3]. Returns the
// cudaError_t of the query.
extern "C" int flash_attention_attributes(int64_t bf16, int64_t d, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err;
  size_t dynamic;
  if (d > 256) {
    err = bf16 ? cudaFuncGetAttributes(&attr, wide::flash_attention_wide_kernel<__nv_bfloat16>)
               : cudaFuncGetAttributes(&attr, wide::flash_attention_wide_kernel<float>);
    dynamic = wide::smem_bytes(d);
  } else if (bf16) {
    const int64_t nc = (d + tc::kCols - 1) / tc::kCols;
    err = nc == 1   ? cudaFuncGetAttributes(&attr, tc::flash_attention_tc_kernel<1>)
          : nc == 2 ? cudaFuncGetAttributes(&attr, tc::flash_attention_tc_kernel<2>)
          : nc == 3 ? cudaFuncGetAttributes(&attr, tc::flash_attention_tc_kernel<3>)
                    : cudaFuncGetAttributes(&attr, tc::flash_attention_tc_kernel<4>);
    dynamic = tc::smem_bytes(static_cast<int>(nc));
  } else {
    err = d <= 64    ? cudaFuncGetAttributes(&attr, f32::flash_attention_kernel<float, 64>)
          : d <= 128 ? cudaFuncGetAttributes(&attr, f32::flash_attention_kernel<float, 128>)
                     : cudaFuncGetAttributes(&attr, f32::flash_attention_kernel<float, 256>);
    dynamic = f32::f32_smem_bytes(static_cast<int>(d));
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(dynamic);
  return static_cast<int>(err);
}
