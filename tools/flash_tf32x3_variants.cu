// Variants of csrc/flash_attention_tf32x3.cu for tools/flash_tf32x3_variants.py:
// the design choices and ablations PERF.md quotes, each a -D switch. Not
// part of the port and not built by it. Defaults: 4 warps of 16 query rows,
// one K and one V buffer, cvt.rna as two integer operations, copy addresses
// computed a chunk at a time. Switches:
//   TF32X3_WARPS, TF32X3_STAGES, TF32X3_S_UNROLL  the CTA and its pipeline
//   TF32X3_CVT          the cvt.rna.tf32.f32 instruction for the split
//   TF32X3_LOAD_STEP    copy addresses by a constant step (as the port)
//   TF32X3_SMALL_TRUNC  small not rounded: the mma truncates it
//   PREFETCH_L2=n       K and V rows n tiles ahead prefetched into the L2
// and ablations that give wrong results, for timing only:
//   AB_NOSPLIT (no split ALU work), AB_ONE (big.big only), AB_NOEXP
//   (no expf), AB_NOLOAD (K and V copied for the first tile only).
// Also mma_peak: back-to-back mma.sync m16n8k8 TF32, 8 chains a warp.
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

#ifndef TF32X3_WARPS
#define TF32X3_WARPS 4
#endif
#ifndef TF32X3_STAGES
#define TF32X3_STAGES 1
#endif
#ifndef TF32X3_S_UNROLL
#define TF32X3_S_UNROLL 2
#endif
constexpr int kWarps = TF32X3_WARPS;     // 16 query rows a warp
constexpr int kBQ = 16 * kWarps;         // query rows a CTA
constexpr int kBKV = 64;                 // key/value rows a tile
constexpr int kStages = TF32X3_STAGES;   // of K and of V
constexpr int kSUnroll = TF32X3_S_UNROLL;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Shape {
  static constexpr int kQKPitch = HD - HD % 16 + 8;  // 16 m + 8 floats
  static constexpr int kVPitch = HD + 4;             // 8 m + 4 floats
  static constexpr int kQ = kBQ * kQKPitch;           // floats
  static constexpr int kK = kBKV * kQKPitch;
  static constexpr int kV = kBKV * kVPitch;
  static constexpr int kSmemBytes = 4 * (kQ + kStages * (kK + kV));
};

// ---------------------------------------------------------------- PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` (16 or 0) of them read, the rest
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 for a finite x: round the magnitude to 10 mantissa bits,
// to nearest with ties away from zero, by adding half of the dropped 13
// bits' range to the bit pattern and clearing them (a carry steps the
// exponent, as it should). ptxas expands cvt.rna itself with checks for
// NaN and infinity that cost more than the two operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
#ifdef TF32X3_CVT
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
#else
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
}

// x = big + small, both TF32, rounded to nearest (ties away from zero).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
#ifdef AB_NOSPLIT
  big = small = __float_as_uint(x);
  return;
#endif
  big = to_tf32(x);
#ifdef TF32X3_SMALL_TRUNC
  small = __float_as_uint(x - __uint_as_float(big));
#else
  small = to_tf32(x - __uint_as_float(big));
#endif
}

// d += a.b, m16n8k8, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in split TF32: small.big, big.small, big.big, in that order.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split(b0, b0_big, b0_small);
  split(b1, b1_big, b1_small);
#ifndef AB_ONE
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
#endif
  mma_tf32(d, a_big, b0_big, b1_big);
}

// Rows [row0, row0 + ROWS) of one head, x pointing at (b, 0, h, 0) of a
// (B, S, H, HD) tensor, into dst (ROWS x PITCH floats) by cp.async; rows
// past S as zeros.
template <int HD, int ROWS, int PITCH>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ x,
                                          int64_t row0, int64_t S,
                                          int64_t row_stride) {
  constexpr int kChunks = HD / 4;  // 16 bytes each
#ifdef TF32X3_LOAD_STEP
  // one 16-byte column of every kPass-th row a thread: a constant step
  constexpr int kPass = kThreads / kChunks;
  constexpr int kRounds = ROWS / kPass > 0 ? ROWS / kPass : 1;
  const int r = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  if (r >= ROWS) return;
  const float* src = x + (row0 + r) * row_stride + 4 * c;
  float* d = dst + r * PITCH + 4 * c;
  const int left = static_cast<int>(S - row0 - r);
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const bool ok = u * kPass < left;
    cp_async16(d + u * kPass * PITCH, ok ? src + u * kPass * row_stride : x,
               ok ? 16u : 0u);
  }
  return;
#endif
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int64_t row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * PITCH + 4 * c, ok ? x + row * row_stride + 4 * c : x,
               ok ? 16u : 0u);
  }
}

// ------------------------------------------------------------- kernel ----
template <int HD>
__global__ void __launch_bounds__(kThreads, (kWarps == 4 ? 2 : 1))
    flash_attention_tf32x3_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  float* __restrict__ o, int64_t S, int64_t H,
                                  float scale) {
  using Sh = Shape<HD>;
  constexpr int QP = Sh::kQKPitch, VP = Sh::kVPitch, NO = HD / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Sh::kQ;              // kStages tiles
  float* vs = ks + kStages * Sh::kK;    // kStages tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t n_q = (S + kBQ - 1) / kBQ;
  const int64_t q0 = (n_q - 1 - static_cast<int64_t>(blockIdx.x)) * kBQ;
  const int64_t row_stride = H * HD;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * S * row_stride +
                       static_cast<int64_t>(blockIdx.y) * HD;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  // causal reach: the CTA's up to its last valid row, a warp's up to its own
  const int64_t n_kv = ((q0 + kBQ < S ? q0 + kBQ : S) - 1) / kBKV + 1;
  const int64_t w0 = q0 + 16 * warp;               // the warp's first row
  const int64_t w_last = (w0 + 15 < S ? w0 + 15 : S - 1);
  const int64_t r0 = w0 + g, r1 = r0 + 8;          // this lane's two rows

  // K[j] and V[j] live in stage j % kStages. Groups, in commit order: Q
  // with K[0], V[0], then K[j], V[j] for j < kStages; then each tile kt
  // commits V[kt - 1 + kStages] (kt >= 1) at its start, when tile kt-1's
  // P.V is done, and K[kt + kStages] after its softmax, when its Q.K^T is
  // done; empty where j >= n_kv. So at each wait the 2 (kStages - 1) newest
  // groups are the ones still allowed in flight.
  load_rows<HD, kBQ, QP>(qs, qh, q0, S, row_stride);
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_kv)
      load_rows<HD, kBKV, QP>(ks + j * Sh::kK, kh, j * kBKV, S, row_stride);
    cp_async_commit();
    if (j < n_kv)
      load_rows<HD, kBKV, VP>(vs + j * Sh::kV, vh, j * kBKV, S, row_stride);
    cp_async_commit();
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const float* qw = qs + (16 * warp) * QP;

  for (int64_t kt = 0; kt < n_kv; ++kt) {
    const int st = static_cast<int>(kt % kStages);
    const int64_t k0 = kt * kBKV;
    const float* kst = ks + st * Sh::kK;
    const float* vst = vs + st * Sh::kV;
    cp_async_wait<2 * (kStages - 1)>();  // K[kt] (on tile 0, Q) landed
    __syncthreads();  // ... for every thread; tile kt-1's P.V done
#ifdef PREFETCH_L2
    {
      const int64_t pr = k0 + PREFETCH_L2 * kBKV + (threadIdx.x % kBKV);
      if (threadIdx.x < 2 * kBKV && pr < S) {
        const float* src = (threadIdx.x < kBKV ? kh : vh) + pr * row_stride;
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" :: "l"(src), "n"(HD * 4) : "memory");
      }
    }
#endif
    if (kt >= 1) {
      const int64_t j = kt - 1 + kStages;
#ifdef AB_NOLOAD
      if (false)
#else
      if (j < n_kv)
#endif
        load_rows<HD, kBKV, VP>(vs + (j % kStages) * Sh::kV, vh, j * kBKV,
                                S, row_stride);
      cp_async_commit();
    }
    const bool active = k0 <= w_last;  // warp-uniform

    float s[8][4];
    if (active) {
      // S = Q.K^T: k-index t is d = 8 kk + 2t, t + 4 is d = 8 kk + 2t + 1
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll(kSUnroll)
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float2 qa =
            *reinterpret_cast<const float2*>(qw + g * QP + 8 * kk + 2 * t);
        const float2 qb = *reinterpret_cast<const float2*>(
            qw + (g + 8) * QP + 8 * kk + 2 * t);
        uint32_t a_big[4], a_small[4];
        split(qa.x, a_big[0], a_small[0]);
        split(qb.x, a_big[1], a_small[1]);
        split(qa.y, a_big[2], a_small[2]);
        split(qb.y, a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 kb = *reinterpret_cast<const float2*>(
              kst + (8 * j + g) * QP + 8 * kk + 2 * t);
          mma_3xtf32(s[j], a_big, a_small, kb.x, kb.y);
        }
      }

      // scale, mask (diagonal and tail tiles only), row max over the quad
      const bool masked = k0 + kBKV - 1 > w0 || k0 + kBKV > S;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (masked) {
            const int64_t kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int64_t qpos = e < 2 ? r0 : r1;
            if (!(kpos <= qpos && kpos < S)) x = kNegInf;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every row sees key 0 in tile 0, so m is a real score from there on
      // and alpha = expf(-1e30 - m) = 0 on the first tile
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
#ifdef AB_NOEXP
          const float p = x == kNegInf ? 0.0f : x - (e < 2 ? mn0 : mn1);
#else
          const float p = x == kNegInf ? 0.0f : expf(x - (e < 2 ? mn0 : mn1));
#endif
          s[j][e] = p;
          if (e < 2) ps0 += p; else ps1 += p;
        }
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
    }

    cp_async_wait<2 * (kStages - 1)>();  // V[kt] landed
    __syncthreads();  // ... for every thread; every read of K[kt] done
#ifdef AB_NOLOAD
    if (false)
#else
    if (kt + kStages < n_kv)
#endif
      load_rows<HD, kBKV, QP>(ks + st * Sh::kK, kh, (kt + kStages) * kBKV, S,
                              row_stride);
    cp_async_commit();

    if (active) {
      // O += P.V: P's C fragment is its A fragment with k-index t read as
      // key 8 kk + 2t and t + 4 as key 8 kk + 2t + 1; V's rows to match
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t a_big[4], a_small[4];
        split(s[kk][0], a_big[0], a_small[0]);
        split(s[kk][2], a_big[1], a_small[1]);
        split(s[kk][1], a_big[2], a_small[2]);
        split(s[kk][3], a_big[3], a_small[3]);
        const float* vr = vst + (8 * kk + 2 * t) * VP + g;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_3xtf32(acc[n], a_big, a_small, vr[8 * n], vr[VP + 8 * n]);
      }
    }
  }

  // the row sums over the 4 lanes of a row, then O / max(l, 1e-30)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* oh = o + head + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = half ? r1 : r0;
    if (row < S) {
      const float d = half ? d1 : d0;
      float* orow = oh + row * row_stride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * half] / d, acc[n][2 * half + 1] / d);
    }
  }
}

// ---------------------------------------------------------- host side ----
// The instance's dynamic shared memory limit raised once a device: the
// call gives the same result every time.
template <int HD>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_tf32x3_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<HD>::kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  const cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_attention_tf32x3_kernel<HD>
      <<<grid, kThreads, Shape<HD>::kSmemBytes, stream>>>(q, k, v, o, S, H,
                                                         scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, S, H, hd) fp32, contiguous and 16-byte aligned on the
// current device; o aliases none of the inputs. hd is 8, 16, 32 or 128.
// Launches one CTA of 256 threads per (tile of 128 query rows, head, batch)
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape or an alignment it does not take.
extern "C" int variant_launch(const void* q, const void* k,
                                             const void* v, void* o,
                                             int64_t B, int64_t S, int64_t H,
                                             int64_t hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535 || (S + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) & 15u)
      return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(qf, kf, vf, of, B, S, H, s);
    case 16: return launch<16>(qf, kf, vf, of, B, S, H, s);
    case 32: return launch<32>(qf, kf, vf, of, B, S, H, s);
    case 128: return launch<128>(qf, kf, vf, of, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mma.sync m16n8k8 TF32 alone: `iters` rounds of 8 independent chains a
// warp; out keeps the sums live.
__global__ void mma_peak_kernel(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = a0 * 3, b1 = a0 * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float sum = 0.0f;
  for (int c = 0; c < 8; ++c)
    for (int e = 0; e < 4; ++e) sum += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_peak_launch(float* out, int blocks, int threads,
                               int iters, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
