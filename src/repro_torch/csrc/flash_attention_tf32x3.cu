// Causal flash attention in fp32 on Hopper's tensor cores, as split TF32
// (3xTF32): every fp32 call, the fp32 prefill and the fp32 serve invariant,
//
//     o[b, s, h] = sum over t <= s of softmax_t(q[b,s,h] . k[b,t,h] * scale)
//                  * v[b, t, h],                  scale = 1 / sqrt(hd)
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _make_kernel) for every fp32 call, at hd 8, 16,
// 32, 64, 128 and 256; csrc/flash_attention_wgmma.cu takes bf16 at hd 64,
// 128 and 256 and csrc/flash_attention.cu bf16 at the small head dims. It computes what the
// TPU kernel computes: scores in fp32 scaled by 1/sqrt(hd), the top-left
// causal mask kpos <= qpos with NEG_INF = -1e30, an online softmax with the
// running max, denominator and accumulator in fp32, the denominator clamped
// at 1e-30, the output written once, kv tiles past causal reach skipped. It
// reads q, k, v and writes o in the model layout (B, S, H, hd) in place; the
// tail past S is masked, not padded: K and V rows past S are copied in as
// zeros and never enter the max or the sum, and rows past S are not written.
//
// Split TF32. A single TF32 product keeps 11 bits of each operand and
// misses the fp32 tolerance of 1e-5 by 100x or more. Each fp32 operand x is
// written as big + small, both TF32: big = cvt.rna.tf32(x), small =
// cvt.rna.tf32(x - big) (x - big is exact). The three products small.big,
// big.small and big.big go, in that order, into one fp32 accumulator;
// small.small (below 2^-22 relative) is dropped. The products of TF32 values
// are exact in fp32, so the result is about as close to float64 as a plain
// fp32 sum. Rounding matters: feeding raw fp32 bits to the mma would
// truncate them and double the error.
//
// Bound: operations, at the TF32 tensor-core rate. At the model's prefill
// (B*H = 64, S = 1,024, hd 128) the causal half is 17.18 GFLOP of fp32
// products, done as 3 x 17.18 GFLOP of TF32: 0.104 ms at 495 TFLOP/s. The
// same work in fp32 FMAs outside the tensor cores is 0.257 ms at 67
// TFLOP/s; q, k, v and o once are 134 MB, 0.040 ms at 3.35 TB/s. mma.sync
// itself reaches about 317 TFLOP/s of TF32 on the H100, so 0.17 ms is the
// floor of this route for the products alone.
//
// Why mma.sync and not wgmma: wgmma's TF32 form needs both shared-memory
// operands K-major, and V in P.V is MN-major, so V would need a transpose in
// shared memory; the split would also need separate big and small copies of
// every B tile there. mma.sync takes its fragments from registers, so the
// split costs a few ALU instructions a fragment and no shared memory.
//
// Design: one CTA of 4 warps a (tile of 64 query rows, head, batch), the
// longest q tiles first (reversed block index), two CTAs an SM (one at hd
// 256). Each warp owns 16 query rows (the FlashAttention-2 layout) and
// walks the kv tiles of 64 keys up to its own causal reach, with
// mma.sync.m16n8k8 TF32 for S = Q.K^T (8 n-tiles of 8 keys, 32
// registers) and O += P.V (hd/8 n-tiles, 64 registers at hd 128). The
// split is two integer operations for cvt.rna (to_tf32) and one
// subtraction, on each fragment right after its shared-memory read. A
// row's scores live in the 4 lanes of one quad of the C fragment, so the
// row max is two __shfl_xor_sync steps, with no
// block barrier; each lane keeps its share of the denominator, summed over
// the quad once at the end. P stays in registers: the C fragment holds
// (row g, columns 2t and 2t+1) and the A fragment wants (row g, k-indices
// t and t+4), so the mma's k-index t is read as key 2t and t+4 as key
// 2t+1, and V's B fragment is read from rows 2t and 2t+1 to match; the sum
// over keys is the same sum. Q.K^T pairs d = 2t and 2t+1 with k-indices t
// and t+4 the same way, so each lane reads Q and K fragments as one float2.
// Q stays in shared memory; K and V have one buffer each, loaded with
// 16-byte cp.async.cg (rows past S zero-filled through the source size):
// the next tile's K is in flight during this tile's P.V and this tile's V
// during its Q.K^T and softmax, with two __syncthreads a tile. A thread
// copies one 16-byte column of every fourth row (at hd 128), so its copy
// addresses step by a constant; positions are 32-bit. Row pitches keep a
// warp's fragment reads on 32 distinct banks: Q and K rows are a multiple
// of 16 plus 8 floats apart (the float2 reads of 16 lanes), V rows 4 more
// than a multiple of 8 (rows 2t, 2t+1 of 4 lanes). Shared memory at hd 64
// (granite-moe-3b-a800m): Q, K and V rows of 72, 72 and 68 floats, 54,272
// bytes a CTA, two CTAs an SM, O 32 registers a thread. At hd 128:
// Q, K and V 34, 34 and 33 KB, 101 KB a CTA. At hd 256 (gemma-7b) the
// same design holds twice the columns: Q, K and V 68, 68 and 67 KB, 202 KB,
// so one CTA an SM (4 warps) where hd 128 has two, and O's accumulator is
// 128 registers a thread where hd 128's is 64. Measured against the
// alternatives on the H100 (tools/flash_tf32x3_variants.py, PERF.md): the
// instructions around the products, not the products, set the time, so
// each choice here is the one that issues fewer of them: cvt.rna as two
// integer operations (the cvt instruction is 21 % slower), copy addresses
// by a constant step and 32-bit positions (8 %), 4 warps and two CTAs an
// SM (8 warps of 128 rows with two stages of K and V, 202 KB and one CTA
// an SM, are 5 % slower). K and V split once a CTA into big and small
// tiles, or two m-tiles a warp, traded the split's ALU work for
// shared-memory traffic or spills and were no faster. expf and IEEE
// division throughout (no fast math), as the plain version rounds.
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kWarps = 4;                // 16 query rows a warp
constexpr int kBQ = 16 * kWarps;         // query rows a CTA
constexpr int kBKV = 64;                 // key/value rows a tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Shape {
  static constexpr int kQKPitch = HD - HD % 16 + 8;  // 16 m + 8 floats
  static constexpr int kVPitch = HD + 4;             // 8 m + 4 floats
  static constexpr int kQ = kBQ * kQKPitch;           // floats
  static constexpr int kK = kBKV * kQKPitch;
  static constexpr int kV = kBKV * kVPitch;
  static constexpr int kSmemBytes = 4 * (kQ + kK + kV);
  static constexpr int kCtasPerSm = 2 * kSmemBytes <= 232448 ? 2 : 1;
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

// Wait until every cp.async this thread committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for a finite x: round the magnitude to 10 mantissa bits,
// to nearest with ties away from zero, by adding half of the dropped 13
// bits' range to the bit pattern and clearing them (a carry steps the
// exponent, as it should). ptxas expands cvt.rna itself with checks for
// NaN and infinity (FSETP, SEL) that make the kernel 21 % slower.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32, rounded to nearest (ties away from zero).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a.b, m16n8k8, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in split TF32, the B fragment (b0, b1) split here: small.big,
// big.small, big.big, in that order.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split(b0, b0_big, b0_small);
  split(b1, b1_big, b1_small);
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

// Rows [row0, row0 + ROWS) of one head, x pointing at (b, 0, h, 0) of a
// (B, S, H, HD) tensor, into dst (ROWS x PITCH floats) by cp.async; rows
// past S as zeros. A thread copies one 16-byte column of every kPass-th
// row, so its addresses step by a constant.
template <int HD, int ROWS, int PITCH>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ x,
                                          int row0, int S,
                                          int64_t row_stride) {
  constexpr int kChunks = HD / 4;             // 16 bytes each
  constexpr int kPass = kThreads / kChunks;   // rows a pass of the CTA
  static_assert(kThreads % kChunks == 0 && ROWS % kPass == 0, "tiling");
  const int r = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  const float* src = x + (row0 + r) * row_stride + 4 * c;
  float* d = dst + r * PITCH + 4 * c;
  const int left = S - row0 - r;  // this thread's rows < S: u kPass < left
#pragma unroll
  for (int u = 0; u < ROWS / kPass; ++u) {
    const bool ok = u * kPass < left;
    cp_async16(d + u * kPass * PITCH, ok ? src + u * kPass * row_stride : x,
               ok ? 16u : 0u);
  }
}

// ------------------------------------------------------------- kernel ----
template <int HD>
__global__ void __launch_bounds__(kThreads, Shape<HD>::kCtasPerSm)
    flash_attention_tf32x3_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  float* __restrict__ o, int S, int H,
                                  float scale) {
  using Sh = Shape<HD>;
  constexpr int QP = Sh::kQKPitch, VP = Sh::kVPitch, NO = HD / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Sh::kQ;
  float* vs = ks + Sh::kK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * S * row_stride +
                       static_cast<int64_t>(blockIdx.y) * HD;
  const float* kh = k + head;
  const float* vh = v + head;
  // causal reach: the CTA's up to its last valid row, a warp's up to its own
  const int n_kv = ((q0 + kBQ < S ? q0 + kBQ : S) - 1) / kBKV + 1;
  const int w0 = q0 + 16 * warp;                   // the warp's first row
  const int w_last = (w0 + 15 < S ? w0 + 15 : S - 1);
  const int r0 = w0 + g, r1 = r0 + 8;              // this lane's two rows

  // K[kt+1] is copied during tile kt's P.V, V[kt] during tile kt's Q.K^T
  // and softmax; each wait finds only the copy it waits for in flight.
  load_rows<HD, kBQ, QP>(qs, q + head, q0, S, row_stride);
  load_rows<HD, kBKV, QP>(ks, kh, 0, S, row_stride);
  cp_async_commit();
  load_rows<HD, kBKV, VP>(vs, vh, 0, S, row_stride);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const float* qw = qs + (16 * warp) * QP;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBKV;
    cp_async_wait_all();  // K[kt] (on tile 0 with Q and V[0]) landed
    __syncthreads();      // ... for every thread; tile kt-1's P.V done
    if (kt >= 1) {
      load_rows<HD, kBKV, VP>(vs, vh, k0, S, row_stride);
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
#pragma unroll 2
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
              ks + (8 * j + g) * QP + 8 * kk + 2 * t);
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
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = e < 2 ? r0 : r1;
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
          const float p = x == kNegInf ? 0.0f : expf(x - (e < 2 ? mn0 : mn1));
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

    cp_async_wait_all();  // V[kt] landed
    __syncthreads();      // ... for every thread; every read of K[kt] done
    if (kt + 1 < n_kv) {
      load_rows<HD, kBKV, QP>(ks, kh, k0 + kBKV, S, row_stride);
      cp_async_commit();
    }

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
        const float* vr = vs + (8 * kk + 2 * t) * VP + g;
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
    const int row = half ? r1 : r0;
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
      <<<grid, kThreads, Shape<HD>::kSmemBytes, stream>>>(
          q, k, v, o, static_cast<int>(S), static_cast<int>(H), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, S, H, hd) fp32, contiguous and 16-byte aligned on the
// current device; o aliases none of the inputs. hd is 8, 16, 32, 64, 128
// or 256.
// Launches one CTA of 128 threads per (tile of 64 query rows, head, batch)
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape or an alignment it does not take.
extern "C" int flash_attention_tf32x3_launch(const void* q, const void* k,
                                             const void* v, void* o,
                                             int64_t B, int64_t S, int64_t H,
                                             int64_t hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535 || S > 0x7fffffff - kBQ)
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
    case 64: return launch<64>(qf, kf, vf, of, B, S, H, s);
    case 128: return launch<128>(qf, kf, vf, of, B, S, H, s);
    case 256: return launch<256>(qf, kf, vf, of, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
