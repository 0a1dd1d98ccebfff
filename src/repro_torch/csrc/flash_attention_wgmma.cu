// Causal flash attention on Hopper's tensor cores, bf16 at head dims 64,
// 128 and 256: the prefill of the serving path,
//
//     o[b, s, h] = sum over t <= s of softmax_t(q[b,s,h] . k[b,t,h] * scale)
//                  * v[b, t, h],                  scale = 1 / sqrt(hd)
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _make_kernel) for every bf16 call at hd 64
// (granite-moe-3b-a800m), hd 128 (internlm2-1.8b, minitron-8b,
// starcoder2-3b) and hd 256 (gemma-7b); csrc/flash_attention.cu keeps bf16
// at hd 8/16/32. It computes what the
// TPU kernel computes: scores in fp32, the top-left causal mask kpos <= qpos
// with NEG_INF = -1e30, an online softmax with the running max and
// denominator in fp32, the denominator clamped at 1e-30, kv tiles past
// causal reach skipped, the output rounded once to bf16 (nearest even). It
// reads q, k, v and writes o in the model layout (B, S, H, hd) in place;
// the tail past S is masked out of the max and the sum, and rows past S are
// not written. The TPU kernel multiplies an fp32 P by V widened to fp32;
// the tensor cores take bf16 operands, so P goes in as two bf16 terms, hi =
// bf16(P) and lo = bf16(P - hi), two products P.V summed in fp32: within
// about 2^-17 relative of each P (V is bf16, exact in either). P rounded
// once to bf16 (at most 2^-9 relative) moved a 60-layer bf16 prefill's
// logits (llava-next-34b) past the serving check's bound against the naive
// attention (PERF.md). Q.K^T multiplies bf16 values exactly in fp32; only
// the summation order differs.
//
// Bound: device memory at hd 64 and 128, about even at hd 256. At the
// prefill (B*H = 64, S = 1,024) q, k, v and o once are 33.6 MB at hd 64,
// 0.010 ms at 3.35 TB/s, above the 8.6 GFLOP of the causal half at 989
// TFLOP/s on the tensor cores (0.0087 ms); 67.1 MB at hd 128, 0.020 ms,
// above 17.2 GFLOP (0.017 ms); at hd 256 134 MB, 0.040 ms, beside 34.4
// GFLOP, 0.035 ms. A kernel without overlap of softmax and products reaches
// neither; this one keeps the loads off the critical path and the products
// on wgmma.
//
// Design (one CTA a (tile of 128 query rows, head, batch), longest q tiles
// first): three warpgroups. Warpgroup 2 is the producer: it gives back its
// registers (setmaxnreg), and one thread loads Q once and the K and V tiles
// into a ring of two stages with TMA, through a 4-D tensor map over the
// (B, S, H, hd) strides in 128-byte-swizzled boxes of 64 columns (hd / 64
// boxes a row); full and empty mbarriers pace the ring (TMA fills rows
// past S with zeros). Warpgroups 0 and 1 are consumers of 64 query rows
// each, with 240 registers a thread: S = Q.K^T by hd / 16 wgmma (bf16 ->
// fp32, both operands from shared memory); the mask only on the diagonal
// and tail tiles; the online softmax on the accumulator registers (a row
// spans 4 lanes: two shuffles); P split into its bf16 hi and lo terms in
// registers, where the accumulator's layout is the A operand's, for O +=
// hi.V + lo.V by wgmma with A from registers and V a transposed (MN-major)
// B from shared memory, whose N is hd; O a 64 x hd fp32 accumulator. Then O / max(l, 1e-30) rounded to
// bf16 and stored for rows < S. The kv tile is what the 227 KB of shared
// memory and the consumers' registers leave room for:
//   hd 64:  128-key tiles of 16 KB (one box a row), Q 16 KB, 81 KB in all;
//           S by wgmma.m64n128k16 over 4 k-steps, P.V by m64n64k16 over
//           8 twice; S, P's two terms and O take 64 + 64 + 32 registers
//           a thread; scale
//           1/8 exactly;
//   hd 128: 128-key tiles of 32 KB, Q 32 KB, 161 KB in all; S by
//           wgmma.m64n128k16 over 8 k-steps, P.V by m64n128k16 over 8
//           twice; S, P's two terms and O take 64 + 64 + 64 registers a
//           thread;
//   hd 256: 64-key tiles of 32 KB, Q 64 KB, 193 KB in all (128-key tiles
//           would need 321 KB); S by wgmma.m64n64k16 over 16 k-steps, P.V
//           by m64n256k16 over 4 twice; S, P's two terms and O take 32 +
//           32 + 128 registers (128-key tiles would need 256); scale 1/16
//           exactly.
#include <cuda.h>  // CUtensorMap and its enums only: no driver library linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 128;                   // query rows a CTA
constexpr int kStages = 2;                 // K/V ring
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
constexpr int kRow = 128;                  // bytes: a box row, 64 bf16

// The tiles of a head dim: a row of HD columns is HD / 64 boxes of 64
// columns (128 bytes, the swizzle's span), each box its rows in a block.
template <int HD>
struct Tiles {
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "built at hd 64, 128 and 256");
  static constexpr int kBKV = HD == 256 ? 64 : 128;  // key/value rows a tile
  static constexpr int kBoxes = HD / 64;
  static constexpr int kQBox = kBQ * kRow;           // 16 KB
  static constexpr int kKVBox = kBKV * kRow;         // 16 or 8 KB
  static constexpr int kQTile = kBoxes * kQBox;      // 16, 32 or 64 KB
  static constexpr int kKVTile = kBoxes * kKVBox;    // 16 or 32 KB
  // Q and kStages of K and V, + 1 KB to align: 81, 161 or 193 KB
  static constexpr int kSmem = kQTile + 2 * kStages * kKVTile + 1024;
};
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box {64 columns, 1 head, rows, 1 batch} of a (B, S, H, hd) map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// A 128-byte-swizzled shared-memory matrix descriptor; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Keeps nvcc from moving reads or writes of accumulator registers across a
// wgmma's issue or wait (the asm names them as read and written).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The accumulator operands of a wgmma: "+f" of d[i .. i + 3] and up.
#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) \
  ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC64(d, i) \
  ACC16(d, i), ACC16(d, i + 16), ACC16(d, i + 32), ACC16(d, i + 48)
#define D32(d) ACC16(d, 0), ACC16(d, 16)
#define D64(d) ACC64(d, 0)
#define D128(d) ACC64(d, 0), ACC64(d, 64)

// ... and their names in the instruction
#define R32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31" \
  "}"

#define R64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"

#define R128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127" \
  "}"

// d (+)= A.B, m64nNk16 with N = 2 x d's length (64 or 128 here), A and B
// K-major in shared memory; scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A.B, m64nNk16 with N = 2 x d's length (64, 128 or 256 here), A (4
// registers of bf16 pairs a thread) from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D128(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- kernel ----
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o, int S, int H,
                                 float scale) {
  using T = Tiles<HD>;
  constexpr int BKV = T::kBKV;
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + T::kQTile;            // kStages tiles
  const uint32_t v_s = k_s + kStages * T::kKVTile; // kStages tiles
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t full_q = smem_u32(&bars[0]);
  const uint32_t full_k = smem_u32(&bars[1]);      // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int q_tile = n_q - 1 - static_cast<int>(blockIdx.x);
  const int q0 = q_tile * kBQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  const int n_kv = q_last / BKV + 1;               // causal reach

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread starts every load, a box at a time
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(full_q, T::kQTile);
      for (int b = 0; b < T::kBoxes; ++b)
        tma_load(q_s + b * T::kQBox, &tq, full_q, 64 * b, head, q0, batch);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        const uint32_t ks = k_s + s * T::kKVTile, vs = v_s + s * T::kKVTile;
        mbar_expect_tx(full_k + 8 * s, T::kKVTile);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load(ks + b * T::kKVBox, &tk, full_k + 8 * s, 64 * b, head,
                   kt * BKV, batch);
        mbar_expect_tx(full_v + 8 * s, T::kKVTile);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load(vs + b * T::kKVBox, &tv, full_v + 8 * s, 64 * b, head,
                   kt * BKV, batch);
      }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows q0 + 64 g + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int g = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, c2 = 2 * (lane % 4);
    // this thread's two rows; its columns of S are 8 j + c2 + {0, 1} for
    // j < BKV / 8, of O the same for j < HD / 8
    const int r0 = q0 + 64 * g + 16 * (t / 32) + lane / 4, r1 = r0 + 8;

    float acc[HD / 2], s[BKV / 2];
    uint32_t p[BKV / 4], p_lo[BKV / 4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(full_q, 0);
    const uint32_t q_g = q_s + g * 64 * kRow;      // 64 rows on in each box
    for (int kt = 0; kt < n_kv; ++kt) {
      const int st = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const uint32_t ks = k_s + st * T::kKVTile, vs = v_s + st * T::kKVTile;
      const int k0 = kt * BKV;

      // S = Q.K^T over hd in steps of 16 (32 bytes of a 128-byte box row)
      mbar_wait(full_k + 8 * st, parity);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(q_g + (kk / 4) * T::kQBox + col, 16, 1024),
                 sw128_desc(ks + (kk / 4) * T::kKVBox + col, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask (diagonal and tail tiles only), row max
      const bool masked = k0 + BKV - 1 > q0 + 64 * g || k0 + BKV > S;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (masked) {
            const int kpos = k0 + 8 * j + c2 + (e & 1);
            const int qpos = e < 2 ? r0 : r1;
            if (!(kpos <= qpos && kpos < S)) x = kNegInf;
          }
          s[4 * j + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          const float pe = x == kNegInf ? 0.0f : expf(x - (e < 2 ? mn0 : mn1));
          s[4 * j + e] = pe;
          if (e < 2) ps0 += pe; else ps1 += pe;
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= al0;
        acc[4 * j + 1] *= al0;
        acc[4 * j + 2] *= al1;
        acc[4 * j + 3] *= al1;
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      // P as two bf16 terms, P = hi + lo + O(2^-17 P): hi = bf16(P), lo =
      // bf16(P - hi) (P - hi is exact in fp32); accumulator columns
      // 16 kk + [0, 16) are A's k-step kk. A .x sits in a pair's low half
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) {
        const uint32_t hi = pack_bf16(s[2 * i], s[2 * i + 1]);
        p[i] = hi;
        p_lo[i] = pack_bf16(s[2 * i] - __uint_as_float(hi << 16),
                            s[2 * i + 1] - __uint_as_float(hi & 0xffff0000u));
      }

      // O += hi.V + lo.V over the tile's keys in steps of 16 rows of V;
      // V's rows of HD columns are N, its boxes T::kKVBox bytes apart
      mbar_wait(full_v + 8 * st, parity);
      fence_regs(acc);
      fence_regs(p);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 sw128_desc(vs + kk * 16 * kRow, T::kKVBox, 1024));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                 p_lo[4 * kk + 3],
                 sw128_desc(vs + kk * 16 * kRow, T::kKVBox, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p);
      fence_regs(p_lo);
      mbar_arrive(empty + 8 * st);
    }

    // the row sums over the 4 lanes of a row, then O / max(l, 1e-30)
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int64_t row_stride = static_cast<int64_t>(H) * HD;
    __nv_bfloat16* ob = o + static_cast<int64_t>(batch) * S * row_stride +
                        static_cast<int64_t>(head) * HD + c2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      if (row < S) {
        const float d = half ? d1 : d0;
        __nv_bfloat16* orow = ob + row * row_stride;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half] / d,
                                    acc[4 * j + 2 * half + 1] / d);
      }
    }
  }
}

// ---------------------------------------------------------- host side ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, H, hd) bf16 tensor as a 4-D map, boxes of {64, 1, rows, 1}
// elements, 128-byte swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* x, int64_t B, int64_t S,
              int64_t H, int64_t hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd * 2),
                                 static_cast<cuuint64_t>(H * hd * 2),
                                 static_cast<cuuint64_t>(S * H * hd * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tiles<HD>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t H, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, HD, kBQ) ||
      !make_map(&tk, k, B, S, H, HD, Tiles<HD>::kBKV) ||
      !make_map(&tv, v, B, S, H, HD, Tiles<HD>::kBKV))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_attention_wgmma_kernel<HD>
      <<<grid, kThreads, Tiles<HD>::kSmem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<int>(S),
          static_cast<int>(H), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, S, H, hd) bf16, contiguous and 16-byte aligned on the
// current device; o aliases none of the inputs; hd is 64, 128 or 256.
// Launches one CTA per (tile of 128 query rows, head, batch) on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take and cudaErrorNotSupported when the driver gives no
// cuTensorMapEncodeTiled or refuses a map.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            int64_t B, int64_t S, int64_t H,
                                            int64_t hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535 || S > 0x7fffffff - kBQ ||
      (hd != 64 && hd != 128 && hd != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) & 15u)
      return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, B, S, H, s);
    case 128: return launch<128>(q, k, v, o, B, S, H, s);
    default: return launch<256>(q, k, v, o, B, S, H, s);
  }
}
