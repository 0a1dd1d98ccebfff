// Causal flash attention in bf16 at head dims 8, 16 and 32:
//
//     o[b, s, h] = sum over t <= s of softmax_t(q[b,s,h] . k[b,t,h] * scale)
//                  * v[b, t, h],                  scale = 1 / sqrt(hd)
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _make_kernel) for bf16 at the small head
// dims. The TPU kernel walks a sequential grid
// (B*H, n_q, n_kv) with (256, 512) blocks sized for VMEM and carries the
// running max, denominator and accumulator in VMEM scratch from one kv step
// to the next. Here a block owns one (b, h, tile of 64 query rows) and walks
// the kv tiles in a loop, keeping the accumulator in registers. It computes
// what the TPU kernel computes: scores in fp32, the top-left causal mask
// kpos <= qpos with NEG_INF = -1e30, an online softmax with a running max,
// denominator and fp32 accumulator, the denominator clamped at 1e-30, the
// output rounded once to bf16, and kv tiles beyond causal reach
// skipped (the loop stops at the block's last row). It reads q, k, v and
// writes o in the model layout (B, S, H, hd) in place, so the caller makes
// no (B*H, S, hd) transpose; the (B*H, S, hd) layout is the case H = 1.
// The tail past S is masked, not padded: K and V rows past S are staged as
// zeros and never enter the max or the sum, and Q rows past S are not
// written.
//
// This kernel takes bf16 at hd 8, 16 and 32, the small head dims of the
// kernel tests; every fp32 call goes to csrc/flash_attention_tf32x3.cu and
// every bf16 call at hd 64, 128 and 256, the models' prefills, to
// csrc/flash_attention_wgmma.cu, both on the tensor cores.
//
// Bound: operations, at the fp32 FMA rate, the pipe its products run on
// (bf16 is widened to fp32 as it is staged): at B*H = 64, S = 1,024 and hd
// 32 the 4.3 GFLOP of the causal half take 0.064 ms at 67 TFLOP/s. The
// same work in bf16 on the tensor cores would be bound by its bytes, q, k,
// v and o once, 16.8 MB, 0.005 ms at 3.35 TB/s (the bound chip_smoke.py
// reports for it).
//
// Design: 256 threads as a 16 x 16 grid. Thread (ty, tx) holds the scores of
// rows ty + 16 r and columns tx + 16 c (r, c < 4) of each 64 x 64 tile, and
// the output columns tx + 16 i of the same rows, so a row's max is a
// shuffle over the 16 lanes of a half-warp and the rescale by alpha stays in
// registers. Q stays in shared memory for the whole block; K and then V of a
// tile share one buffer; P goes through shared memory to the P.V product.
// Everything in shared memory is fp32 (bf16 is widened as it is staged), in
// rows padded by 4 floats so the float4 reads of 8 neighbouring rows fall in
// different banks. Each thread sums its own columns' share of the
// denominator and the shares are summed once at the end. The q tiles run
// longest first (reversed block index), so the blocks with the most kv tiles
// start first. expf and IEEE division throughout (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows a block
constexpr int kBKV = 64;        // key/value rows a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPP = kBKV + 16;  // P's row pitch: two rows of a warp 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + 64) of one head, x pointing at (b, 0, h, 0) of a
// (B, S, H, HD) bf16 tensor, into dst (64 x PITCH fp32); rows past S as
// zeros.
template <int HD, int PITCH>
__device__ __forceinline__ void stage(float* dst,
                                      const __nv_bfloat16* __restrict__ x,
                                      int64_t row0, int64_t S,
                                      int64_t row_stride) {
  for (int i = threadIdx.x; i < kBKV * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int64_t row = row0 + r;
    dst[r * PITCH + d] =
        row < S ? __bfloat162float(x[row * row_stride + d]) : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int64_t S,
                           int64_t H, float scale) {
  constexpr int PITCH = HD + 4;
  constexpr int NO = (HD + 15) / 16;  // output columns a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x PITCH
  float* kv = qs + kBQ * PITCH;                 // kBKV x PITCH: K, then V
  float* ps = kv + kBKV * PITCH;                // kBQ x kPP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t n_q = (S + kBQ - 1) / kBQ;
  const int64_t q0 = (n_q - 1 - static_cast<int64_t>(blockIdx.x)) * kBQ;
  const int64_t row_stride = H * HD;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * S * row_stride +
                       static_cast<int64_t>(blockIdx.y) * HD;
  stage<HD, PITCH>(qs, q + head, q0, S, row_stride);

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[r][i] = 0.0f;
  }

  // causal reach: the kv tiles up to the one holding the last valid row
  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  const int64_t n_kv = q_last / kBKV + 1;
  for (int64_t kt = 0; kt < n_kv; ++kt) {
    const int64_t k0 = kt * kBKV;
    __syncthreads();  // Q staged; the last tile's reads of kv and ps done
    stage<HD, PITCH>(kv, k + head, k0, S, row_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * PITCH + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = *reinterpret_cast<const float4*>(kv + (tx + 16 * c) * PITCH + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r].x, kb[c].x, s[r][c]);
          s[r][c] = fmaf(qa[r].y, kb[c].y, s[r][c]);
          s[r][c] = fmaf(qa[r].z, kb[c].z, s[r][c]);
          s[r][c] = fmaf(qa[r].w, kb[c].w, s[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t qpos = q0 + ty + 16 * r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kpos = k0 + tx + 16 * c;
        ok[c] = kpos <= qpos && kpos < S;
        s[r][c] = ok[c] ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // every row sees key 0 in tile 0, so m_new is a real score from
      // there on and alpha = expf(-1e30 - m_new) = 0 on the first tile
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.0f;
        ps[(ty + 16 * r) * kPP + tx + 16 * c] = p;
        part += p;
      }
      l[r] = l[r] * alpha + part;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[r][i] *= alpha;
    }
    __syncthreads();  // every read of K done, P written
    stage<HD, PITCH>(kv, v + head, k0, S, row_stride);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * kPP + j);
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int col = tx + 16 * i;
        if (col < HD) {  // false only for HD < 16
          const float* vc = kv + j * PITCH + col;
          const float v0 = vc[0], v1 = vc[PITCH], v2 = vc[2 * PITCH],
                      v3 = vc[3 * PITCH];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][i] = fmaf(pa[r].x, v0, acc[r][i]);
            acc[r][i] = fmaf(pa[r].y, v1, acc[r][i]);
            acc[r][i] = fmaf(pa[r].z, v2, acc[r][i]);
            acc[r][i] = fmaf(pa[r].w, v3, acc[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float denom = fmaxf(half_warp_sum(l[r]), 1e-30f);
    const int64_t row = q0 + ty + 16 * r;
    if (row < S) {
      __nv_bfloat16* orow = o + head + row * row_stride;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int col = tx + 16 * i;
        // round to nearest even, as PyTorch casts
        if (col < HD) orow[col] = __float2bfloat16(acc[r][i] / denom);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t H, cudaStream_t stream) {
  constexpr int PITCH = HD + 4;
  const int smem =
      static_cast<int>(sizeof(float)) * ((kBQ + kBKV) * PITCH + kBQ * kPP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, S, H, hd) bf16, contiguous on the current device; o
// aliases none of the inputs. hd is 8, 16 or 32. Launches one block per
// (tile of 64 query rows, head, batch) on `stream` and returns
// cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t S, int64_t H, int64_t hd,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535 || (S + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(q, k, v, o, B, S, H, s);
    case 16: return launch<16>(q, k, v, o, B, S, H, s);
    case 32: return launch<32>(q, k, v, o, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
