// Overlap-update products (paper eqs. 4-5), per element of every frame:
//
//     num = a * conj(b),   den = |b|^2
//
// Replaces the TPU kernel repro/kernels/overlap/kernel.py:overlap_products
// (body _overlap_kernel), which takes four split fp32 planes and returns
// three. Here a, b and num are complex64 read and written in place as
// float2 (the torch.view_as_real layout).
//
// b comes in two shapes. In the probe update it is the (F, H, W) object
// patches. In the object update it is the (H, W) probe, shared by every
// frame: the kernel reads it at i mod H*W instead of a copy broadcast over
// F frames, which the TPU path and the JAX solver materialise.
//
// Bound: device memory. Object update: 8 B of a in, 8 B of num and 4 B of
// den out, 20 B an element (the probe is 32 KB, read from cache); probe
// update: 28 B an element. At F = 512 frames of 64x64 that is 12.5 us and
// 17.5 us at 3.35 TB/s. Design: a simple coalesced grid-stride pass, with
// the broadcast chosen at compile time so the per-element path has no
// branch.
//
// __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from contracting the products
// into fused multiply-adds, so each result rounds as the plain PyTorch
// version's separate operations do.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

template <bool kBroadcastB>
__global__ void overlap_products_kernel(const float2* __restrict__ a,
                                        const float2* __restrict__ b,
                                        float2* __restrict__ num,
                                        float* __restrict__ den, int64_t n,
                                        int64_t b_n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float2 av = a[i];
    const float2 bv = b[kBroadcastB ? i % b_n : i];
    num[i] = make_float2(
        __fadd_rn(__fmul_rn(av.x, bv.x), __fmul_rn(av.y, bv.y)),
        __fsub_rn(__fmul_rn(av.y, bv.x), __fmul_rn(av.x, bv.y)));
    den[i] = __fadd_rn(__fmul_rn(bv.x, bv.x), __fmul_rn(bv.y, bv.y));
  }
}

}  // namespace

// a, num: n complex64 values; den: n float32 values; b: b_n complex64
// values, where b_n is n (one b per element) or divides n (b repeated over
// the leading axis). All contiguous and on the current device. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a b_n
// that does not divide n).
extern "C" int overlap_products_launch(const void* a, const void* b,
                                       void* num, void* den, int64_t n,
                                       int64_t b_n, void* stream) {
  if (n <= 0) return 0;
  if (b_n <= 0 || n % b_n != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, kMaxBlocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float2*>(a);
  const auto* pb = static_cast<const float2*>(b);
  auto* pnum = static_cast<float2*>(num);
  auto* pden = static_cast<float*>(den);
  if (b_n == n) {
    overlap_products_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(pa, pb, pnum, pden, n, b_n);
  } else {
    overlap_products_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                    0, s>>>(pa, pb, pnum, pden, n, b_n);
  }
  return static_cast<int>(cudaGetLastError());
}
