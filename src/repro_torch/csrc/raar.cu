// RAAR combine (Luke 2005, paper eq. 7), per complex element:
//
//     out = 2*beta*p21 + (1 - 2*beta)*p1 + beta*(psi - p2)
//
// Replaces the TPU kernel repro/kernels/raar/kernel.py:raar_combine (body
// _make_kernel), which takes eight split fp32 planes and fixes beta at
// compile time. Here the four fields are complex64 read in place as float2
// (the torch.view_as_real layout) and beta is a runtime argument, so one
// build serves every beta.
//
// The solver passes the same tensor as p21 and p2 (SHARP's single-overlap
// approximation); the kernel only reads its inputs, so aliased inputs are
// fine and it still computes the four-input function.
//
// Bound: device memory. Four 8 B inputs and one 8 B output, 40 B an
// element; at F = 512 frames of 64x64 that is 83.9 MB, about 25 us at
// 3.35 TB/s. Design: one coalesced grid-stride pass, the fused update the
// TPU kernel made, at one read of each input and one write.
//
// __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from contracting into fused
// multiply-adds, so the sum rounds in the plain PyTorch version's order.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

__device__ __forceinline__ float combine(float psi, float p1, float p21,
                                         float p2, float c21, float c1,
                                         float beta) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c21, p21), __fmul_rn(c1, p1)),
                   __fmul_rn(beta, __fsub_rn(psi, p2)));
}

__global__ void raar_combine_kernel(const float2* __restrict__ psi,
                                    const float2* __restrict__ p1,
                                    const float2* __restrict__ p21,
                                    const float2* __restrict__ p2,
                                    float2* __restrict__ out, int64_t n,
                                    float beta) {
  const float c21 = 2.0f * beta;
  const float c1 = 1.0f - c21;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float2 s = psi[i], q1 = p1[i], q21 = p21[i], q2 = p2[i];
    out[i] = make_float2(combine(s.x, q1.x, q21.x, q2.x, c21, c1, beta),
                         combine(s.y, q1.y, q21.y, q2.y, c21, c1, beta));
  }
}

}  // namespace

// psi, p1, p21, p2, out: n complex64 values each, contiguous and on the
// current device; inputs may alias one another but not out. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int raar_combine_launch(const void* psi, const void* p1,
                                   const void* p21, const void* p2, void* out,
                                   int64_t n, float beta, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, kMaxBlocks);
  raar_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(psi), static_cast<const float2*>(p1),
      static_cast<const float2*>(p21), static_cast<const float2*>(p2),
      static_cast<float2*>(out), n, beta);
  return static_cast<int>(cudaGetLastError());
}
