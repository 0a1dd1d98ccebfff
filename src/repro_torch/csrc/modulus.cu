// Modulus projection pi_1, the elementwise step (paper §III, eq. 1):
//
//     out = far * mag * rsqrt(|far|^2 + 1e-12)
//
// Replaces the TPU kernel repro/kernels/modulus/kernel.py:modulus_project
// (body _modulus_kernel). The TPU version takes split re/im planes because
// its vector registers are real; here complex64 is read in place as float2
// (the torch.view_as_real layout), so no split or rejoin copy is made.
//
// Bound: device memory. Per element it reads 8 B of far and 4 B of mag and
// writes 8 B of out, 20 B for 7 flops and one rsqrt; at F = 512 frames of
// 64x64 that is 41.9 MB, about 12.5 us at 3.35 TB/s. Design: one simple
// grid-stride pass, neighbouring threads on neighbouring elements so every
// load and store is coalesced, and nothing else.
//
// The arithmetic uses __fmul_rn/__fadd_rn so that nvcc does not contract it
// into fused multiply-adds: each operation rounds as the plain PyTorch
// version's separate operations do, and the two agree to 1e-6.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

__global__ void modulus_project_kernel(const float2* __restrict__ far,
                                       const float* __restrict__ mag,
                                       float2* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float2 z = far[i];
    const float power =
        __fadd_rn(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)), kEps);
    const float scale = __fmul_rn(mag[i], rsqrtf(power));
    out[i] = make_float2(__fmul_rn(z.x, scale), __fmul_rn(z.y, scale));
  }
}

}  // namespace

// far, out: n complex64 values; mag: n float32 values; all contiguous and on
// the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int modulus_project_launch(const void* far, const void* mag,
                                      void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, kMaxBlocks);
  modulus_project_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(far), static_cast<const float*>(mag),
      static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
