// ART (Kaczmarz) row-action sweep, paper §IV Fig. 12, batched over slices:
//
//     for each sweep, for each row j in order, for each slice s:
//         f_s += beta * (b_sj - <A_j, f_s>) * inv_rip_j * A_j
//
// Replaces the TPU kernel repro/kernels/art/kernel.py:art_sweep (body
// _make_kernel), which takes one slice per call (the solver vmaps it), keeps
// f resident in VMEM as an output block with a constant index map across the
// sequential grid (iters, nrow), and fixes beta at compile time. Here beta
// and iters are runtime arguments and the slices are the grid: the rows run
// in order inside each block, the slices in parallel, one block each. The
// system matrix A is shared by every slice of a launch.
//
// Bound: the dependent chain of row steps, not device memory. Reckoned from
// the shapes: A is shared by the blocks through the L2 but is far larger
// than it, so each sweep reads it from device memory again. At nrow x ncol
// = 19,456 x 65,536 (4.75 GiB) a sweep moves at least 5.1 GB, 1.52 ms at
// 3.35 TB/s, and a launch of iters sweeps iters times that (3.05 ms for a
// stream launch's two); the dot and axpy are 4 operations an element of A,
// a slice and a sweep, 2.44 ms for 16 slices and two sweeps at 67 TFLOP/s,
// so the bytes set the bound. But each row step waits
// for a block-wide reduction before its update, and a block streams its
// slice's f (ncol floats) and A_j from the L2 through one SM, so a launch
// takes nrow x iters steps of about (3 x ncol x 4 bytes) / (one SM's L2
// rate) each. A slice's f at ncol = 65,536 is 256 KB, more than the 227 KB
// of shared memory a block may use, so f lives in the output buffer in
// device memory, with the L2 behind it; the TPU's VMEM-resident block is not
// carried over.
//
// Design: each thread owns a fixed strided set of f's elements (float4
// chunks when ncol % 4 == 0 and the buffers are 16-byte aligned, floats
// otherwise) and reads A_j at the same positions, so the axpy needs no
// barrier. A row's dot is a per-thread partial sum, a warp-shuffle sum, and
// a cross-warp sum through shared memory behind one barrier; every warp
// sums the per-warp partials itself in the same order, so all threads get
// the same coefficient. The partials are double-buffered by row parity, so
// the next row's writes need no second barrier.
//
// __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from contracting the residual and
// the axpy into fused multiply-adds, so they round as the plain PyTorch
// version does; only the dot's summation order differs from it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 x, float acc) {
  acc = fmaf(a.x, x.x, acc);
  acc = fmaf(a.y, x.y, acc);
  acc = fmaf(a.z, x.z, acc);
  return fmaf(a.w, x.w, acc);
}

__device__ __forceinline__ float axpy(float f, float c, float a) {
  return __fadd_rn(f, __fmul_rn(c, a));
}

// kVec: read A and f as float4 (ncol % 4 == 0, 16-byte aligned buffers).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    art_sweep_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     const float* __restrict__ inv_rip, float* __restrict__ f,
                     int64_t nrow, int64_t ncol, int64_t iters, float beta) {
  __shared__ float partial[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* fs = f + static_cast<int64_t>(blockIdx.x) * ncol;
  const float* bs = b + static_cast<int64_t>(blockIdx.x) * nrow;
  const int64_t n = kVec ? ncol / 4 : ncol;
  int parity = 0;
  for (int64_t it = 0; it < iters; ++it) {
    for (int64_t j = 0; j < nrow; ++j, parity ^= 1) {
      const float* row = A + j * ncol;
      float dot = 0.0f;
      if (kVec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const float4* f4 = reinterpret_cast<const float4*>(fs);
#pragma unroll 4
        for (int64_t i = tid; i < n; i += kThreads)
          dot = dot4(__ldg(row4 + i), f4[i], dot);
      } else {
#pragma unroll 4
        for (int64_t i = tid; i < n; i += kThreads)
          dot = fmaf(__ldg(row + i), fs[i], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) partial[parity][warp] = dot;
      __syncthreads();
      dot = warp_sum(lane < kWarps ? partial[parity][lane] : 0.0f);
      const float c =
          __fmul_rn(beta, __fmul_rn(__fsub_rn(bs[j], dot), inv_rip[j]));
      if (kVec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        float4* f4 = reinterpret_cast<float4*>(fs);
#pragma unroll 4
        for (int64_t i = tid; i < n; i += kThreads) {
          const float4 a = __ldg(row4 + i);
          float4 x = f4[i];
          x.x = axpy(x.x, c, a.x);
          x.y = axpy(x.y, c, a.y);
          x.z = axpy(x.z, c, a.z);
          x.w = axpy(x.w, c, a.w);
          f4[i] = x;
        }
      } else {
#pragma unroll 4
        for (int64_t i = tid; i < n; i += kThreads)
          fs[i] = axpy(fs[i], c, __ldg(row + i));
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// A: nrow x ncol fp32, shared by every slice; b: nslice x nrow; inv_rip:
// nrow; f: nslice x ncol, holding f0 on entry and the result on return. All
// contiguous on the current device; f aliases none of the inputs. Launches
// one block per slice on `stream` and returns cudaGetLastError().
extern "C" int art_sweep_launch(const void* A, const void* b,
                                const void* inv_rip, void* f, int64_t nrow,
                                int64_t ncol, int64_t nslice, int64_t iters,
                                float beta, void* stream) {
  if (nslice <= 0 || nrow <= 0 || ncol <= 0 || iters <= 0) return 0;
  if (nslice > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(A);
  const auto* bb = static_cast<const float*>(b);
  const auto* ir = static_cast<const float*>(inv_rip);
  auto* ff = static_cast<float*>(f);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nslice);
  if (ncol % 4 == 0 && aligned16(A) && aligned16(f)) {
    art_sweep_kernel<true><<<grid, kThreads, 0, s>>>(a, bb, ir, ff, nrow,
                                                     ncol, iters, beta);
  } else {
    art_sweep_kernel<false><<<grid, kThreads, 0, s>>>(a, bb, ir, ff, nrow,
                                                      ncol, iters, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
