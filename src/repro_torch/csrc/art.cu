// ART (Kaczmarz) row-action sweep, paper §IV Fig. 12, batched over slices:
//
//     for each sweep, for each row j in order, for each slice s:
//         f_s += beta * (b_sj - <A_j, f_s>) * inv_rip_j * A_j
//
// Replaces the TPU kernel repro/kernels/art/kernel.py:art_sweep (body
// _make_kernel), which takes one slice per call (the solver vmaps it), keeps
// f resident in VMEM as an output block with a constant index map across the
// sequential grid (iters, nrow), streams A's dense rows, and fixes beta at
// compile time. Here beta and iters are runtime arguments, the slices are
// the grid, and A is read as CSR: only its non-zeros. A parallel-ray row
// holds 541 non-zeros of 65,536 on average at nray 256, and skipping the
// zeros changes no update (f + c * 0 = f); only the dot's summation order
// differs from the dense sweep.
//
// Bound: the dependent chain of row steps, not device memory. The bytes
// these inputs need: the CSR's column indices and values once a sweep (at
// nray 256 and 76 angles, 10.5 M non-zeros, 84 MB, more than the 50 MB L2),
// its row pointers, b, and f in and out once: 178 MB for a stream launch of
// 16 slices and two sweeps, 0.053 ms at 3.35 TB/s. But row j + 1's dot
// reads what row j wrote, so a launch is nrow x iters steps in a chain, each
// a gather of f from the L2, a warp-shuffle sum and a scatter: some hundreds
// of cycles of latency a step, whatever the bytes.
//
// Design: one warp owns a slice and is a block of its own, so a row step
// needs no block barrier (four slices a block, sharing the row's pairs
// through the L1, measured slower on the H100). For each row in order, each
// lane holds up to kPer of the row's pairs in registers (lane, lane + 32,
// ...; loaded, coalesced, while the previous row finished), gathers f at
// those columns, and sums its
// products; a butterfly shuffle sum gives every lane the same dot (IEEE
// addition commutes). The coefficient c = beta * ((b_j - dot) * inv_rip_j)
// is formed with __fmul_rn/__fsub_rn and the update f[col] = f[col] + c *
// val with __fadd_rn/__fmul_rn, so nvcc contracts neither into a fused
// multiply-add and they round as the plain PyTorch version does. Each lane
// writes back the f values it gathered (a row's columns are distinct, so no
// other lane touches them within the row); __syncwarp() then orders these
// stores before the next row's gathers, which read what other lanes wrote.
// A row with more than 32 x kPer non-zeros takes its tail in a plain loop.
// f stays in the output buffer (a slice's f is 256 KB at nray 256, more than
// a block's shared memory); 16 slices' f, 4 MB, stay in the L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPer = 24;  // pairs a lane holds: rows of up to 768 in one pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row j's bounds, and the (col, val) pairs lane, lane + 32, ... of its
// first 32 x kPer into registers (0 past the row's end).
__device__ __forceinline__ void fetch_row(const int64_t* __restrict__ row_ptr,
                                          const int* __restrict__ col,
                                          const float* __restrict__ val,
                                          int64_t j, int lane, int64_t& start,
                                          int64_t& end, int (&nc)[kPer],
                                          float (&nv)[kPer]) {
  start = __ldg(row_ptr + j);
  end = __ldg(row_ptr + j + 1);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t k = start + lane + 32 * u;
    nc[u] = k < end ? __ldg(col + k) : 0;
    nv[u] = k < end ? __ldg(val + k) : 0.0f;
  }
}

__global__ void __launch_bounds__(32)
    art_csr_kernel(const int64_t* __restrict__ row_ptr,
                   const int* __restrict__ col, const float* __restrict__ val,
                   const float* __restrict__ b,
                   const float* __restrict__ inv_rip, float* f, int64_t nrow,
                   int64_t ncol, int64_t nslice, int64_t iters, float beta) {
  const int lane = threadIdx.x;
  const int64_t slice = blockIdx.x;
  float* fs = f + slice * ncol;
  const float* bs = b + slice * nrow;

  // the pairs of the next row, prefetched one row ahead
  int nc[kPer];
  float nv[kPer];
  int64_t start, end;
  fetch_row(row_ptr, col, val, 0, lane, start, end, nc, nv);
  for (int64_t it = 0; it < iters; ++it) {
    for (int64_t j = 0; j < nrow; ++j) {
      int c_[kPer];
      float v_[kPer], x[kPer];
      const int64_t s = start, e = end;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        c_[u] = nc[u];
        v_[u] = nv[u];
      }
      const float bj = bs[j], rj = __ldg(inv_rip + j);
      // gather, then the next row's pairs while the gathers are in flight
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        x[u] = s + lane + 32 * u < e ? fs[c_[u]] : 0.0f;
      const int64_t jn = j + 1 < nrow ? j + 1 : 0;
      if (j + 1 < nrow || it + 1 < iters)
        fetch_row(row_ptr, col, val, jn, lane, start, end, nc, nv);
      float dot = 0.0f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) dot = fmaf(v_[u], x[u], dot);
      for (int64_t k = s + 32 * kPer + lane; k < e; k += 32)
        dot = fmaf(__ldg(val + k), fs[__ldg(col + k)], dot);
      dot = warp_sum(dot);
      const float c = __fmul_rn(beta, __fmul_rn(__fsub_rn(bj, dot), rj));
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (s + lane + 32 * u < e)
          fs[c_[u]] = __fadd_rn(x[u], __fmul_rn(c, v_[u]));
      for (int64_t k = s + 32 * kPer + lane; k < e; k += 32) {
        const int ck = __ldg(col + k);
        fs[ck] = __fadd_rn(fs[ck], __fmul_rn(c, __ldg(val + k)));
      }
      __syncwarp();  // this row's stores before the next row's gathers
    }
  }
}

}  // namespace

// The system as CSR: row_ptr (nrow + 1, int64), col (nnz, int32, ascending
// within a row, each < ncol), val (nnz, fp32); shared by every slice. b:
// nslice x nrow; inv_rip: nrow; f: nslice x ncol, holding f0 on entry and
// the result on return. All contiguous on the current device; f aliases
// none of the inputs. One warp a block, one block a slice; launches on
// `stream` and returns cudaGetLastError().
extern "C" int art_sweep_csr_launch(const void* row_ptr, const void* col,
                                    const void* val, const void* b,
                                    const void* inv_rip, void* f,
                                    int64_t nrow, int64_t ncol,
                                    int64_t nslice, int64_t iters, float beta,
                                    void* stream) {
  if (nslice <= 0 || nrow <= 0 || ncol <= 0 || iters <= 0) return 0;
  if (nslice > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  art_csr_kernel<<<static_cast<unsigned>(nslice), 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(b),
      static_cast<const float*>(inv_rip), static_cast<float*>(f), nrow, ncol,
      nslice, iters, beta);
  return static_cast<int>(cudaGetLastError());
}
