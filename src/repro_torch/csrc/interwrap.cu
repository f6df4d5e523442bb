// InterWrap (Solution 3) page gather and in-place page scatter over a pool
// whose CREAM region covers every row.
//
// Replaces the Pallas TPU kernels repro/kernels/interwrap/kernel.py
// `gather` (:51) and `scatter` (:76), whose scalar-prefetched BlockSpec
// index maps carried out the bridge chip's translation. Here each block
// computes it on the card: for slice k of page p, l = 8*slot + k,
// lane = l mod 9, row = 8*group + l div 9, and an extra page e = p - R
// takes group e and slot 8 (coords.cuh's page_slice with boundary = R).
//
// Bound: memory traffic — each page's 8W words are read once and written
// once, and there is no arithmetic to speak of.
//
// Design: one block per (page, slice): blockIdx.x is the page's position in
// the batch, blockIdx.y the slice k of its 8. The block loads its own page
// id (the TPU's scalar prefetch) and its threads copy the W-word slice with
// 16-byte loads and stores, neighbouring threads on neighbouring addresses.
// The scatter writes the storage in place (the TPU kernel aliased its
// output to the storage): its page ids must be distinct, since two blocks
// writing one cell would race; the pool lands only the last valid row of
// each page before it calls this (repro_torch.core.pool._landing_rows).
// Rows are clamped into the pool, so a stray id never touches memory
// outside the storage.
#include "coords.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

__device__ __forceinline__ size_t slice_offset(int page, int k, int W,
                                               int num_rows) {
  int row, lane;
  bool sec;
  page_slice(page, k, 1, num_rows, num_rows, 0, row, lane, sec);
  row = min(max(row, 0), num_rows - 1);
  lane = min(max(lane, 0), 8);
  return (static_cast<size_t>(row) * 9 + lane) * W;
}

__global__ void interwrap_gather_kernel(const int32_t* __restrict__ storage,
                                        const int32_t* __restrict__ pages,
                                        int32_t* __restrict__ out, int W,
                                        int num_rows) {
  const int i = blockIdx.x, k = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      storage + slice_offset(pages[i], k, W, num_rows));
  uint4* dst = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(i) * 8 + k) * W);
  for (int t = threadIdx.x; t < W / 4; t += blockDim.x) dst[t] = src[t];
}

__global__ void interwrap_scatter_kernel(int32_t* __restrict__ storage,
                                         const int32_t* __restrict__ pages,
                                         const int32_t* __restrict__ data,
                                         int W, int num_rows) {
  const int i = blockIdx.x, k = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      data + (static_cast<size_t>(i) * 8 + k) * W);
  uint4* dst = reinterpret_cast<uint4*>(
      storage + slice_offset(pages[i], k, W, num_rows));
  for (int t = threadIdx.x; t < W / 4; t += blockDim.x) dst[t] = src[t];
}

// Threads per block: one 16-byte vector each, whole warps, at most 256.
int copy_threads(int W) {
  const int t = ceil_div(W / 4, 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" int interwrap_gather(const void* storage, const void* pages,
                                void* out, int n, int W, int num_rows,
                                void* stream) {
  interwrap_gather_kernel<<<dim3(n, 8), copy_threads(W), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(out), W, num_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int interwrap_scatter(void* storage, const void* pages,
                                 const void* data, int n, int W, int num_rows,
                                 void* stream) {
  interwrap_scatter_kernel<<<dim3(n, 8), copy_threads(W), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(data), W, num_rows);
  return static_cast<int>(cudaGetLastError());
}
