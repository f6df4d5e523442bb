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
//
// Word path (the `_words` entries, for W % 8 != 0, where a slice at
// (row * 9 + lane) * W words need not start on a 16-byte boundary). The
// gather runs one thread per (page, group of 8 words), in a grid-stride
// loop over the n * W groups: it fetches its group slice by slice
// (groups.cuh load_group; the warp's next loads hit the sectors its first
// brought in) and stores it as two vectors into the page's row of the
// output. The scatter runs one thread per word of the batch, in a
// grid-stride loop over its n * 8W words (word t is word f = t mod 8W of
// page t / 8W, word f mod W of its slice f / W): neighbouring threads
// store neighbouring words of a slice, so a warp's 4-byte stores
// coalesce, where a group's eight stores would each touch 32 sectors (on
// an H100 at W = 60, 4096 pages: the group scatter 0.0276 ms, this one
// 0.0137; a per-word gather 0.0142, the group gather 0.0102).
#include "coords.cuh"
#include "groups.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

__global__ void interwrap_gather_kernel(const int32_t* __restrict__ storage,
                                        const int32_t* __restrict__ pages,
                                        int32_t* __restrict__ out, int W,
                                        int num_rows) {
  const int i = blockIdx.x, k = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      storage + slice_start(whole_interwrap(W, num_rows), pages[i], k));
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
      storage + slice_start(whole_interwrap(W, num_rows), pages[i], k));
  for (int t = threadIdx.x; t < W / 4; t += blockDim.x) dst[t] = src[t];
}

// Threads per block: one 16-byte vector each, whole warps, at most 256.
int copy_threads(int W) {
  const int t = ceil_div(W / 4, 32) * 32;
  return t < 256 ? t : 256;
}

// Word t of the batch (word t mod 8W of page t / 8W) -> its offset in
// storage.
__device__ __forceinline__ size_t batch_word(const int32_t* __restrict__ pages,
                                             int t, int W, int num_rows) {
  const int i = t / (8 * W), f = t - i * 8 * W, k = f / W;
  return slice_start(whole_interwrap(W, num_rows), pages[i], k) +
         (f - k * W);
}

__global__ void interwrap_gather_words_kernel(
    const int32_t* __restrict__ storage, const int32_t* __restrict__ pages,
    int32_t* __restrict__ out, int n, int W, int num_rows) {
  const PageGeom g = whole_interwrap(W, num_rows);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n * W;
       t += gridDim.x * blockDim.x) {
    const int i = t / W, j = t - i * W;
    uint4 a, b;
    load_group(storage, g, pages[i], j, a, b);
    uint4* dst =
        reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * 8 * W) +
        2 * j;
    dst[0] = a;
    dst[1] = b;
  }
}

__global__ void interwrap_scatter_words_kernel(
    int32_t* __restrict__ storage, const int32_t* __restrict__ pages,
    const int32_t* __restrict__ data, int n, int W, int num_rows) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n * 8 * W;
       t += gridDim.x * blockDim.x) {
    storage[batch_word(pages, t, W, num_rows)] = data[t];
  }
}

}  // namespace

// The word path's entries, for W % 8 != 0: the arguments of the entries
// below.
extern "C" int interwrap_gather_words(const void* storage, const void* pages,
                                      void* out, int n, int W, int num_rows,
                                      void* stream) {
  interwrap_gather_words_kernel<<<group_blocks(n * W), kGroupThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(out), n, W, num_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int interwrap_scatter_words(void* storage, const void* pages,
                                       const void* data, int n, int W,
                                       int num_rows, void* stream) {
  interwrap_scatter_words_kernel<<<group_blocks(n * 8 * W), kGroupThreads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(data), n, W, num_rows);
  return static_cast<int>(cudaGetLastError());
}

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
