// Live-migration gather fused with the SECDED re-encode for each page's
// new conventional row.
//
// Replaces the Pallas TPU kernel repro/kernels/migrate/kernel.py
// `gather_encode` (:59): the InterWrap bridge translation
// l = 8*slot + k, lane = l mod 9, row = 8*group + l div 9 (extras take
// slot 8 of their group), plus the Hsiao code plane of the gathered data.
//
// Bound: memory traffic — 8W words read and written per page plus W code
// words written; 8 POPC per beat is far below the integer rate for those
// bytes.
//
// Design: the same (page, slice) grid as the mixed read. Each thread moves
// one group of 8 words with two 16-byte loads and stores, and encodes the
// group's 4 beats in registers into the one packed code word that covers
// it — every W-word slice owns an exact W/8-word range of the page's code
// plane, so slices need no shared state and the data is read once.
//
// Word path (the `_words` entry, for W % 8 != 0, where a slice owns no
// whole range of code words): one thread per (page, group) of the batch,
// in a grid-stride loop over the n * W groups. The thread fetches group j
// of its page slice by slice under the same translation (groups.cuh
// load_group with every row wrap-striped), stores it as two vectors and
// encodes it into code word j.
#include "groups.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

__global__ void migrate_gather_encode_kernel(
    const int32_t* __restrict__ storage, const int32_t* __restrict__ pages,
    int32_t* __restrict__ data, uint32_t* __restrict__ codes, int W,
    int num_rows) {
  const int i = blockIdx.x, k = blockIdx.y;
  const int page = pages[i];
  const bool is_extra = page >= num_rows;
  const int group = is_extra ? page - num_rows : page / 8;
  const int slot = is_extra ? 8 : page % 8;
  const int linear = 8 * slot + k;
  const int row = min(max(8 * group + linear / 9, 0), num_rows - 1);
  const int lane = min(max(linear % 9, 0), 8);
  const uint4* src = reinterpret_cast<const uint4*>(
      storage + (static_cast<size_t>(row) * 9 + lane) * W);
  uint4* dst = reinterpret_cast<uint4*>(
      data + (static_cast<size_t>(i) * 8 + k) * W);
  uint32_t* cdst = codes + static_cast<size_t>(i) * W + k * (W / 8);
  for (int t = threadIdx.x; t < W / 8; t += blockDim.x) {
    const uint4 a = src[2 * t], b = src[2 * t + 1];
    dst[2 * t] = a;
    dst[2 * t + 1] = b;
    cdst[t] = encode_group(a, b);
  }
}

__global__ void migrate_gather_encode_words_kernel(
    const int32_t* __restrict__ storage, const int32_t* __restrict__ pages,
    int32_t* __restrict__ data, uint32_t* __restrict__ codes, int n, int W,
    int num_rows) {
  const PageGeom g = whole_interwrap(W, num_rows);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n * W;
       t += gridDim.x * blockDim.x) {
    const int i = t / W, j = t - i * W;
    uint4 a, b;
    load_group(storage, g, pages[i], j, a, b);
    uint4* dst =
        reinterpret_cast<uint4*>(data + static_cast<size_t>(i) * 8 * W) +
        2 * j;
    dst[0] = a;
    dst[1] = b;
    codes[t] = encode_group(a, b);
  }
}

}  // namespace

// The word path's entry, for W % 8 != 0: the arguments of
// migrate_gather_encode.
extern "C" int migrate_gather_encode_words(const void* storage,
                                           const void* pages, void* data,
                                           void* codes, int n, int W,
                                           int num_rows, void* stream) {
  migrate_gather_encode_words_kernel<<<group_blocks(n * W), kGroupThreads,
                                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(data), static_cast<uint32_t*>(codes), n, W,
      num_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int migrate_gather_encode(const void* storage, const void* pages,
                                     void* data, void* codes, int n, int W,
                                     int num_rows, void* stream) {
  const dim3 grid(n, 8);
  migrate_gather_encode_kernel<<<grid, slice_threads(W), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(data), static_cast<uint32_t*>(codes), W,
      num_rows);
  return static_cast<int>(cudaGetLastError());
}
