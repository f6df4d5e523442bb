// Fused mixed-pool page read: universal page -> (row, lane) translation,
// 16-byte vector copy, and in-register SECDED correction of protected
// pages, in one pass over device memory.
//
// Replaces the Pallas TPU kernels repro/kernels/mixed/kernel.py
// `read_correct` (:90), whose scalar-prefetched BlockSpec index map did
// the translation of repro/core/layouts.py page_coords, and
// `read_correct_routed` (:139), which composed the shard router with that
// translation inside one bank's program (see the second kernel below).
//
// Bound: memory traffic — each page's 8W words are read once and written
// once, plus W/8 packed code words per slice of a SECDED page. There is
// no reuse to exploit.
//
// Design: one block per (page, slice): blockIdx.x is the page's position
// in the batch, blockIdx.y the slice k of its 8. The block loads its own
// page id (the TPU's scalar prefetch), computes the slice's (row, lane)
// with the page_coords rules, and its threads each move one group of 8
// words (two 16-byte loads, two 16-byte stores; a warp covers 1 KiB of
// one slice). Pages in the SECDED region [boundary, num_rows) also load
// the matching packed code word and correct data-bit errors in registers
// before the store; other pages skip the code lane entirely. Rows are
// clamped into the pool, so a stray id cannot read outside the storage.
#include "coords.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

__global__ void mixed_read_correct_kernel(const int32_t* __restrict__ storage,
                                          const int32_t* __restrict__ pages,
                                          int32_t* __restrict__ out, int W,
                                          int interwrap, int num_rows,
                                          int boundary, int ebase) {
  const int i = blockIdx.x, k = blockIdx.y;
  const int page = pages[i];
  int row, lane;
  bool sec;
  page_slice(page, k, interwrap, num_rows, boundary, ebase, row, lane, sec);
  row = min(max(row, 0), num_rows - 1);
  lane = min(max(lane, 0), 8);
  const uint4* src = reinterpret_cast<const uint4*>(
      storage + (static_cast<size_t>(row) * 9 + lane) * W);
  const uint32_t* code = reinterpret_cast<const uint32_t*>(
      storage + (static_cast<size_t>(min(max(page, 0), num_rows - 1)) * 9 + 8)
                    * W) + k * (W / 8);
  uint4* dst = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(i) * 8 + k) * W);
  for (int t = threadIdx.x; t < W / 8; t += blockDim.x) {
    uint4 a = src[2 * t], b = src[2 * t + 1];
    if (sec) correct_group(a, b, code[t]);
    dst[2 * t] = a;
    dst[2 * t + 1] = b;
  }
}

// Router-fused read of the CREAM-Shard pool: all S banks lie in one
// contiguous (S, R_local, 9, W) tensor on the card, so one launch reads
// any global page of any bank. The TPU ran one program per bank (a
// `banks` mesh) and each zeroed the rows it did not own before a psum
// assembled the batch; here the block routes the global id itself
// (regular p -> bank p % S, local p / S; extra R + e -> bank e % S, local
// R_local + e / S), translates the local id against the bank's geometry
// and reads from that bank, which gives the psum's assembled batch with
// no zero traffic. Same bound and thread layout as above.
__global__ void mixed_read_routed_kernel(const int32_t* __restrict__ storage,
                                         const int32_t* __restrict__ pages,
                                         int32_t* __restrict__ out, int W,
                                         int interwrap, int num_rows,
                                         int num_shards, int boundary_local,
                                         int ebase) {
  const int i = blockIdx.x, k = blockIdx.y;
  const int page = pages[i];
  const int rows_local = num_rows / num_shards;
  const bool is_extra = page >= num_rows;
  const int e = page - num_rows;
  const int shard = min(max(is_extra ? e % num_shards : page % num_shards, 0),
                        num_shards - 1);
  const int local = is_extra ? rows_local + e / num_shards
                             : page / num_shards;
  int row, lane;
  bool sec;
  page_slice(local, k, interwrap, rows_local, boundary_local, ebase, row,
             lane, sec);
  row = min(max(row, 0), rows_local - 1);
  lane = min(max(lane, 0), 8);
  const int32_t* bank = storage + static_cast<size_t>(shard) * rows_local
                                      * 9 * W;
  const uint4* src = reinterpret_cast<const uint4*>(
      bank + (static_cast<size_t>(row) * 9 + lane) * W);
  const uint32_t* code = reinterpret_cast<const uint32_t*>(
      bank + (static_cast<size_t>(min(max(local, 0), rows_local - 1)) * 9
              + 8) * W) + k * (W / 8);
  uint4* dst = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(i) * 8 + k) * W);
  for (int t = threadIdx.x; t < W / 8; t += blockDim.x) {
    uint4 a = src[2 * t], b = src[2 * t + 1];
    if (sec) correct_group(a, b, code[t]);
    dst[2 * t] = a;
    dst[2 * t + 1] = b;
  }
}

}  // namespace

extern "C" int mixed_read_correct_routed(const void* storage,
                                         const void* pages, void* out, int n,
                                         int W, int interwrap, int num_rows,
                                         int num_shards, int boundary_local,
                                         int ebase, void* stream) {
  const dim3 grid(n, 8);
  mixed_read_routed_kernel<<<grid, slice_threads(W), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(out), W, interwrap, num_rows, num_shards,
      boundary_local, ebase);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixed_read_correct(const void* storage, const void* pages,
                                  void* out, int n, int W, int interwrap,
                                  int num_rows, int boundary, int ebase,
                                  void* stream) {
  const dim3 grid(n, 8);
  mixed_read_correct_kernel<<<grid, slice_threads(W), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<const int32_t*>(pages),
      static_cast<int32_t*>(out), W, interwrap, num_rows, boundary, ebase);
  return static_cast<int>(cudaGetLastError());
}
