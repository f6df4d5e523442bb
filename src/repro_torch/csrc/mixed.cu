// Fused mixed-pool page read: universal page -> (row, lane) translation,
// 16-byte vector copy, and in-register SECDED correction of protected
// pages, in one pass over device memory.
//
// Replaces the Pallas TPU kernels repro/kernels/mixed/kernel.py
// `read_correct` (:90), whose scalar-prefetched BlockSpec index map did
// the translation of repro/core/layouts.py page_coords, and
// `read_correct_routed` (:139), which composed the shard router with that
// translation inside one bank's program (see the second kernel below: its
// all-banks form on one card and its shard-local form on a banks mesh).
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
//
// Status output (optional, the serving step's metrics-on read): with a
// non-null `status` the block also keeps the worst SECDED status its
// threads' beats decoded (correct_group's 0 clean, 1 data fixed, 2 code
// fixed, 3 detected uncorrectable; 0 for pages outside the SECDED region),
// reduces it across the block (a warp max, then one shared word) and
// writes the page's worst with one atomicMax. The eight slice blocks of a
// page race on its word, so the caller zeroes `status` before the launch.
// The template keeps the status-free launch the kernel it was.
//
// Word path (the `_words` entries, for W % 8 != 0, where a slice holds no
// whole number of code groups): one thread per (page, group) of the
// batch, in a grid-stride loop over the n * W groups. The thread routes
// and translates its page as above, fetches the group's 8 words slice by
// slice (groups.cuh load_group), corrects a SECDED page's group against
// its code word (a SECDED page's data is its row's first 8W words, so code
// word j covers group j at any W), and stores the group as two vectors.
// A page's status is the atomicMax of its groups' nonzero statuses.
#include "coords.cuh"
#include "groups.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

// One block's slice of page i: its threads copy the slice's W words from
// `src` to `dst` a group of 8 words each, correcting a SECDED slice (`sec`)
// against its packed code words in registers. With kStatus the block's
// worst beat status is reduced (a warp max, then one shared word) and
// written to status[i] with at most one atomicMax.
template <bool kStatus>
__device__ __forceinline__ void copy_slice(const uint4* __restrict__ src,
                                           const uint32_t* __restrict__ code,
                                           uint4* __restrict__ dst, bool sec,
                                           int W, int32_t* __restrict__ status,
                                           int i) {
  int worst = 0;
  for (int t = threadIdx.x; t < W / 8; t += blockDim.x) {
    uint4 a = src[2 * t], b = src[2 * t + 1];
    if (sec) worst = max(worst, correct_group(a, b, code[t]));
    dst[2 * t] = a;
    dst[2 * t + 1] = b;
  }
  if constexpr (kStatus) {
    // blockDim.x is a whole number of warps (slice_threads), all of them
    // past the loop here
    __shared__ int block_worst;
    if (threadIdx.x == 0) block_worst = 0;
    __syncthreads();
    worst = __reduce_max_sync(0xFFFFFFFFu, worst);
    if ((threadIdx.x & 31) == 0 && worst) atomicMax(&block_worst, worst);
    __syncthreads();
    if (threadIdx.x == 0 && block_worst) atomicMax(status + i, block_worst);
  }
}

template <bool kStatus>
__global__ void mixed_read_correct_kernel(const int32_t* __restrict__ storage,
                                          const int32_t* __restrict__ pages,
                                          int32_t* __restrict__ out,
                                          int32_t* __restrict__ status, int W,
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
  copy_slice<kStatus>(src, code, dst, sec, W, status, i);
}

// Router-fused read of the CREAM-Shard pool, in two forms.
//
// All banks (kLocal false): all S banks lie in one contiguous
// (S, R_local, 9, W) tensor on the card, so one launch reads any global
// page of any bank. The TPU ran one program per bank (a `banks` mesh) and
// each zeroed the rows it did not own before a psum assembled the batch;
// here the block routes the global id itself (regular p -> bank p % S,
// local p / S; extra R + e -> bank e % S, local R_local + e / S),
// translates the local id against the bank's geometry and reads from that
// bank, which gives the psum's assembled batch with no zero traffic.
//
// Shard-local (kLocal true): the TPU kernel's own contract, for a pool
// whose banks lie on the ranks of a banks mesh, one bank a card.
// `storage` is this rank's one (R_local, 9, W) bank and `shard_id` its
// index; the block routes its page the same way, and a page of another
// bank is written as zeros with status 0, so that an int32 SUM
// all-reduce over the ranks assembles the batch exactly as the
// reference's psum does. Owned pages are read and corrected as above.
//
// Same bound and thread layout as the local read, and the same optional
// status output (the sharded pool's status read and the serving step's
// metrics-on gather): the templates keep the status-free all-banks launch
// the kernel it was.
template <bool kStatus, bool kLocal>
__global__ void mixed_read_routed_kernel(const int32_t* __restrict__ storage,
                                         const int32_t* __restrict__ pages,
                                         int32_t* __restrict__ out,
                                         int32_t* __restrict__ status, int W,
                                         int interwrap, int num_rows,
                                         int num_shards, int boundary_local,
                                         int ebase, int shard_id) {
  const int i = blockIdx.x, k = blockIdx.y;
  const int page = pages[i];
  const int rows_local = num_rows / num_shards;
  const bool is_extra = page >= num_rows;
  const int e = page - num_rows;
  const int shard = min(max(is_extra ? e % num_shards : page % num_shards, 0),
                        num_shards - 1);
  const int local = is_extra ? rows_local + e / num_shards
                             : page / num_shards;
  uint4* dst = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(i) * 8 + k) * W);
  if constexpr (kLocal) {
    if (shard != shard_id) {
      // another rank's page: the block writes its slice as zeros and
      // leaves the status word at the caller's 0 (the whole block takes
      // this branch, so copy_slice's barriers are not split)
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int t = threadIdx.x; t < W / 8; t += blockDim.x) {
        dst[2 * t] = z;
        dst[2 * t + 1] = z;
      }
      return;
    }
  }
  int row, lane;
  bool sec;
  page_slice(local, k, interwrap, rows_local, boundary_local, ebase, row,
             lane, sec);
  row = min(max(row, 0), rows_local - 1);
  lane = min(max(lane, 0), 8);
  const int32_t* bank =
      kLocal ? storage
             : storage + static_cast<size_t>(shard) * rows_local * 9 * W;
  const uint4* src = reinterpret_cast<const uint4*>(
      bank + (static_cast<size_t>(row) * 9 + lane) * W);
  const uint32_t* code = reinterpret_cast<const uint32_t*>(
      bank + (static_cast<size_t>(min(max(local, 0), rows_local - 1)) * 9
              + 8) * W) + k * (W / 8);
  copy_slice<kStatus>(src, code, dst, sec, W, status, i);
}

// The word path of all three reads. The local read is the routed read
// of one bank (num_shards 1 routes every id to itself).
template <bool kStatus, bool kLocal>
__global__ void mixed_read_words_kernel(const int32_t* __restrict__ storage,
                                        const int32_t* __restrict__ pages,
                                        int32_t* __restrict__ out,
                                        int32_t* __restrict__ status, int n,
                                        int W, int interwrap, int num_rows,
                                        int num_shards, int boundary_local,
                                        int ebase, int shard_id) {
  const int rows_local = num_rows / num_shards;
  const PageGeom g{W, interwrap, rows_local, boundary_local, ebase};
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n * W;
       t += gridDim.x * blockDim.x) {
    const int i = t / W, j = t - i * W;
    const int page = pages[i];
    const bool is_extra = page >= num_rows;
    const int e = page - num_rows;
    const int shard = min(
        max(is_extra ? e % num_shards : page % num_shards, 0), num_shards - 1);
    const int local = is_extra ? rows_local + e / num_shards
                               : page / num_shards;
    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * 8 * W)
                 + 2 * j;
    if (kLocal && shard != shard_id) {
      dst[0] = dst[1] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int32_t* bank =
        kLocal ? storage
               : storage + static_cast<size_t>(shard) * rows_local * 9 * W;
    uint4 a, b;
    load_group(bank, g, local, j, a, b);
    if (local >= boundary_local && local < rows_local) {
      const uint32_t code = static_cast<uint32_t>(
          bank[(static_cast<size_t>(local) * 9 + 8) * W + j]);
      const int worst = correct_group(a, b, code);
      if (kStatus && worst) atomicMax(status + i, worst);
    }
    dst[0] = a;
    dst[1] = b;
  }
}

template <bool kLocal>
int launch_words(const void* storage, const void* pages, void* out,
                 void* status, int n, int W, int interwrap, int num_rows,
                 int num_shards, int boundary_local, int ebase, int shard_id,
                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(storage);
  const auto* pg = static_cast<const int32_t*>(pages);
  auto* o = static_cast<int32_t*>(out);
  auto* stat = static_cast<int32_t*>(status);
  const int blocks = group_blocks(n * W);
  if (stat)
    mixed_read_words_kernel<true, kLocal><<<blocks, kGroupThreads, 0, s>>>(
        st, pg, o, stat, n, W, interwrap, num_rows, num_shards,
        boundary_local, ebase, shard_id);
  else
    mixed_read_words_kernel<false, kLocal><<<blocks, kGroupThreads, 0, s>>>(
        st, pg, o, nullptr, n, W, interwrap, num_rows, num_shards,
        boundary_local, ebase, shard_id);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The word path's entries, for W % 8 != 0: the arguments of the entries
// below of the same stem.
extern "C" int mixed_read_correct_words(const void* storage,
                                        const void* pages, void* out,
                                        void* status, int n, int W,
                                        int interwrap, int num_rows,
                                        int boundary, int ebase,
                                        void* stream) {
  return launch_words<false>(storage, pages, out, status, n, W, interwrap,
                             num_rows, 1, boundary, ebase, 0, stream);
}

extern "C" int mixed_read_correct_routed_words(
    const void* storage, const void* pages, void* out, void* status, int n,
    int W, int interwrap, int num_rows, int num_shards, int boundary_local,
    int ebase, void* stream) {
  return launch_words<false>(storage, pages, out, status, n, W, interwrap,
                             num_rows, num_shards, boundary_local, ebase, 0,
                             stream);
}

extern "C" int mixed_read_correct_routed_local_words(
    const void* bank, const void* pages, void* out, void* status, int n,
    int W, int interwrap, int num_rows, int num_shards, int boundary_local,
    int ebase, int shard_id, void* stream) {
  return launch_words<true>(bank, pages, out, status, n, W, interwrap,
                            num_rows, num_shards, boundary_local, ebase,
                            shard_id, stream);
}

// `status` may be null (no status output); else n zeroed int32 words.
extern "C" int mixed_read_correct_routed(const void* storage,
                                         const void* pages, void* out,
                                         void* status, int n, int W,
                                         int interwrap, int num_rows,
                                         int num_shards, int boundary_local,
                                         int ebase, void* stream) {
  const dim3 grid(n, 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(storage);
  const auto* pg = static_cast<const int32_t*>(pages);
  auto* o = static_cast<int32_t*>(out);
  auto* stat = static_cast<int32_t*>(status);
  if (stat)
    mixed_read_routed_kernel<true, false><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, stat, W, interwrap, num_rows, num_shards, boundary_local,
        ebase, 0);
  else
    mixed_read_routed_kernel<false, false><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, nullptr, W, interwrap, num_rows, num_shards,
        boundary_local, ebase, 0);
  return static_cast<int>(cudaGetLastError());
}

// The shard-local form: `bank` is this rank's (R_local, 9, W) bank,
// `shard_id` its index in the banks mesh; `out` (n, 8W) gets zeros for
// the pages of other banks. `status` may be null; else n zeroed int32
// words, left 0 for those pages.
extern "C" int mixed_read_correct_routed_local(
    const void* bank, const void* pages, void* out, void* status, int n,
    int W, int interwrap, int num_rows, int num_shards, int boundary_local,
    int ebase, int shard_id, void* stream) {
  const dim3 grid(n, 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(bank);
  const auto* pg = static_cast<const int32_t*>(pages);
  auto* o = static_cast<int32_t*>(out);
  auto* stat = static_cast<int32_t*>(status);
  if (stat)
    mixed_read_routed_kernel<true, true><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, stat, W, interwrap, num_rows, num_shards, boundary_local,
        ebase, shard_id);
  else
    mixed_read_routed_kernel<false, true><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, nullptr, W, interwrap, num_rows, num_shards,
        boundary_local, ebase, shard_id);
  return static_cast<int>(cudaGetLastError());
}

// `status` may be null (no status output); else n zeroed int32 words.
extern "C" int mixed_read_correct(const void* storage, const void* pages,
                                  void* out, void* status, int n, int W,
                                  int interwrap, int num_rows, int boundary,
                                  int ebase, void* stream) {
  const dim3 grid(n, 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(storage);
  const auto* pg = static_cast<const int32_t*>(pages);
  auto* o = static_cast<int32_t*>(out);
  auto* stat = static_cast<int32_t*>(status);
  if (stat)
    mixed_read_correct_kernel<true><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, stat, W, interwrap, num_rows, boundary, ebase);
  else
    mixed_read_correct_kernel<false><<<grid, slice_threads(W), 0, s>>>(
        st, pg, o, nullptr, W, interwrap, num_rows, boundary, ebase);
  return static_cast<int>(cudaGetLastError());
}
