// Fused object-cache get: bounded linear probe of the hash index, mixed-
// pool page gather, and in-register SECDED correction of protected pages,
// in one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/hash/kernel.py
// `lookup_read` (:76), whose scalar-prefetched BlockSpec index map ran the
// probe of repro/objcache/hash_index.py and fed the matched page to the
// mixed read's page_coords translation.
//
// Bound: memory traffic — per query the page's 8W words read once and
// written once, plus W/8 packed code words per slice of a SECDED page and
// the probe window's keys (a few cache lines). There is no reuse.
//
// Design: mixed.cu's (query, slice) grid. The block's first warp probes:
// lane r loads slot (h + r) % C of the window, __ballot_sync collects the
// matches and __ffs takes the first, so a key resolves to the slot the
// reference's argmax picks; windows longer than 32 slots are walked in
// chunks of 32 (the loop is warp-uniform and stops at the first chunk with
// a match). Lane 0 puts the slot's page (page 0 when the key is absent, as
// in the reference) in shared memory; after a barrier the whole block runs
// the mixed read's copy loop on it: page_slice (coords.cuh), two 16-byte
// loads and stores per 8 words, correct_group for SECDED pages. The hash is
// uint32 arithmetic, which wraps on the card as the reference's does.
#include "coords.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

// repro/objcache/hash_index.py hash_u32: Knuth multiply, xor-shift.
__device__ __forceinline__ uint32_t hash_u32(uint32_t k) {
  k *= 2654435761u;
  return k ^ (k >> 16);
}

__global__ void hash_lookup_read_kernel(
    const int32_t* __restrict__ storage, const uint32_t* __restrict__ keys,
    const int32_t* __restrict__ slot_pages,
    const uint32_t* __restrict__ queries, int32_t* __restrict__ out, int W,
    int capacity, int probe, int interwrap, int num_rows, int boundary,
    int ebase) {
  __shared__ int s_page;
  const int i = blockIdx.x, k = blockIdx.y;
  if (threadIdx.x < 32) {
    const uint32_t q = queries[i];
    const uint32_t cap = static_cast<uint32_t>(capacity);
    const uint32_t h = hash_u32(q) % cap;
    int slot = -1;
    for (int base = 0; base < probe; base += 32) {
      const int r = base + static_cast<int>(threadIdx.x);
      const bool hit = r < probe && keys[(h + r) % cap] == q;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        slot = static_cast<int>((h + base + __ffs(m) - 1) % cap);
        break;
      }
    }
    if (threadIdx.x == 0) s_page = slot >= 0 ? slot_pages[slot] : 0;
  }
  __syncthreads();
  const int page = s_page;
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

}  // namespace

extern "C" int hash_lookup_read(const void* storage, const void* keys,
                                const void* slot_pages, const void* queries,
                                void* out, int n, int W, int capacity,
                                int probe, int interwrap, int num_rows,
                                int boundary, int ebase, void* stream) {
  const dim3 grid(n, 8);
  hash_lookup_read_kernel<<<grid, slice_threads(W), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage),
      static_cast<const uint32_t*>(keys),
      static_cast<const int32_t*>(slot_pages),
      static_cast<const uint32_t*>(queries), static_cast<int32_t*>(out), W,
      capacity, probe, interwrap, num_rows, boundary, ebase);
  return static_cast<int>(cudaGetLastError());
}
