// 8-bit-per-line parity encode and check over (N, D) word blocks, the
// detection-only code of the PARITY layout, and the PARITY pool's one-pass
// write.
//
// Replaces the Pallas TPU kernels repro/kernels/parity8/kernel.py `encode`
// (:52) and `check` (:67). `parity8_encode` keeps the TPU kernel's contract
// (a contiguous (N, D/64) output); `parity8_write` is its Hopper redesign
// for the pool, where the encode was one link of a chain of eager launches.
//
// Bound: memory traffic. A 64-byte line (16 words) folds by XOR to one
// byte: about one XOR per byte read. Encode reads D words and writes D/64
// per row; check reads D + D/64 words and writes D/16 status ints; the
// write reads a page's 8W words once and writes them and its W/8 parity
// words once.
//
// Design: the arrays are treated as flat streams (D % 64 == 0, so a line
// and a packed parity word never straddle rows). Neighbouring threads load
// neighbouring 16-byte vectors, so a warp reads 512 contiguous bytes. Four
// threads hold one line; each XORs its four words, and two xor-shuffles
// fold the line to its byte in all four. For encode, each thread shifts
// its line's byte into place and two or-shuffles across the four lines of
// a packed word gather the word in every lane of the 16-lane group, whose
// first lane stores it. For check, the line's first lane compares the byte
// against the stored one and writes the line's status. Loop trips are
// warp-uniform, so every shuffle runs with the full mask; lanes past the
// end load zeros and store nothing (n is a multiple of 16, so a 16-lane
// group is either all in range or all out).
//
// The write (one launch per pool write, in place): a block takes one
// landing page and a chunk of its 2W vectors, kWriteUnroll per thread, all
// loaded before any is stored. Each vector goes to its slice's (row, lane)
// (coords.cuh page_slice: row-wise regular pages, extras in the code-lane
// rows from ebase), and unless the page is SECDED the same registers fold
// into its packed parity, stored straight into the page's slot of the
// code-lane tables (coords.cuh parity_slot). A page's 8W words are a whole
// number of packed words (W % 8 == 0), so a 16-lane group never spans two
// pages; parity goes out as 32-bit words, so any such W works. The ids are
// distinct (the pool lands one row per page first) and pages that share a
// parity row own disjoint slots, so no two blocks write one word and no
// atomics are needed. Ids are not clamped: the pool checks them on the
// host. Offsets into the storage are 64-bit.
#include "coords.cuh"
#include "secded.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kWriteUnroll = 4;   // vectors a thread of the write holds

// XOR of the line (four neighbouring lanes) folded to its byte.
__device__ __forceinline__ uint32_t line_byte(const uint4& v) {
  uint32_t x = v.x ^ v.y ^ v.z ^ v.w;
  x ^= __shfl_xor_sync(0xffffffffu, x, 1);
  x ^= __shfl_xor_sync(0xffffffffu, x, 2);
  x ^= x >> 16;
  x ^= x >> 8;
  return x & 0xFFu;
}

// The packed parity word of the 16-lane group holding vector i (i counts
// 16-byte vectors from a packed word's start), in every lane of the group.
__device__ __forceinline__ uint32_t packed_word(const uint4& v, int i) {
  uint32_t word = line_byte(v) << (8 * ((i >> 2) & 3));
  word |= __shfl_xor_sync(0xffffffffu, word, 4);
  word |= __shfl_xor_sync(0xffffffffu, word, 8);
  return word;
}

// n = number of 16-byte vectors = N * D / 4.
__global__ void parity8_encode_kernel(const uint4* __restrict__ data,
                                      uint32_t* __restrict__ parity, int n) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane; base < n;
       base += stride) {
    const int i = base + lane;
    const bool valid = i < n;
    const uint4 v = valid ? data[i] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t word = packed_word(v, i);
    if (valid && (lane & 15) == 0) parity[i >> 4] = word;
  }
}

__global__ void parity8_check_kernel(const uint4* __restrict__ data,
                                     const uint32_t* __restrict__ parity,
                                     int32_t* __restrict__ status, int n) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane; base < n;
       base += stride) {
    const int i = base + lane;
    const bool valid = i < n;
    const uint4 v = valid ? data[i] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t b = line_byte(v);
    if (valid && (lane & 3) == 0) {
      const uint32_t stored = (parity[i >> 4] >> (8 * ((i >> 2) & 3))) & 0xFFu;
      status[i >> 2] = b != stored;
    }
  }
}

// grid (n pages, chunks of kThreads * kWriteUnroll vectors of a page)
__global__ void __launch_bounds__(kThreads) parity8_write_kernel(
    uint4* __restrict__ storage, const int64_t* __restrict__ pages,
    const uint4* __restrict__ data, int W, int num_rows, int boundary,
    int ebase, int tables) {
  const int page = static_cast<int>(pages[blockIdx.x]);
  const int per_page = 2 * W, per_slice = W / 4;   // 16-byte vectors
  const bool sec = page >= boundary && page < num_rows;
  const uint4* src = data + static_cast<size_t>(blockIdx.x) * per_page;
  const int first = blockIdx.y * (kThreads * kWriteUnroll) + threadIdx.x;
  uint4 v[kWriteUnroll];
#pragma unroll
  for (int j = 0; j < kWriteUnroll; ++j) {
    const int p = first + j * kThreads;
    v[j] = p < per_page ? src[p] : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t* parity = nullptr;
  if (!sec) {
    int prow, off;
    parity_slot(page, num_rows, boundary, tables, W, prow, off);
    parity = reinterpret_cast<uint32_t*>(storage) +
             (static_cast<size_t>(prow) * 9 + 8) * W + off;
  }
#pragma unroll
  for (int j = 0; j < kWriteUnroll; ++j) {
    const int p = first + j * kThreads;
    const bool valid = p < per_page;
    if (valid) {
      const int k = p / per_slice;
      int row, lane;
      bool is_sec;
      page_slice(page, k, 0, num_rows, boundary, ebase, row, lane, is_sec);
      storage[(static_cast<size_t>(row) * 9 + lane) * per_slice +
              (p - k * per_slice)] = v[j];
    }
    const uint32_t word = packed_word(v[j], p);
    if (!sec && valid && (threadIdx.x & 15) == 0) parity[p >> 4] = word;
  }
}

int grid_for(int n) {
  const int blocks = ceil_div(n, kThreads);
  return blocks < 65535 * 8 ? blocks : 65535 * 8;
}

}  // namespace

extern "C" int parity8_encode(const void* data, void* parity, int n,
                              void* stream) {
  parity8_encode_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint32_t*>(parity), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int parity8_check(const void* data, const void* parity,
                             void* status, int n, void* stream) {
  parity8_check_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<const uint32_t*>(parity),
      static_cast<int32_t*>(status), n);
  return static_cast<int>(cudaGetLastError());
}

// Lands n pages (distinct int64 ids) of W words per slice into the
// (R, 9, W) storage in place, with the packed parity of the CREAM and
// extra pages.
extern "C" int parity8_write(void* storage, const void* pages,
                             const void* data, int n, int W, int num_rows,
                             int boundary, int ebase, int tables,
                             void* stream) {
  const dim3 grid(n, ceil_div(2 * W, kThreads * kWriteUnroll));
  parity8_write_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(storage), static_cast<const int64_t*>(pages),
      static_cast<const uint4*>(data), W, num_rows, boundary, ebase, tables);
  return static_cast<int>(cudaGetLastError());
}
