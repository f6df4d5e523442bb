// 8-bit-per-line parity encode and check over (N, D) word blocks, the
// detection-only code of the PARITY layout.
//
// Replaces the Pallas TPU kernels repro/kernels/parity8/kernel.py `encode`
// (:52) and `check` (:67).
//
// Bound: memory traffic. A 64-byte line (16 words) folds by XOR to one
// byte: about one XOR per byte read. Encode reads D words and writes D/64
// per row; check reads D + D/64 words and writes D/16 status ints.
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
#include "secded.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

// XOR of the line (four neighbouring lanes) folded to its byte.
__device__ __forceinline__ uint32_t line_byte(const uint4& v) {
  uint32_t x = v.x ^ v.y ^ v.z ^ v.w;
  x ^= __shfl_xor_sync(0xffffffffu, x, 1);
  x ^= __shfl_xor_sync(0xffffffffu, x, 2);
  x ^= x >> 16;
  x ^= x >> 8;
  return x & 0xFFu;
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
    uint32_t word = line_byte(v) << (8 * ((i >> 2) & 3));
    word |= __shfl_xor_sync(0xffffffffu, word, 4);
    word |= __shfl_xor_sync(0xffffffffu, word, 8);
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
