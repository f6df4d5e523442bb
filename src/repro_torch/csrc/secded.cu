// SECDED(72,64) encode and decode-correct over (N, D) word blocks.
//
// Replaces the Pallas TPU kernels repro/kernels/secded/kernel.py `encode`
// (:127) and `decode` (:142).
//
// Bound: memory traffic. Encode reads 32 bytes and writes 4 per 4 beats;
// decode reads 36 and writes 52 (data, codes, 4 status ints). The
// arithmetic is 8 AND/XOR/POPC per beat, well under the card's integer
// rate for those bytes.
//
// Design: one thread per packed code word, i.e. per 8 data words (4 beats,
// 32 bytes), read as two 16-byte vector loads so a warp touches 1 KiB of
// consecutive memory; codes are one 4-byte load/store, statuses one
// 16-byte store. Everything stays in registers; the syndrome table is in
// constant memory and is read only for beats with a nonzero syndrome. The
// TPU kernel's (BLOCK_ROWS, D) VMEM tiles have no counterpart: blocks of
// 256 threads stream the flat arrays.
#include "secded.cuh"

using namespace repro_torch;

namespace {

__global__ void secded_encode_kernel(const uint4* __restrict__ data,
                                     uint32_t* __restrict__ codes, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint4 a = data[2 * i], b = data[2 * i + 1];
    codes[i] = encode_group(a, b);
  }
}

__global__ void secded_decode_kernel(const uint4* __restrict__ data,
                                     const uint32_t* __restrict__ codes,
                                     uint4* __restrict__ out,
                                     uint32_t* __restrict__ out_codes,
                                     int4* __restrict__ status, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint4 a = data[2 * i], b = data[2 * i + 1];
    const uint32_t p = codes[i];
    uint32_t c0 = p & 0xFFu, c1 = (p >> 8) & 0xFFu, c2 = (p >> 16) & 0xFFu,
             c3 = p >> 24;
    int4 s;
    s.x = decode_beat(a.x, a.y, c0);
    s.y = decode_beat(a.z, a.w, c1);
    s.z = decode_beat(b.x, b.y, c2);
    s.w = decode_beat(b.z, b.w, c3);
    out[2 * i] = a;
    out[2 * i + 1] = b;
    out_codes[i] = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
    status[i] = s;
  }
}

constexpr int kThreads = 256;

int grid_for(int n) {
  const int blocks = ceil_div(n, kThreads);
  return blocks < 65535 * 8 ? blocks : 65535 * 8;
}

}  // namespace

// n = number of packed code words = N * D / 8.
extern "C" int secded_encode(const void* data, void* codes, int n,
                             void* stream) {
  secded_encode_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint32_t*>(codes), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int secded_decode(const void* data, const void* codes,
                             void* out_data, void* out_codes, void* status,
                             int n, void* stream) {
  secded_decode_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<const uint32_t*>(codes),
      static_cast<uint4*>(out_data), static_cast<uint32_t*>(out_codes),
      static_cast<int4*>(status), n);
  return static_cast<int>(cudaGetLastError());
}
