// Fused SECDED scrub sweep: decode, correct data and code lane, repack the
// code lane and write the per-beat status, in one pass over pool rows in
// the pool's own (R, 9, W) layout.
//
// Replaces the Pallas TPU kernel repro/kernels/scrub/kernel.py
// `scrub_rows` (:51).
//
// Bound: memory traffic — each row's 9W words are read once and written
// once, plus 4W status ints (one per beat). 8 AND/XOR/POPC per beat is far
// below the card's integer rate for those bytes.
//
// Design: a row's data lanes 0-7 are its first 8W words, contiguous, and
// its code lane (the next W words) holds one packed code word per 8 data
// words. So the sweep is the SECDED decode of secded.cu with the row stride
// of the pool: one thread per packed code word, i.e. per (row, j), loading
// data words 8j..8j+7 of the row as two 16-byte vectors and code word j,
// correcting in registers (decode_beat of secded.cuh), and storing the
// corrected vectors, the corrected code word and the four beat statuses
// (one 16-byte store). Neighbouring threads take neighbouring j, so a warp
// moves 1 KiB of one row's data. The kernel writes a new buffer; the
// caller keeps the input pool valid (the reference's scrub is functional).
#include "secded.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

// n = R * W (packed code words in the rows).
__global__ void scrub_rows_kernel(const int32_t* __restrict__ storage,
                                  int32_t* __restrict__ out,
                                  int4* __restrict__ status, int n, int W) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const int row = t / W, j = t - row * W;
    const size_t base = static_cast<size_t>(row) * 9 * W;
    const uint4* src = reinterpret_cast<const uint4*>(storage + base) + 2 * j;
    uint4* dst = reinterpret_cast<uint4*>(out + base) + 2 * j;
    uint4 a = src[0], b = src[1];
    const uint32_t p = static_cast<uint32_t>(storage[base + 8 * W + j]);
    uint32_t c0 = p & 0xFFu, c1 = (p >> 8) & 0xFFu, c2 = (p >> 16) & 0xFFu,
             c3 = p >> 24;
    int4 s;
    s.x = decode_beat(a.x, a.y, c0);
    s.y = decode_beat(a.z, a.w, c1);
    s.z = decode_beat(b.x, b.y, c2);
    s.w = decode_beat(b.z, b.w, c3);
    dst[0] = a;
    dst[1] = b;
    out[base + 8 * W + j] =
        static_cast<int32_t>(c0 | (c1 << 8) | (c2 << 16) | (c3 << 24));
    status[t] = s;
  }
}

int grid_for(int n) {
  const int blocks = ceil_div(n, kThreads);
  return blocks < 65535 * 8 ? blocks : 65535 * 8;
}

}  // namespace

extern "C" int scrub_rows(const void* storage, void* out, void* status,
                          int n, int W, void* stream) {
  scrub_rows_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(storage), static_cast<int32_t*>(out),
      static_cast<int4*>(status), n, W);
  return static_cast<int>(cudaGetLastError());
}
