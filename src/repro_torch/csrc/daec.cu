// SEC-DAEC(144,128) encode and decode-correct over (N, D) word blocks.
//
// Replaces the Pallas TPU kernels repro/kernels/daec/kernel.py `encode`
// (:130) and `decode` (:145).
//
// The code: a 128-bit superbeat (4 words) splits by bit parity into two
// Hsiao(72,64) codewords, A of the even bits and B of the odd bits, so an
// adjacent double-bit error is one single error in each and both are
// corrected. The two 8-bit check bytes interleave into one 16-bit field
// (bit 2i of A, bit 2i+1 of B), two fields per 32-bit code word: the code
// plane has the SECDED shape (N, D/8), and one packed code word still
// covers 8 data words — here two superbeats.
//
// Bound: integer operations. Each superbeat costs two Hsiao passes plus
// the Morton de- and re-interleave (shift/or/and rounds): a few hundred
// integer instructions per 8 words, which move only 36 bytes for encode
// (88 for decode). chip_smoke.py counts the ALU-pipe instructions in the
// SASS of the build for the bound; the compiler fuses the and/or/xor
// chains into LOP3 and issues some shifts as IMAD on the FMA pipe.
//
// Design: the geometry of secded.cu — one thread per packed code word,
// i.e. per 8 data words (two superbeats), read as two 16-byte vectors
// (one per superbeat) so a warp touches 1 KiB of consecutive memory; the
// code word is one 4-byte load/store and the 4 beat statuses one 16-byte
// store. The Morton shuffles stay in registers, and the Hsiao passes reuse
// encode_beat / decode_beat of secded.cuh (constant-memory masks and the
// syndrome -> action table, read only for a nonzero syndrome) in place of
// the TPU's select tree.
#include "secded.cuh"

using namespace repro_torch;

namespace {

// Even bits of x -> low 16 bits.
__device__ __forceinline__ uint32_t compact_even(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

// Low 16 bits of x -> even bit positions.
__device__ __forceinline__ uint32_t spread_even(uint32_t x) {
  x &= 0x0000FFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// One superbeat -> its two Hsiao codewords: A of the even bits, B of the
// odd bits, each as a (lo, hi) beat.
struct Split {
  uint32_t a_lo, a_hi, b_lo, b_hi;
};

__device__ __forceinline__ Split deinterleave(const uint4& w) {
  Split s;
  s.a_lo = compact_even(w.x) | (compact_even(w.y) << 16);
  s.a_hi = compact_even(w.z) | (compact_even(w.w) << 16);
  s.b_lo = compact_even(w.x >> 1) | (compact_even(w.y >> 1) << 16);
  s.b_hi = compact_even(w.z >> 1) | (compact_even(w.w >> 1) << 16);
  return s;
}

__device__ __forceinline__ uint4 interleave(const Split& s) {
  uint4 w;
  w.x = spread_even(s.a_lo) | (spread_even(s.b_lo) << 1);
  w.y = spread_even(s.a_lo >> 16) | (spread_even(s.b_lo >> 16) << 1);
  w.z = spread_even(s.a_hi) | (spread_even(s.b_hi) << 1);
  w.w = spread_even(s.a_hi >> 16) | (spread_even(s.b_hi >> 16) << 1);
  return w;
}

// Two 8-bit check bytes -> one 16-bit field.
__device__ __forceinline__ uint32_t make_field(uint32_t code_a,
                                               uint32_t code_b) {
  return spread_even(code_a) | (spread_even(code_b) << 1);
}

__device__ __forceinline__ uint32_t encode_superbeat(const uint4& w) {
  const Split s = deinterleave(w);
  return make_field(encode_beat(s.a_lo, s.a_hi), encode_beat(s.b_lo, s.b_hi));
}

// Check and correct one superbeat in place against its 16-bit field;
// returns the worse of the two codewords' statuses (0..3).
__device__ __forceinline__ int decode_superbeat(uint4& w, uint32_t& field) {
  Split s = deinterleave(w);
  uint32_t code_a = compact_even(field), code_b = compact_even(field >> 1);
  const int st_a = decode_beat(s.a_lo, s.a_hi, code_a);
  const int st_b = decode_beat(s.b_lo, s.b_hi, code_b);
  w = interleave(s);
  field = make_field(code_a, code_b);
  return st_a > st_b ? st_a : st_b;
}

__global__ void daec_encode_kernel(const uint4* __restrict__ data,
                                   uint32_t* __restrict__ codes, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint4 a = data[2 * i], b = data[2 * i + 1];
    codes[i] = encode_superbeat(a) | (encode_superbeat(b) << 16);
  }
}

__global__ void daec_decode_kernel(const uint4* __restrict__ data,
                                   const uint32_t* __restrict__ codes,
                                   uint4* __restrict__ out,
                                   uint32_t* __restrict__ out_codes,
                                   int4* __restrict__ status, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint4 a = data[2 * i], b = data[2 * i + 1];
    const uint32_t p = codes[i];
    uint32_t fa = p & 0xFFFFu, fb = p >> 16;
    const int sa = decode_superbeat(a, fa);
    const int sb = decode_superbeat(b, fb);
    out[2 * i] = a;
    out[2 * i + 1] = b;
    out_codes[i] = fa | (fb << 16);
    status[i] = make_int4(sa, sa, sb, sb);   // each verdict on both beats
  }
}

constexpr int kThreads = 256;

int grid_for(int n) {
  const int blocks = ceil_div(n, kThreads);
  return blocks < 65535 * 8 ? blocks : 65535 * 8;
}

}  // namespace

// n = number of packed code words = N * D / 8.
extern "C" int daec_encode(const void* data, void* codes, int n,
                           void* stream) {
  daec_encode_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint32_t*>(codes), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int daec_decode(const void* data, const void* codes,
                           void* out_data, void* out_codes, void* status,
                           int n, void* stream) {
  daec_decode_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<const uint32_t*>(codes),
      static_cast<uint4*>(out_data), static_cast<uint32_t*>(out_codes),
      static_cast<int4*>(status), n);
  return static_cast<int>(cudaGetLastError());
}
