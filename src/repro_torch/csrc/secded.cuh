// Hsiao SECDED(72,64) device code shared by every kernel of the port.
//
// A beat is 64 data bits carried as two consecutive 32-bit words (lo, hi);
// its 8-bit check byte is the parity of the data bits each H-matrix row
// selects. Check bytes pack 4 per 32-bit word, low byte first, so one
// packed code word covers 8 data words (two 16-byte vectors): that group of
// 8 words is the unit every kernel here hands to one thread.
//
// The tables below are the same Hsiao H-matrix that
// repro_torch.core.secded builds in numpy (a CPU test parses this file and
// holds it equal to the reference's _MASK_LO / _MASK_HI / _SYNDROME_TABLE).
// The TPU kernel matched syndromes with a 72-way compare/select chain
// because per-element gathers do not vectorise on its VPU; on the GPU the
// 256-entry syndrome -> action table sits in constant memory, and the
// common case (syndrome 0) never reads it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

// Parity bit p covers the data bits set in kMaskLo[p] (bits 0..31) and
// kMaskHi[p] (bits 32..63).
static __constant__ uint32_t kMaskLo[8] = {
    0x001FFFFFu, 0xFFE0003Fu, 0x03E007C1u, 0x3C207842u,
    0xC4438884u, 0x488C9108u, 0x91152210u, 0x221A4420u};
static __constant__ uint32_t kMaskHi[8] = {
    0xFF000000u, 0xFF00000Fu, 0xFF003FF0u, 0x0F0FC0F0u,
    0x7171C711u, 0x92B65926u, 0xA4DAAA4Au, 0x48ED348Du};

// Syndrome -> action: -1 clean, 0..63 flip that data bit, 64..71 flip code
// bit (value - 64), -2 detected uncorrectable.
static __constant__ signed char kAction[256] = {
    -1,  64,  65,  -2,  66,  -2,  -2,   0,  67,  -2,  -2,   1,  -2,   6,  21,  -2,
    68,  -2,  -2,   2,  -2,   7,  22,  -2,  -2,  11,  26,  -2,  36,  -2,  -2,  56,
    69,  -2,  -2,   3,  -2,   8,  23,  -2,  -2,  12,  27,  -2,  37,  -2,  -2,  57,
    -2,  15,  30,  -2,  40,  -2,  -2,  60,  46,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    70,  -2,  -2,   4,  -2,   9,  24,  -2,  -2,  13,  28,  -2,  38,  -2,  -2,  58,
    -2,  16,  31,  -2,  41,  -2,  -2,  61,  47,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    -2,  18,  33,  -2,  43,  -2,  -2,  63,  49,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    52,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    71,  -2,  -2,   5,  -2,  10,  25,  -2,  -2,  14,  29,  -2,  39,  -2,  -2,  59,
    -2,  17,  32,  -2,  42,  -2,  -2,  62,  48,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    -2,  19,  34,  -2,  44,  -2,  -2,  -2,  50,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    53,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    -2,  20,  35,  -2,  45,  -2,  -2,  -2,  51,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    54,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    55,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
    -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,  -2,
};

// Check byte of one beat. popc(lo & m) + popc(hi & m') has the parity of
// popc((lo & m) ^ (hi & m')), so each check bit costs one __popc.
__device__ __forceinline__ uint32_t encode_beat(uint32_t lo, uint32_t hi) {
  uint32_t code = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p)
    code |= (uint32_t(__popc((lo & kMaskLo[p]) ^ (hi & kMaskHi[p]))) & 1u)
            << p;
  return code;
}

// Packed code word of 8 data words (4 beats), low byte = first beat.
__device__ __forceinline__ uint32_t encode_group(const uint4& a,
                                                 const uint4& b) {
  return encode_beat(a.x, a.y) | (encode_beat(a.z, a.w) << 8) |
         (encode_beat(b.x, b.y) << 16) | (encode_beat(b.z, b.w) << 24);
}

// Check and correct one beat in place against its check byte `code`
// (0..255); returns the status 0 clean, 1 data fixed, 2 code fixed,
// 3 detected uncorrectable.
__device__ __forceinline__ int decode_beat(uint32_t& lo, uint32_t& hi,
                                           uint32_t& code) {
  const uint32_t syn = (encode_beat(lo, hi) ^ code) & 0xFFu;
  if (syn == 0) return 0;
  const int a = kAction[syn];
  if (a >= 64) {
    code ^= 1u << (a - 64);
    return 2;
  }
  if (a >= 0) {
    if (a < 32)
      lo ^= 1u << a;
    else
      hi ^= 1u << (a - 32);
    return 1;
  }
  return 3;
}

// Data-only correction of 8 words against their packed code word: single
// data-bit errors are fixed, code-bit and uncorrectable beats pass through.
// This is the in-gather variant (the TPU's decode_correct_block). Returns
// the worst of the four beats' statuses (decode_beat's 0..3); callers that
// do not report a status ignore it and the compiler drops the max.
__device__ __forceinline__ int correct_group(uint4& a, uint4& b,
                                             uint32_t packed) {
  uint32_t c0 = packed & 0xFFu, c1 = (packed >> 8) & 0xFFu,
           c2 = (packed >> 16) & 0xFFu, c3 = packed >> 24;
  const int s0 = decode_beat(a.x, a.y, c0);
  const int s1 = decode_beat(a.z, a.w, c1);
  const int s2 = decode_beat(b.x, b.y, c2);
  const int s3 = decode_beat(b.z, b.w, c3);
  return max(max(s0, s1), max(s2, s3));
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Threads per block for the per-slice kernels: one thread per packed code
// word of a W-word slice (W / 8), in whole warps, at most 256.
__host__ __forceinline__ int slice_threads(int W) {
  const int t = ceil_div(W / 8, 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace repro_torch
