// SECDED decode-on-load matrix product: A arrives as Hsiao(72,64)-protected
// bf16 words, is corrected as it is loaded and multiplied with B in the
// same kernel, so a protected weight matrix is read from device memory
// once (plus its 12.5 % of code bytes) and never decoded to a copy.
//
// Replaces the Pallas TPU kernel repro/kernels/ecc_matmul/kernel.py
// `ecc_matmul` (:61), which decoded an (i, k) tile on the VPU and fed it
// to the MXU, accumulating into the revisited output block over a
// sequential K grid.
//
// Inputs: A bits (M, K/2) words (bf16 element 2j in the low half of word
// j), A codes (M, K/16) words (four 8-bit check bytes a word, low byte
// first: one code word per 8 data words, the pool's packing), B (K, N)
// bf16, row-major. Output (M, N) float32. K % 16 == 0; any M and N.
//
// Bound: at the qwen3-0.6b MLP shapes the products are bound by
// operations (2MNK flops; bytes are A's 2.25 bytes an element, B and the
// float32 output). This first version multiplies in float32 on the SIMT
// pipes, not on the tensor cores: exact bf16 x bf16 products summed in
// float32. A tensor-core (mma.sync / wgmma) version is later work.
//
// Design: one block of 256 threads per 64 x 64 output tile, K walked in
// steps of 16 (one packed code word of each A row). Per step, 64 threads
// each load one A row's 8 words (two 16-byte loads) and its code word,
// correct the four beats in registers with secded.cuh's correct_group,
// and widen the 16 bf16 values to float32 in shared memory (k-major);
// all 256 threads widen a 16 x 64 tile of B. Blocks run in any order and
// the K loop lives inside the block, so the float32 sums stay in
// registers: each thread owns a 4 x 4 output block and reads float4s of
// both tiles. Single data-bit errors are corrected; code-bit and
// uncorrectable beats pass through, as in the TPU kernel.
#include "secded.cuh"

using namespace repro_torch;

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kThreads)
ecc_matmul_kernel(const uint4* __restrict__ bits,
                  const uint32_t* __restrict__ codes,
                  const uint16_t* __restrict__ b, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ __align__(16) float a_tile[kBK][kBM + 4];
  __shared__ __align__(16) float b_tile[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int groups = K / kBK;          // code words per A row
  float acc[4][4] = {};
  for (int g = 0; g < groups; ++g) {
    if (threadIdx.x < kBM) {
      const int r = m0 + threadIdx.x;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (r < M) {
        const size_t at = static_cast<size_t>(r) * groups + g;
        lo = bits[2 * at];
        hi = bits[2 * at + 1];
        correct_group(lo, hi, codes[at]);
      }
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a_tile[2 * j][threadIdx.x] = bf16_lo(w[j]);
        a_tile[2 * j + 1][threadIdx.x] = bf16_hi(w[j]);
      }
    }
    {
      const int k = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
      const uint16_t* row = b + static_cast<size_t>(g * kBK + k) * N;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = n0 + c + q;
        b_tile[k][c + q] =
            col < N ? __uint_as_float(uint32_t(row[col]) << 16) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_tile[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_tile[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[static_cast<size_t>(r) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int ecc_matmul(const void* bits, const void* codes, const void* b,
                          void* out, int M, int N, int K, void* stream) {
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, kBM));
  ecc_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bits), static_cast<const uint32_t*>(codes),
      static_cast<const uint16_t*>(b), static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
