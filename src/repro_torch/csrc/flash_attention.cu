// Causal (or full) grouped-query attention with an online softmax, in
// float32 on the SIMT cores, for float32 and bfloat16 operands.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// `attention` (:67). That kernel walks a sequential grid whose minor axis
// is the KV tile, carrying the running max, denominator and accumulator in
// VMEM scratch from one grid step to the next, and it needs a block that
// divides S. Blocks on the GPU run in no order, so here one block owns one
// (batch, query head, query tile) and loops over the KV tiles itself, with
// the running statistics in registers; any S works, the ragged last tile
// masked.
//
// Bound: operations — 4·S²·D/2 flops per (batch, head) when causal, on
// 2·S·D·(Hq + 2·Hkv) values read once and S·D·Hq written once: at the
// long-context prefill shape (S = 8192, D = 128) the flops take ~60 times
// as long as the bytes at the float32 FMA rate. The model runs with TF32
// off, so this version stays in float32 FMA (a tensor-core version with
// wgmma and TMA is later work).
//
// Design: 128 threads as 8 row groups (ty) x 16 column groups (tx). The
// block keeps its 64 x D query tile in shared memory (rows padded by 4
// floats so that the 16-byte reads of 8 neighbouring rows hit distinct
// banks) and streams the key and then the value tile of head
// h / (Hq / Hkv) through one shared buffer. Each thread computes an 8 x 4
// block of scores (rows ty + 8r, columns tx + 16c) from 16-byte shared
// reads, 8 FMAs per float read; the row max and the exponentials are taken
// in base 2 on scores pre-scaled by scale·log2(e), the max reduced over the
// row's 16 threads by shuffles. The probabilities go to a shared 64 x 64
// tile, and each thread accumulates an 8 x D/16 block of the output in
// registers. KV tiles wholly above the diagonal are never visited; only
// the diagonal tile and a ragged last tile are masked. The query tiles are
// walked from the last, so the longest causal rows start first.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // key rows per tile
constexpr int THREADS = 128;        // 8 row groups x 16 column groups
constexpr int RPT = BQ / 8;         // score / output rows per thread
constexpr int CPT = BK / 16;        // score columns per thread
constexpr int PSTRIDE = BK + 16;    // shared P row: the two half-warps'
                                    // rows land 16 banks apart

template <int D>
struct Geo {
  static constexpr int STRIDE = D + 4;        // shared Q / KV row (floats)
  static constexpr int VW = D >= 64 ? 4 : 2;  // output columns per vector
  static constexpr int NC = D / 16;           // output columns per thread
  static constexpr int NV = NC / VW;          // vectors per thread
  static constexpr int SMEM =
      (BQ * STRIDE + BK * STRIDE + BQ * PSTRIDE) * 4;
  // output column of a thread's n-th value: vectors of VW, 16·VW apart
  static __device__ __forceinline__ int col(int tx, int n) {
    return VW * tx + 16 * VW * (n / VW) + n % VW;
  }
};

__device__ __forceinline__ void unpack(uint4 raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(uint4 raw, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {          // element 2j is the low half
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// Rows [0, valid) of the (64, D) tile at g into shared floats; zeros below.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int valid,
                                          float* s) {
  constexpr int E = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int CPR = D / E;            // chunks per row
  for (int c = threadIdx.x; c < BQ * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * E;
    float v[E];
    if (r < valid) {
      unpack(*reinterpret_cast<const uint4*>(g + static_cast<size_t>(r) * D
                                             + col), v, T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(s + r * Geo<D>::STRIDE + col + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Hq, int Hkv, float scale_log2, int causal) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + BQ * G::STRIDE;
  float* sP = sKV + BK * G::STRIDE;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = ((static_cast<size_t>(b) * Hq + h) * S + q0) * D;
  const size_t kvoff = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(q + qoff, min(BQ, S - q0), sQ);

  float acc[RPT][G::NC], m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < G::NC; ++n) acc[r][n] = 0.f;
  }

  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                 // the last tile's P·V is done
    load_tile<T, D>(k + kvoff + static_cast<size_t>(k0) * D,
                    min(BK, S - k0), sKV);
    __syncthreads();

    // S = Q Kᵀ: an 8 x 4 block of rows ty + 8r and columns tx + 16c
    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            sKV + (tx + 16 * c) * G::STRIDE + d);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            sQ + (ty + 8 * r) * G::STRIDE + d);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float x = s[r][c] * scale_log2;
        if (masked) {
          const int row = q0 + ty + 8 * r, col = k0 + tx + 16 * c;
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[r][c] = x;
      }
    __syncthreads();                 // every read of the K tile is done
    load_tile<T, D>(v + kvoff + static_cast<size_t>(k0) * D,
                    min(BK, S - k0), sKV);

    // online softmax: row max over the row's 16 threads, rescale, P
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int c = 1; c < CPT; ++c) mx = fmaxf(mx, s[r][c]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - mu);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = exp2f(s[r][c] - mu);
        sP[(ty + 8 * r) * PSTRIDE + tx + 16 * c] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + sum;     // this thread's columns; summed at end
#pragma unroll
      for (int n = 0; n < G::NC; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();                 // P and the V tile are in place

    // O += P V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        p[r] = *reinterpret_cast<const float4*>(
            sP + (ty + 8 * r) * PSTRIDE + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[G::NC];
        const float* vrow = sKV + (kk + e) * G::STRIDE;
#pragma unroll
        for (int a = 0; a < G::NV; ++a) {
          const float* src = vrow + G::VW * tx + 16 * G::VW * a;
          if constexpr (G::VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[4 * a] = t.x;
            vv[4 * a + 1] = t.y;
            vv[4 * a + 2] = t.z;
            vv[4 * a + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[2 * a] = t.x;
            vv[2 * a + 1] = t.y;
          }
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float pe = e == 0 ? p[r].x : e == 1 ? p[r].y
                         : e == 2 ? p[r].z : p[r].w;
#pragma unroll
          for (int n = 0; n < G::NC; ++n)
            acc[r][n] = fmaf(pe, vv[n], acc[r][n]);
        }
      }
    }
  }

  // the denominator: this thread's share, summed over the row's 16 threads
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float lt = l[r];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xFFFFFFFFu, lt, o);
    const int row = q0 + ty + 8 * r;
    if (row < S) {
      const float inv = 1.f / lt;
      T* dst = out + qoff + static_cast<size_t>(ty + 8 * r) * D;
#pragma unroll
      for (int n = 0; n < G::NC; ++n)
        store(acc[r][n] * inv, dst + G::col(tx, n));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, float scale_log2, int causal,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, Geo<D>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int S, float scale_log2, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, S, scale_log2, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, S, scale_log2, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, S, scale_log2, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, S, D), k / v (B, Hkv, S, D), out like q; bf16 selects
// __nv_bfloat16 operands over float; scale_log2 = scale · log2(e).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int S,
                               int D, int bf16, float scale_log2, int causal,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, S,
                                        scale_log2, causal, s)
              : dispatch<float>(D, q, k, v, out, B, Hq, Hkv, S, scale_log2,
                                causal, s);
}
