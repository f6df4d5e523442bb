// One decode step's attention over a paged K/V view: each slot's query
// heads against its live keys, the new token's K/V read from k_new / v_new
// instead of the pool, in float32 on the SIMT cores.
//
// Replaces no Pallas kernel: the reference computes this step in einsum
// (repro/models/attention.py apply_attn_decode_paged), which on the card
// ran as a chain of elementwise passes over the whole padded (B, S_pad,
// Hkv, D) view (two inserts of the new K/V, the masking of V, the
// products' layout copies) before the two products read it once more.
// This kernel reads only positions [0, cache_len) of the pool, once.
//
// Bound: bytes — the live K and V rows (2·D floats per (slot, KV head,
// key)), q and the new K/V read once, the output written once, over
// 3.35 TB/s. The step does 4·D flops per (query head, key) against 8·D
// bytes per (KV head, key): under 1 flop a byte at one query head per KV
// head and ~5 at nine, far below the float32 FMA rate's ~20.
//
// Design, for that bound: one block per (slot, KV head, chunk of keys)
// computes all g = Hq/Hkv query heads against each K row, so K and V leave
// device memory once per KV head. A K row of D floats is D/4 lanes, each
// holding one 16-byte vector (neighbouring lanes on neighbouring
// addresses); a warp holds 32/(D/4) rows at once. Each such lane group is
// a stream with its own online softmax over keys of the chunk: per step
// it loads U rows of K and U of V into registers (enough bytes in flight
// per SM that the card's memory, not latency, limits), and for each query
// head forms the U partial dots, reduces them over the group's lanes with
// shuffles, and folds them into its running max, denominator and
// accumulator. Those are per head and g is a run-time value, so they live
// in shared memory, each lane's own copy: no lane reads another's, and the
// streams need no synchronisation until the chunk is done. Then the
// block's streams are merged in a fixed order. A block takes at most
// GMAX query heads, which bounds its shared memory; a larger g (48 on one
// KV head in multi-query models) puts groups of GMAX heads on the grid's
// third dimension, each group reading the chunk's K/V again. A key past
// the slot's length is never loaded: pool bits there may decode as NaN or
// Inf. The key at cache_len comes from k_new / v_new; a slot whose
// cache_len has reached S_pad attends to all S_pad pool positions,
// inserting nothing.
//
// Split-KV as in flash-decoding: the wrapper cuts S_pad into chunks so
// that B·Hkv·S_pad keys fill the SMs many times over; blocks whose chunk
// starts past the slot's length return at once. With one chunk the block
// writes the normalised output; with more, each block writes its chunk's
// (max, denominator, accumulator) and a combine pass merges a slot's live
// chunks in chunk order — deterministic, no float atomics.
//
// K / V are read through (B, n_blk, bt, Hkv, D) views: batch, block and
// token strides are arguments, Hkv·D contiguous, so a pool's pages can be
// read in place; a contiguous (B, S_pad, Hkv, D) tensor is one block of
// S_pad tokens.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;               // warps per block
constexpr int THREADS = 32 * NW;
constexpr int U = 4;                // K and V rows a stream holds per step
constexpr int GMAX = 16;            // query heads a block takes at most
constexpr unsigned FULL = 0xFFFFFFFFu;

template <int D>
struct Geo {
  static constexpr int LPR = D / 4;         // lanes per row, a vector each
  static constexpr int RPW = 32 / LPR;      // rows a warp holds at once
  static constexpr int STREAMS = NW * RPW;  // lane groups per block
  static constexpr int TILE = STREAMS * U;  // keys a block takes per step
  // shared floats per query head: q, and each stream's accumulator,
  // running max and denominator (one copy per lane)
  static constexpr int SMEM_PER_HEAD = D + STREAMS * D + 2 * 32 * NW;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ void fma4(float p, float4 v, float4& a) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// Keys a slot attends to: [0, cache_len] with the new token at cache_len,
// or all S pool positions once cache_len has reached S.
__device__ __forceinline__ int live_keys(int len, int S) {
  return len < S ? len + 1 : S;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_new,
                    const float* __restrict__ v_new,
                    const int* __restrict__ cache_len,
                    const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int Hkv, int g, int S, int bt,
                    long long sb, long long sn, long long st, int chunk,
                    int n_chunks, float scale_log2) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  // this block's query heads: gb of KV head h's g, from h·g + h0
  const int h0 = blockIdx.z * GMAX, gb = min(GMAX, g - h0);
  float* sq = reinterpret_cast<float*>(smem4);       // (gb, D), scaled
  float* sacc = sq + gb * D;                          // (STREAMS, gb, D)
  float* sm = sacc + G::STREAMS * gb * D;             // (NW, gb, 32)
  float* sl = sm + NW * gb * 32;                      // (NW, gb, 32)

  const int h = blockIdx.x % Hkv, b = blockIdx.x / Hkv, c = blockIdx.y;
  const int Hq = Hkv * g, hq0 = h * g + h0;
  const int len = cache_len[b];
  const int n_keys = live_keys(len, S);
  const int k0 = c * chunk;
  const int k1 = min(k0 + chunk, n_keys);
  const int tid = threadIdx.x;
  float* dst = out + (static_cast<size_t>(b) * Hq + hq0) * D;
  if (k0 >= n_keys) {
    // a negative cache_len leaves nothing to attend to: NaN, as the
    // softmax over no position gives
    if (n_keys <= 0 && n_chunks == 1)
      for (int i = tid; i < gb * D; i += THREADS) dst[i] = NAN;
    return;
  }

  const float* qb = q + (static_cast<size_t>(b) * Hq + hq0) * D;
  for (int i = tid; i < gb * D; i += THREADS) sq[i] = qb[i] * scale_log2;
  for (int i = tid; i < G::STREAMS * gb * D; i += THREADS) sacc[i] = 0.f;
  for (int i = tid; i < NW * gb * 32; i += THREADS) {
    sm[i] = -INFINITY;
    sl[i] = 0.f;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int lir = lane % G::LPR;                      // vector within row
  const int stream = warp * G::RPW + lane / G::LPR;
  const size_t head_off = static_cast<size_t>(h) * D + 4 * lir;
  const float* kn = k_new + (static_cast<size_t>(b) * Hkv) * D + head_off;
  const float* vn = v_new + (static_cast<size_t>(b) * Hkv) * D + head_off;
  const float* kb = k + b * sb + head_off;
  const float* vb = v + b * sb + head_off;

  for (int t0 = k0; t0 < k1; t0 += G::TILE) {
    float4 kr[U], vr[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = t0 + stream + G::STREAMS * u;
      live[u] = s < k1;
      kr[u] = vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[u]) {
        const float *kp = kn, *vp = vn;
        if (s != len) {
          const int blk = s / bt;
          const long long off = blk * sn + (s - blk * bt) * st;
          kp = kb + off;
          vp = vb + off;
        }
        kr[u] = __ldg(reinterpret_cast<const float4*>(kp));
        vr[u] = __ldg(reinterpret_cast<const float4*>(vp));
      }
    }
    for (int hh = 0; hh < gb; ++hh) {
      const float4 qv = *reinterpret_cast<const float4*>(sq + hh * D
                                                         + 4 * lir);
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) sc[u] = dot4(qv, kr[u]);
#pragma unroll
      for (int o = G::LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[u] += __shfl_xor_sync(FULL, sc[u], o);
      float mt = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) sc[u] = -INFINITY;
        mt = fmaxf(mt, sc[u]);
      }
      const int si = (warp * gb + hh) * 32 + lane;
      float4* acc = reinterpret_cast<float4*>(
          sacc + (stream * gb + hh) * D + 4 * lir);
      const float m_old = sm[si];
      const float m_new = fmaxf(m_old, mt);
      // a stream that has seen no live key yet keeps m = -inf, l = 0 and
      // a zero accumulator: subtract 0 there instead of -inf
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_old - m_use);
      float4 a = *acc;
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u] - m_use);
        psum += p;
        fma4(p, vr[u], a);
      }
      *acc = a;
      sm[si] = m_new;
      sl[si] = fmaf(sl[si], alpha, psum);
    }
  }
  __syncthreads();

  // merge the block's streams, in stream order
  for (int i = tid; i < gb * D; i += THREADS) {
    const int hh = i / D, d = i % D;
    const int lir_d = (d >> 2);                       // the lane holding d
    float ms[G::STREAMS];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < G::STREAMS; ++r) {
      const int w = r / G::RPW, ln = (r % G::RPW) * G::LPR + lir_d;
      ms[r] = sm[(w * gb + hh) * 32 + ln];
      m = fmaxf(m, ms[r]);
    }
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < G::STREAMS; ++r) {
      const int w = r / G::RPW, ln = (r % G::RPW) * G::LPR + lir_d;
      const float e = exp2f(ms[r] - m);
      l = fmaf(sl[(w * gb + hh) * 32 + ln], e, l);
      a = fmaf(sacc[(r * gb + hh) * D + d], e, a);
    }
    if (n_chunks == 1) {
      dst[i] = a / l;
    } else {
      const size_t row = (static_cast<size_t>(b) * Hq + hq0 + hh)
                         * n_chunks + c;
      part_acc[row * D + d] = a;
      if (d == 0) {
        part_ml[2 * row] = m;
        part_ml[2 * row + 1] = l;
      }
    }
  }
}

// One block per (slot, query head): the slot's live chunks merged in chunk
// order into the normalised output.
__global__ void __launch_bounds__(128)
paged_decode_combine(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ cache_len,
                     float* __restrict__ out, int Hq, int D, int S,
                     int chunk, int n_chunks) {
  const int row = blockIdx.x, b = row / Hq;
  const int n_keys = live_keys(cache_len[b], S);
  const int live = n_keys <= 0 ? 0 : (n_keys + chunk - 1) / chunk;
  const float* ml = part_ml + static_cast<size_t>(row) * n_chunks * 2;
  float m = -INFINITY;
  for (int c = 0; c < live; ++c) m = fmaxf(m, ml[2 * c]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int c = 0; c < live; ++c) {
      const float e = exp2f(ml[2 * c] - m);
      l = fmaf(ml[2 * c + 1], e, l);
      a = fmaf(part_acc[(static_cast<size_t>(row) * n_chunks + c) * D + d],
               e, a);
    }
    out[static_cast<size_t>(row) * D + d] = a / l;   // NaN with no key
  }
}

template <int D>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* cache_len, const void* k, const void* v, void* out,
           void* part_acc, void* part_ml, int B, int Hkv, int g, int S,
           int bt, long long sb, long long sn, long long st, int chunk,
           int n_chunks, float scale_log2, cudaStream_t stream) {
  const int smem = min(g, GMAX) * Geo<D>::SMEM_PER_HEAD * 4;
  auto kernel = paged_decode_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * Hkv, n_chunks, (g + GMAX - 1) / GMAX);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<const int*>(cache_len),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), Hkv, g, S, bt, sb, sn, st, chunk,
      n_chunks, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  paged_decode_combine<<<B * Hkv * g, 128, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(cache_len), static_cast<float*>(out), Hkv * g,
      D, S, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv·g, D); k_new, v_new (B, Hkv, D); cache_len (B,) int32; k, v
// (B, n_blk, bt, Hkv, D) with element strides sb, sn, st for batch, block
// and token and S = n_blk·bt; out (B, Hkv·g, D); part_acc (B, Hkv·g,
// n_chunks, D) and part_ml (B, Hkv·g, n_chunks, 2) are scratch, unused at
// n_chunks == 1. All float32 but cache_len; every vector 16-byte aligned.
// scale_log2 = log2(e) / sqrt(D).
extern "C" int paged_decode(const void* q, const void* k_new,
                            const void* v_new, const void* cache_len,
                            const void* k, const void* v, void* out,
                            void* part_acc, void* part_ml, int B, int Hkv,
                            int g, int D, int S, int bt, long long sb,
                            long long sn, long long st, int chunk,
                            int n_chunks, float scale_log2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k_new, v_new, cache_len, k, v, out, part_acc,
                        part_ml, B, Hkv, g, S, bt, sb, sn, st, chunk,
                        n_chunks, scale_log2, s);
    case 64:
      return launch<64>(q, k_new, v_new, cache_len, k, v, out, part_acc,
                        part_ml, B, Hkv, g, S, bt, sb, sn, st, chunk,
                        n_chunks, scale_log2, s);
    case 128:
      return launch<128>(q, k_new, v_new, cache_len, k, v, out, part_acc,
                         part_ml, B, Hkv, g, S, bt, sb, sn, st, chunk,
                         n_chunks, scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
