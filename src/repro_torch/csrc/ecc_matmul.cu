// SECDED decode-on-load matrix product: A arrives as Hsiao(72,64)-protected
// bf16 words, is corrected as it is loaded and multiplied with B in the
// same kernel, so a protected weight matrix is read from device memory
// once (plus its 12.5 % of code bytes) and never decoded to a copy.
//
// Replaces the Pallas TPU kernel repro/kernels/ecc_matmul/kernel.py
// `ecc_matmul` (:61, pallas_call :73), which decoded an (i, k) tile on the
// VPU and fed it to the MXU, accumulating into the revisited output block
// over a sequential K grid.
//
// Inputs: A bits (M, K/2) words (bf16 element 2j in the low half of word
// j), A codes (M, K/16) words (four 8-bit check bytes a word, low byte
// first: one code word per 8 data words, the pool's packing), B (K, N)
// bf16, row-major. Output (M, N) float32. K % 16 == 0; any M and N.
// Single data-bit errors of A are corrected; code-bit and uncorrectable
// beats pass through, as in the TPU kernel. No split-K and no atomics:
// every output is a sum in a fixed order, so a run repeats bit for bit.
//
// Two designs; the wrapper (kernels/ecc_matmul/ops.py) picks one by N:
// the decode pass up to N = 16 (DECODE_MAX_N), the tiled product above.
//
// 1. ecc_matmul_tiled (prefill, N large): bound by operations, 2MNK on the
//    bf16 tensor cores. 128 x 256 output tiles, K in steps of 64, a cluster
//    of two blocks along N sharing one 128-row A tile. Three warpgroups a
//    block (384 threads leave 168 registers a thread, room for 128 float32
//    sums; at 512 ptxas caps the wgmma at 128 even behind setmaxnreg): two
//    consumers issue wgmma.mma_async m64n256k16 (bf16 x bf16 -> float32 in
//    registers; B read MN-major through the transpose-B bit, so B is never
//    transposed in memory) on a 4-stage ring in shared memory behind
//    mbarriers, and one correction warpgroup fills the A side of it. B
//    comes by TMA, 128-byte swizzled, issued by consumer thread 0 as soon
//    as both blocks have released a stage: one 3-D box of four 64-column
//    boxes a step where N % 64 == 0, four 2-D boxes where N % 8 == 0, and
//    otherwise plain loads zero-filled past the edge by a corrector warp (a
//    row of N % 8 != 0 columns is not 16-byte aligned, so neither TMA nor
//    16-byte cp.async can take it).
//    The trap of this design is the SECDED syndrome, not the tensor cores:
//    a 64-bit beat costs 8 POPC (16 a clock on an SM) and ~20 ALU ops, so
//    an SM corrects at most ~8 A elements a clock, while the tensor cores
//    take 4096 / (2 BN) = 8 a clock at BN = 256, and four warps reach about
//    half of that rate. So each block of the pair corrects only its 64
//    rows: its correctors stream them from device memory into registers
//    three steps ahead (one 8-word group and its code word a thread, a warp
//    reading 8 rows x 128 bytes), compute the checks of all their groups
//    before branching to the fix of a nonzero syndrome, store the words
//    into the K-major, 128-byte-swizzled A tile that wgmma reads, and fence
//    the generic-proxy writes for the async proxy (fence.proxy.async). One
//    warp a step, in turn, waits for the others and ships the rows to the
//    peer's tile with one bulk copy into distributed shared memory that
//    completes on the peer's mbarrier; the others go on to the next step.
//    A protected matrix is read from device memory once a cluster and
//    never decoded to a bf16 copy in device memory.
//
// 2. ecc_matmul_decode (decode batch, N <= 16): bound by bytes, A streamed
//    once. B[:, :N] sits in shared memory, laid out [k % 16][k / 16][n] so
//    the lanes of a warp read neighbouring words. Each lane loads one
//    8-word group and its code word (a warp reads 1 KB of bits and 128 B
//    of codes contiguously) for U rows at once, so U groups are in flight a
//    lane; it corrects them in registers, widens to float32 and keeps
//    U x N float32 sums. A row's K is split across up to 8 warps of the
//    block (the down projection's 1024 rows of 6 KB would otherwise leave
//    too few warps per SM to hide HBM latency); the sums reduce by xor
//    shuffles, then across the row's warps in shared memory, both in a
//    fixed order. SIMT FMAs suffice: 2MNK is 25 MFLOP at N = 4.
#include <cuda.h>

#include "secded.cuh"

using namespace repro_torch;

namespace {

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Check byte of one beat, as secded.cuh's encode_beat, with fewer ALU
// operations: the eight parity counts are packed 8 bits apart in two words
// (popc <= 32 fits a field) and each word's four low bits are gathered into
// a nibble by one multiply (bit 8i lands at bit 24 + i; no other product
// term reaches bits 24..31 and none collide, so nothing carries).
__device__ __forceinline__ uint32_t check_byte(uint32_t lo, uint32_t hi) {
  uint32_t w0 = 0, w1 = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    w0 += uint32_t(__popc((lo & kMaskLo[p]) ^ (hi & kMaskHi[p]))) << (8 * p);
    w1 += uint32_t(__popc((lo & kMaskLo[p + 4]) ^ (hi & kMaskHi[p + 4])))
          << (8 * p);
  }
  return (((w0 & 0x01010101u) * 0x01020408u) >> 24) |
         (((w1 & 0x01010101u) * 0x10204080u) >> 24);
}

// The packed check word of a group (8 words): equal to its stored code
// word iff all four beats are clean; XOR-ed with it, the four syndromes.
// Callers compute the checks of all their groups first, then branch to
// fix_group, so the syndrome work of several groups interleaves.
__device__ __forceinline__ uint32_t check_group(const uint4& a,
                                                const uint4& b) {
  return check_byte(a.x, a.y) | (check_byte(a.z, a.w) << 8) |
         (check_byte(b.x, b.y) << 16) | (check_byte(b.z, b.w) << 24);
}

// Data-bit correction of one beat from its syndrome (computed ^ stored
// check byte), as secded.cuh's decode_beat: a single data-bit error is
// fixed, a code-bit or uncorrectable one passes through.
__device__ __forceinline__ void fix_beat(uint32_t& lo, uint32_t& hi,
                                         uint32_t syndrome) {
  if (!syndrome) return;
  const int act = kAction[syndrome];
  if (act >= 0 && act < 32) lo ^= 1u << act;
  if (act >= 32 && act < 64) hi ^= 1u << (act - 32);
}

// The same for a group, from the XOR of its computed and stored code
// words (four syndromes, low byte first): the syndromes are not computed
// again.
__device__ __forceinline__ void fix_group(uint4& a, uint4& b, uint32_t syn) {
  fix_beat(a.x, a.y, syn & 0xFFu);
  fix_beat(a.z, a.w, (syn >> 8) & 0xFFu);
  fix_beat(b.x, b.y, (syn >> 16) & 0xFFu);
  fix_beat(b.z, b.w, syn >> 24);
}

// ---------------------------------------------------------------------------
// 1. The tiled product on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kShare = 2;                       // blocks sharing an A tile
constexpr int kPart = kBM / kShare;             // A rows a block corrects
constexpr int kABytes = kBM * kBK * 2;          // 16384: swizzled A tile
constexpr int kAPartBytes = kABytes / kShare;   // 8192: one block's rows
constexpr int kAHalfBytes = kABytes / 2;        // 8192: a consumer's rows
constexpr int kBBox = 64;                       // B columns per TMA box
constexpr int kBBoxBytes = kBK * kBBox * 2;     // 8192
constexpr int kBBytes = kBK * kBN * 2;          // 32768
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kTiledSmem = kStages * kStageBytes + 1024;  // + alignment
// three warpgroups: at 384 threads a thread may hold 168 registers, room
// for a consumer's 128 float32 sums
constexpr int kConsumers = 256, kCorrectors = 128;
constexpr int kTiledThreads = kConsumers + kCorrectors;
constexpr int kPer = kPart * 4 / kCorrectors;   // groups a corrector owns
constexpr int kAhead = 3;                       // steps of A rows in flight
// the consumer warps of every block of the cluster release a stage
constexpr int kEmptyArrivals = kShare * kConsumers / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// The same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// Bulk copy of `bytes` from this block's shared memory to a peer's,
// completing on the peer's mbarrier.
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// d (64 x 256 float32, the warpgroup's fragment) += A (64 x 16, K-major)
// x B (16 x 256, MN-major: transpose-B set).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n\t}"
      : D16(0), D16(16), D16(32), D16(48), D16(64), D16(80), D16(96),
        D16(112)
      : "l"(da), "l"(db), "r"(1));
}

#undef D16
#undef D4

// Orders the accumulator registers against the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store2(float* out, int row, int col, int N,
                                       float x, float y) {
  float* p = out + static_cast<size_t>(row) * N + col;
  if (col < N) p[0] = x;
  if (col + 1 < N) p[1] = y;
}

// One corrector's share of a step: kPer groups of its block's A rows.
struct Groups {
  uint4 lo[kPer], hi[kPer];
  uint32_t code[kPer];
};

__global__ void __cluster_dims__(kShare, 1, 1)
__launch_bounds__(kTiledThreads, 1)
ecc_matmul_tiled_kernel(const __grid_constant__ CUtensorMap map_b,
                        const uint4* __restrict__ bits,
                        const uint32_t* __restrict__ codes,
                        const uint16_t* __restrict__ b,
                        float* __restrict__ out, int M, int N, int K,
                        int b_tma, int b_3d) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: full (B and every block's A rows landed), empty (the
  // consumers of every block of the cluster are done with it), ready (the
  // correctors' warps have stored and fenced this block's rows)
  __shared__ __align__(8) uint64_t bars[3 * kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem), bar0 = smem_u32(bars);
  auto stage_a = [&](int s) { return base + s * kStageBytes; };
  auto stage_b = [&](int s) { return stage_a(s) + kABytes; };
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  auto ready = [&](int s) { return bar0 + 8 * (2 * kStages + s); };

  // the blocks of a cluster (same m0) share the A tile, each correcting
  // kPart of its rows
  const uint32_t rank = cluster_rank();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = ceil_div(K, kBK);
  if (threadIdx.x == 0) {
    if (b_tma)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b)) : "memory");
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kEmptyArrivals);
      mbar_init(ready(s), kCorrectors / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {
    // ---- correction warpgroup: this block's kPart A rows ----
    const int t = threadIdx.x - kConsumers, warp = t / 32;
    const int G = K / 16;                  // packed code words a row
    // group i of a step: row (t + 128 i) / 4 of the block's rows, code
    // word (t + 128 i) % 4 of the step; a warp reads 8 rows x 128 bytes
    auto fetch = [&](int kt, Groups& g) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = t + kCorrectors * i;
        const int row = m0 + rank * kPart + q / 4, c = kt * 4 + q % 4;
        g.lo[i] = g.hi[i] = make_uint4(0u, 0u, 0u, 0u);
        g.code[i] = 0u;
        if (row < M && c < G) {
          const size_t at = static_cast<size_t>(row) * G + c;
          g.lo[i] = __ldg(bits + 2 * at);
          g.hi[i] = __ldg(bits + 2 * at + 1);
          g.code[i] = __ldg(codes + at);
        }
      }
    };
    // B of step kt into stage kt % kStages where TMA cannot, once it is
    // empty: plain loads of the whole tile by the step's leading warp
    // (lane = one 16-byte chunk, 8 columns, of a 256-column row)
    auto load_b_plain = [&](int kt) {
      const int s = kt % kStages, k0 = kt * kBK;
      {
        const int col = n0 + 8 * lane, box = lane / 8, chunk = lane % 8;
        for (int r = 0; r < kBK; ++r) {
          const int k = k0 + r;
          const uint16_t* row = b + static_cast<size_t>(k) * N;
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = col + 2 * q;
            const uint32_t lo = (k < K && c < N) ? row[c] : 0u;
            const uint32_t hi = (k < K && c + 1 < N) ? row[c + 1] : 0u;
            w[q] = lo | (hi << 16);
          }
          const uint32_t dst = stage_b(s) + box * kBBoxBytes + r * 128 +
                               ((chunk ^ (r & 7)) << 4);
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
                       "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                       : "memory");
        }
      }
    };
    // A rows stream into registers kAhead steps ahead of their correction
    Groups ahead[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) fetch(a, ahead[a]);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      Groups g = ahead[0];
#pragma unroll
      for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
      fetch(kt + kAhead, ahead[kAhead - 1]);
      uint32_t check[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) check[i] = check_group(g.lo[i], g.hi[i]);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (check[i] != g.code[i])
          fix_group(g.lo[i], g.hi[i], check[i] ^ g.code[i]);
      // each step one warp leads: it hands the rows on (and loads B where
      // TMA cannot)
      const bool leads = warp == kt % (kCorrectors / 32);
      mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
      if (leads && !b_tma) load_b_plain(kt);
      // the corrected words go where the 128-byte swizzle puts them: 16-byte
      // chunk c of row r at chunk c ^ (r % 8)
      const uint32_t part = stage_a(s) + rank * kAPartBytes;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = t + kCorrectors * i, row = q / 4, kg = q % 4;
        const uint32_t at = part + row * 128;
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                         at + (((2 * kg) ^ (row & 7)) << 4)),
                     "r"(g.lo[i].x), "r"(g.lo[i].y), "r"(g.lo[i].z),
                     "r"(g.lo[i].w) : "memory");
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                         at + (((2 * kg + 1) ^ (row & 7)) << 4)),
                     "r"(g.hi[i].x), "r"(g.hi[i].y), "r"(g.hi[i].z),
                     "r"(g.hi[i].w) : "memory");
      }
      // the corrected words (and B where it came by plain loads), written
      // by the generic proxy, are read by wgmma and by the bulk copy: the
      // async proxy. Only the leader waits for the other warps; they go on
      // to the next step's syndromes.
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ready(s));
      if (leads && lane == 0) {
        mbar_wait(ready(s), (kt / kStages) & 1);
        mbar_arrive_tx(full(s), (b_tma ? kBBytes : 0) +
                                    (kShare - 1) * kAPartBytes);
        for (uint32_t r = 0; r < kShare; ++r)
          if (r != rank)
            copy_to_peer(peer_addr(part, r), part, kAPartBytes,
                         peer_addr(full(s), r));
      }
    }
    // Keep this block, and the barriers its peers arrive on, alive until
    // every consumer of the cluster has released every stage.
    for (int kt = nk; kt < nk + kStages; ++kt)
      mbar_wait(empty(kt % kStages), ((kt / kStages) & 1) ^ 1);
  } else {
    // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile ----
    const int wg = threadIdx.x / 128;
    auto release = [&](int s) {
      // lane r signals block r of the cluster
      if (lane < kShare) mbar_arrive_remote(peer_addr(empty(s), lane));
    };
    // B by TMA from thread 0, kStages steps ahead: the load of step
    // kt + kStages - 1 goes out as soon as every consumer of the cluster
    // has released step kt - 1, whatever the correctors are doing
    const bool issues_b = b_tma && threadIdx.x == 0;
    auto load_b = [&](int kt) {
      const int s = kt % kStages, k0 = kt * kBK;
      if (b_3d)
        tma_3d(stage_b(s), &map_b, full(s), 0, k0, n0 / kBBox);
      else
        for (int j = 0; j < kBN / kBBox; ++j)
          tma_2d(stage_b(s) + j * kBBoxBytes, &map_b, full(s),
                 n0 + j * kBBox, k0);
    };
    if (issues_b)
      for (int kt = 0; kt < kStages && kt < nk; ++kt) load_b(kt);
    float d[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) d[j] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      const uint32_t a = stage_a(s) + wg * kAHalfBytes, bb = stage_b(s);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        // A: K-major, 8-row groups 1024 B apart, k16 step 32 B into the
        // swizzle atom; B: MN-major, 64-column boxes 8192 B apart (LBO),
        // 8-row k groups 1024 B apart (SBO), k16 step two groups
        wgmma_256(d, sw128_desc(a + 32 * j, 16, 1024),
                  sw128_desc(bb + 2048 * j, kBBoxBytes, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (kt > 0) {
        const int done = kt - 1, s_done = done % kStages;
        release(s_done);
        if (issues_b && done + kStages < nk) {
          mbar_wait(empty(s_done), (done / kStages) & 1);
          load_b(done + kStages);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    release((nk - 1) % kStages);
    // fragment: warp w of the warpgroup holds rows 16w + lane/4 (+8);
    // register 4j + 2h + e is column 8j + 2 (lane % 4) + e of row +8h
    const int w = (threadIdx.x % 128) / 32;
    const int r0 = m0 + 64 * wg + 16 * w + lane / 4;
    if (N % 4 == 0) {
      // neighbouring lanes swap halves so that each holds four columns of
      // one row: the even lane row r0, the odd lane row r0 + 8; one
      // 16-byte store each
      const bool odd = lane & 1;
      const int row = odd ? r0 + 8 : r0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float x = __shfl_xor_sync(0xFFFFFFFFu,
                                        odd ? d[4 * j] : d[4 * j + 2], 1);
        const float y = __shfl_xor_sync(0xFFFFFFFFu,
                                        odd ? d[4 * j + 1] : d[4 * j + 3], 1);
        const int col = n0 + 8 * j + 2 * (lane % 4 & 2);
        if (row < M && col < N)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N +
                                     col) =
              odd ? make_float4(x, y, d[4 * j + 2], d[4 * j + 3])
                  : make_float4(d[4 * j], d[4 * j + 1], x, y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r0 + 8 * h < M)
            store2(out, r0 + 8 * h, col, N, d[4 * j + 2 * h],
                   d[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The decode pass
// ---------------------------------------------------------------------------

constexpr int kDecodeSmemB = 192 * 1024;   // most bytes of B[:, :NP]

// U rows' groups at group index g of a row batch, loaded in one go (U
// loads in flight a lane); rows past M read as zero words with zero codes,
// which are clean.
template <int U>
struct RowGroups {
  uint4 lo[U], hi[U];
  uint32_t code[U];

  __device__ __forceinline__ void load(const uint4* bits,
                                       const uint32_t* codes, int M, int G,
                                       int row0, int step, int g) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = row0 + u * step;
      lo[u] = hi[u] = make_uint4(0u, 0u, 0u, 0u);
      code[u] = 0u;
      if (row < M && g < G) {
        const size_t at = static_cast<size_t>(row) * G + g;
        lo[u] = __ldcs(bits + 2 * at);
        hi[u] = __ldcs(bits + 2 * at + 1);
        code[u] = __ldcs(codes + at);
      }
    }
  }
};

template <int NP, int U>
__global__ void __launch_bounds__(256)
ecc_matmul_decode_kernel(const uint4* __restrict__ bits,
                         const uint32_t* __restrict__ codes,
                         const uint16_t* __restrict__ b,
                         float* __restrict__ out, int M, int N, int K,
                         int wpr, int rpb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = K / 16;
  uint16_t* bs = reinterpret_cast<uint16_t*>(smem);        // [16][G][NP]
  float* red = reinterpret_cast<float*>(smem + static_cast<size_t>(K) * NP *
                                                   2);     // [U][rpb][wpr][NP]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rloc = warp / wpr, wr = warp % wpr;
  const int per_iter = rpb * U;
  // the first batch's A groups go out before B is staged, so the two
  // latencies overlap
  RowGroups<U> next;
  next.load(bits, codes, M, G, blockIdx.x * per_iter + rloc, rpb,
            wr * 32 + lane);
  // B[:, :N] into [k % 16][k / 16][n], zero past N: 16-byte loads of the
  // flat row-major array where it is aligned, element loads otherwise
  if (NP != N)
    for (int e = threadIdx.x; e < K * NP / 8; e += blockDim.x)
      reinterpret_cast<uint4*>(bs)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto put = [&](int f, uint16_t v) {
    const int k = f / N, n = f % N;
    bs[((k % 16) * G + k / 16) * NP + n] = v;
  };
  const int total = K * N;
  if (total % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0) {
    for (int e = threadIdx.x; e < total / 8; e += blockDim.x) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(b) + e);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        put(8 * e + 2 * q, uint16_t(w[q] & 0xFFFFu));
        put(8 * e + 2 * q + 1, uint16_t(w[q] >> 16));
      }
    }
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x) put(f, b[f]);
  }
  __syncthreads();
  for (int row0 = blockIdx.x * per_iter; row0 < M;
       row0 += gridDim.x * per_iter) {
    float acc[U][NP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NP; ++n) acc[u][n] = 0.f;
    for (int g = wr * 32 + lane; g < G; g += wpr * 32) {
      RowGroups<U> cur = next;
      // the next group of this batch, or the first of the next batch
      const bool same_batch = g + wpr * 32 < G;
      next.load(bits, codes, M, G,
                (same_batch ? row0 : row0 + gridDim.x * per_iter) + rloc,
                rpb, same_batch ? g + wpr * 32 : wr * 32 + lane);
      uint32_t check[U];
#pragma unroll
      for (int u = 0; u < U; ++u) check[u] = check_group(cur.lo[u], cur.hi[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (check[u] != cur.code[u])
          fix_group(cur.lo[u], cur.hi[u], check[u] ^ cur.code[u]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float b0[NP], b1[NP];
        const uint16_t* p0 = bs + (static_cast<size_t>(2 * j) * G + g) * NP;
        const uint16_t* p1 = p0 + static_cast<size_t>(G) * NP;
#pragma unroll
        for (int q = 0; q < NP / 4; ++q) {
          const uint2 v0 = reinterpret_cast<const uint2*>(p0)[q];
          const uint2 v1 = reinterpret_cast<const uint2*>(p1)[q];
          b0[4 * q] = bf16_lo(v0.x);
          b0[4 * q + 1] = bf16_hi(v0.x);
          b0[4 * q + 2] = bf16_lo(v0.y);
          b0[4 * q + 3] = bf16_hi(v0.y);
          b1[4 * q] = bf16_lo(v1.x);
          b1[4 * q + 1] = bf16_hi(v1.x);
          b1[4 * q + 2] = bf16_lo(v1.y);
          b1[4 * q + 3] = bf16_hi(v1.y);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const uint4& v = j < 4 ? cur.lo[u] : cur.hi[u];
          const uint32_t w = j % 4 == 0   ? v.x
                             : j % 4 == 1 ? v.y
                             : j % 4 == 2 ? v.z
                                          : v.w;
          const float a0 = bf16_lo(w), a1 = bf16_hi(w);
#pragma unroll
          for (int n = 0; n < NP; ++n)
            acc[u][n] = fmaf(a1, b1[n], fmaf(a0, b0[n], acc[u][n]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int off = 16; off; off >>= 1)
          acc[u][n] += __shfl_xor_sync(0xFFFFFFFFu, acc[u][n], off);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int n = 0; n < NP; ++n)
          red[(((u * rpb + rloc) * wpr) + wr) * NP + n] = acc[u][n];
    __syncthreads();
    for (int e = threadIdx.x; e < per_iter * NP; e += blockDim.x) {
      const int n = e % NP, ur = e / NP;   // ur = u * rpb + rloc
      const int row = row0 + ur;
      if (row < M && n < N) {
        float s = 0.f;
        for (int w = 0; w < wpr; ++w) s += red[(ur * wpr + w) * NP + n];
        out[static_cast<size_t>(row) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

template <int NP, int U>
int launch_decode(const void* bits, const void* codes, const void* b,
                  void* out, int M, int N, int K, cudaStream_t stream) {
  auto kernel = ecc_matmul_decode_kernel<NP, U>;
  const int G = K / 16;
  const int wpr = min(8, ceil_div(G, 32)), rpb = max(1, 8 / wpr);
  const int threads = 32 * wpr * rpb;
  const size_t smem = static_cast<size_t>(K) * NP * 2 +
                      sizeof(float) * U * rpb * wpr * NP;
  if (static_cast<size_t>(K) * NP * 2 > kDecodeSmemB)
    return static_cast<int>(cudaErrorInvalidValue);
  // blocks the card holds at once, for the last K seen (set-up calls are
  // host time on every launch otherwise)
  static int last_k = -1, resident = 0;
  if (K != last_k) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_k = K;
    resident = sms * max(per_sm, 1);
  }
  const int grid = min(ceil_div(M, rpb * U), resident);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint4*>(bits), static_cast<const uint32_t*>(codes),
      static_cast<const uint16_t*>(b), static_cast<float*>(out), M, N, K, wpr,
      rpb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 2-D row-major map of `rows` x `cols` elements, a box of box_rows x
// box_cols; out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
              int elem_bytes, const void* ptr, int rows, int cols,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int ecc_matmul_tiled(const void* bits, const void* codes,
                                const void* b, void* out, int M, int N, int K,
                                void* stream) {
  // TMA needs 16-byte global strides: B's rows have them when N % 8 == 0.
  // Where N % 64 == 0, B is viewed as (N / 64, K, 64) and one 3-D box
  // brings the four 64-column boxes of a step
  const int b_tma = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int b_3d = b_tma && N % kBBox == 0;
  CUtensorMap map_b{};
  if (b_tma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return static_cast<int>(cudaErrorNotSupported);
    bool ok;
    if (b_3d) {
      const cuuint64_t dims[3] = {kBBox, static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(N / kBBox)};
      const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                     kBBox * 2};
      const cuuint32_t box[3] = {kBBox, kBK, kBN / kBBox};
      const cuuint32_t elem_strides[3] = {1, 1, 1};
      ok = encode(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(b), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    } else {
      ok = make_map(&map_b, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, K,
                    N, kBK, kBBox, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ecc_matmul_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTiledSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  // whole clusters along N: an extra block past N stores nothing
  const dim3 grid(ceil_div(ceil_div(N, kBN), kShare) * kShare,
                  ceil_div(M, kBM));
  ecc_matmul_tiled_kernel<<<grid, kTiledThreads, kTiledSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      map_b, static_cast<const uint4*>(bits),
      static_cast<const uint32_t*>(codes), static_cast<const uint16_t*>(b),
      static_cast<float*>(out), M, N, K, b_tma, b_3d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ecc_matmul_decode(const void* bits, const void* codes,
                                 const void* b, void* out, int M, int N,
                                 int K, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch_decode<4, 4>(bits, codes, b, out, M, N, K, s);
  if (N <= 8) return launch_decode<8, 4>(bits, codes, b, out, M, N, K, s);
  if (N <= 16) return launch_decode<16, 2>(bits, codes, b, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
