// Word-granular page access, for pools whose row width W is not a
// multiple of 8: the word path of the pool kernels (mixed.cu, hash.cu,
// migrate.cu, interwrap.cu).
//
// A page's 8W data words, in flat order f = k * W + o (word o of slice k),
// move in groups of 8: group j is the flat words [8j, 8j + 8), the four
// beats that packed SECDED code word j of the page's code plane covers.
// When W % 8 == 0 every group lies inside one slice at a 32-byte boundary,
// and the vector path moves it as two 16-byte vectors. Otherwise a group
// may straddle two slices (more when W < 8), and a slice starts at a
// 4-byte boundary only, so these helpers walk the group word by word and
// translate the next slice (coords.cuh page_slice) when the offset
// reaches W. A page's row of a batch buffer (8W words) starts at a
// multiple of 32 bytes, so there a group is still two aligned vectors.
#pragma once

#include <cstdint>

#include "coords.cuh"

namespace repro_torch {

// The translation a page's slices need: the geometry page_slice takes.
struct PageGeom {
  int W, interwrap, num_rows, boundary, ebase;
};

// The geometry of a pool whose InterWrap region covers every row.
__device__ __forceinline__ PageGeom whole_interwrap(int W, int num_rows) {
  return PageGeom{W, 1, num_rows, num_rows, 0};
}

// First word of slice k of `page` in the (num_rows, 9, W) storage, its row
// and lane clamped into the pool as the vector path clamps them.
__device__ __forceinline__ size_t slice_start(const PageGeom& g, int page,
                                              int k) {
  int row, lane;
  bool sec;
  page_slice(page, k, g.interwrap, g.num_rows, g.boundary, g.ebase, row,
             lane, sec);
  row = min(max(row, 0), g.num_rows - 1);
  lane = min(max(lane, 0), 8);
  return (static_cast<size_t>(row) * 9 + lane) * g.W;
}

// Group j of `page` from storage, as two vectors (words 8j..8j+3, 8j+4..).
__device__ __forceinline__ void load_group(const int32_t* __restrict__ bank,
                                           const PageGeom& g, int page, int j,
                                           uint4& a, uint4& b) {
  uint32_t w[8];
  int k = 8 * j / g.W, o = 8 * j - k * g.W;
  size_t base = slice_start(g, page, k);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (o == g.W) {
      o = 0;
      base = slice_start(g, page, ++k);
    }
    w[e] = static_cast<uint32_t>(bank[base + o++]);
  }
  a = make_uint4(w[0], w[1], w[2], w[3]);
  b = make_uint4(w[4], w[5], w[6], w[7]);
}

// Blocks of kGroupThreads for a grid-stride loop over `total` items (the
// word entries and both scrub entries).
constexpr int kGroupThreads = 256;

__host__ __forceinline__ int group_blocks(int total) {
  const int blocks = (total + kGroupThreads - 1) / kGroupThreads;
  return blocks < 65535 * 8 ? (blocks > 0 ? blocks : 1) : 65535 * 8;
}

}  // namespace repro_torch
