// Page -> (row, lane) translation of one W-word slice, shared by the
// kernels that move whole pages in a mixed pool (mixed.cu, hash.cu,
// interwrap.cu, parity8.cu), and a PARITY page's packed-parity slot.
//
// The rules of repro_torch.core.layouts.page_coords, one slice at a time:
// regular pages [0, boundary) are CREAM, [boundary, num_rows) SECDED rows,
// ids from num_rows up are the reclaimed extra pages.
#pragma once

namespace repro_torch {

__device__ __forceinline__ void page_slice(int page, int k, int interwrap,
                                           int num_rows, int boundary,
                                           int ebase, int& row, int& lane,
                                           bool& sec) {
  const bool is_extra = page >= num_rows;
  const int e = page - num_rows;
  sec = page >= boundary && page < num_rows;
  if (interwrap) {
    // CREAM and extra pages are wrap-striped (l = 8*slot + k, extras take
    // slot 8 of their group); SECDED rows are conventional
    const int group = is_extra ? e : page / 8;
    const int slot = is_extra ? 8 : page % 8;
    const int linear = 8 * slot + k;
    row = sec ? page : 8 * group + linear / 9;
    lane = sec ? k : linear % 9;
  } else {
    // regular pages are row-wise; extras live in 8 code-lane rows
    row = is_extra ? ebase + 8 * e + k : page;
    lane = is_extra ? 8 : k;
  }
}

// A PARITY pool's packed parity of a CREAM or extra page: code-lane row
// `prow` holds 8 pages' entries of row_words / 8 words each, and the page's
// entry starts at word `off` (layouts.parity_coords). Extra page e counts
// as page boundary + e, in the second block of tables that starts at row
// `tables` = ceil(boundary / 8). SECDED pages have no slot.
__device__ __forceinline__ void parity_slot(int page, int num_rows,
                                            int boundary, int tables,
                                            int row_words, int& prow,
                                            int& off) {
  const int rel = page >= num_rows ? boundary + (page - num_rows) : page;
  prow = rel < boundary ? rel / 8 : tables + (rel - boundary) / 8;
  off = (rel % 8) * (row_words / 8);
}

}  // namespace repro_torch
