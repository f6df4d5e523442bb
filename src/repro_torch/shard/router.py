"""Shard router — global page ids -> (shard, local page).

Port of ``repro/shard/router.py``. The sharded pool stripes the global
page-id space round-robin over ``S`` banks, the software analogue of DRAM
bank interleaving and of the paper's rank subsetting (§4.1.2): every bank
is an independent, identically-shaped CREAM mini-pool, and consecutive
global pages land on consecutive banks.

Global convention (the same as :mod:`repro_torch.core.pool`'s):

    pages [0, boundary)            CREAM-region regular pages
    pages [boundary, num_rows)     SECDED-protected pages
    pages [num_rows, num_pages)    reclaimed extra pages

With ``S`` banks of ``R_local`` rows and local boundary ``b_local``:

  * regular page ``p``  -> bank ``p % S``,  local page ``p // S``;
  * extra page ``num_rows + e`` -> bank ``e % S``, local page
    ``R_local + e // S``.

Because ``boundary = S * b_local``, the global region of a page (CREAM,
SECDED or extra) is exactly the local region of its routed id, and a
page's bank never changes when the boundary moves.

:func:`route` / :func:`unroute` work on tensors (any device);
:func:`route_np` and :func:`plan_streams` on host numpy ids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layouts import GROUP_ROWS


def route(pages: torch.Tensor, num_rows: int, num_shards: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global page ids -> ``(shard (n,), local (n,))`` int64 tensors.

    ``num_rows`` is the global regular-page count (``S * R_local``)."""
    pages = torch.as_tensor(pages).long().reshape(-1)
    rows_local = num_rows // num_shards
    is_extra = pages >= num_rows
    e = pages - num_rows
    shard = torch.where(is_extra, e % num_shards, pages % num_shards)
    local = torch.where(is_extra, rows_local + e // num_shards,
                        pages // num_shards)
    return shard, local


def unroute(shard, local, num_rows: int, num_shards: int) -> torch.Tensor:
    """Inverse of :func:`route`: ``(shard, local)`` -> global page ids."""
    shard = torch.as_tensor(shard).long()
    local = torch.as_tensor(local).long()
    rows_local = num_rows // num_shards
    is_extra = local >= rows_local
    return torch.where(is_extra,
                       num_rows + (local - rows_local) * num_shards + shard,
                       local * num_shards + shard)


def route_np(pages, num_rows: int, num_shards: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side :func:`route` for concrete page-id vectors (int64)."""
    p = np.asarray(pages, np.int64).reshape(-1)
    rows_local = num_rows // num_shards
    is_extra = p >= num_rows
    e = p - num_rows
    shard = np.where(is_extra, e % num_shards, p % num_shards)
    local = np.where(is_extra, rows_local + e // num_shards, p // num_shards)
    return shard, local


def plan_streams(pages, num_rows: int, num_shards: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regroup concrete global ids into bank-aligned padded streams.

    Returns ``(spages (S, m) int32, valid (S, m) bool, inv (n,) int64)``:
    stream ``s`` holds the batch entries bank ``s`` owns, in batch order,
    padded to a power-of-two width ``m`` with bank ``s``'s own page id
    ``s`` (``valid`` False); ``inv[i] = s * m + pos`` recovers entry ``i``
    from the flattened ``(S * m, ...)`` stream output.
    """
    S = num_shards
    p = np.asarray(pages, np.int64).reshape(-1)
    shard, _ = route_np(p, num_rows, S)
    counts = np.bincount(shard, minlength=S)
    m = 1 << max(0, int(counts.max(initial=1) - 1)).bit_length()
    order = np.argsort(shard, kind="stable")
    starts = np.zeros(S, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    within = np.arange(p.size) - np.repeat(starts, counts)
    spages = np.broadcast_to(np.arange(S, dtype=np.int64)[:, None],
                             (S, m)).copy()
    valid = np.zeros((S, m), bool)
    spages[shard[order], within] = p[order]
    valid[shard[order], within] = True
    inv = np.empty(p.size, np.int64)
    inv[order] = shard[order] * m + within
    return spages.astype(np.int32), valid, inv


def owned_mask(shard: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``(S, n)`` bool: row ``s`` flags the batch entries bank ``s`` owns."""
    return shard[None, :] == torch.arange(num_shards,
                                          device=shard.device)[:, None]


def check_geometry(num_rows: int, boundary: int, num_shards: int) -> None:
    """Validate that a (rows, boundary) pair shards evenly over S banks."""
    step = num_shards * GROUP_ROWS
    if num_shards < 1:
        raise ValueError(f"need at least one shard, got {num_shards}")
    if num_rows % step:
        raise ValueError(
            f"num_rows ({num_rows}) must be a multiple of shards*group "
            f"({step})")
    if boundary % step or not 0 <= boundary <= num_rows:
        raise ValueError(
            f"boundary ({boundary}) must be a multiple of {step} in "
            f"[0, {num_rows}]")
