"""Fused mixed-pool reads: the dispatching wrappers.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches
the kernel in ``csrc/mixed.cu`` or raises. There is no fallback. Any row
width W runs: at ``W % 8 == 0`` the vector entry, else its word-granular
entry (:func:`~repro_torch.kernels.common.launch_for_width`). An empty id
vector returns empty results on both devices and launches nothing.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row)
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ref

if TYPE_CHECKING:      # core/ and objcache/ import the kernels
    from repro_torch.core.pool import PoolState


def _empty(storage: torch.Tensor, W: int, status: bool):
    """The result of a read of no pages: ``(0, 8W)`` data, and with
    ``status`` a ``(0,)`` status, on the storage's device."""
    data = common.empty_words(storage, 0, DATA_LANES * W)
    return (data, common.empty_words(storage, 0)) if status else data


def read_correct(storage: torch.Tensor, pages: torch.Tensor, layout: Layout,
                 num_rows: int, boundary: int, status: bool = False,
                 *, use_kernel: bool | None = None):
    """(R, 9, W) pool, (n,) page ids -> (n, 8W) corrected page data, and
    with ``status=True`` also each page's worst SECDED decode status
    ``(n,)`` int32 (0 clean, 1/2 corrected, 3 detected uncorrectable; 0
    outside the SECDED region) -> ``(data, status)``.

    Page ids must be in range (the pool validates them on the host); the
    kernel clamps rows into the pool all the same, so a stray id can never
    read outside the storage. On the card the status comes out of the same
    launch: the wrapper zeroes it first (one fill), since the page's eight
    slice blocks combine their statuses with ``atomicMax``.
    """
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows:
        raise ValueError(f"expected ({num_rows}, 9, W) storage, got "
                         f"{tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct", storage, pages)
    W, n = storage.shape[2], pages.shape[0]
    if n == 0:
        return _empty(storage, W, status)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct(storage, pages, layout, num_rows, boundary,
                                status=status)
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct", storage, pages, W=W)
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    st = torch.zeros((n,), dtype=torch.int32, device=storage.device) \
        if status else None
    common.launch_for_width("mixed_read_correct", W, storage, pages, out, st,
                            n, W, int(layout == Layout.INTERWRAP), num_rows,
                            boundary, extra_base_row(layout, boundary, W))
    return (out, st) if status else out


def read_correct_routed(storage: torch.Tensor, pages: torch.Tensor,
                        layout: Layout, num_rows: int, boundary: int,
                        num_shards: int, shard_id: int | None = None,
                        status: bool = False,
                        *, use_kernel: bool | None = None):
    """Router-fused read of global page ids from ``(S, R_local, 9, W)``
    banks -> ``(n, 8W)`` corrected page data, each page from its own bank,
    in one launch; with ``status=True`` also each page's worst SECDED
    decode status ``(n,)`` int32 from the same launch (as
    :func:`read_correct`'s) -> ``(data, status)``.

    ``num_rows`` / ``boundary`` are the global geometry (``S * R_local``,
    ``S * b_local``). Page ids must be in range (the pool validates them
    on the host); the kernel clamps banks and rows all the same. An
    integer ``shard_id`` with one bank's ``(R_local, 9, W)`` storage is
    the reference's one-bank contract: :func:`read_correct_routed_local`,
    the other banks' rows zero (a banks mesh reads this way).
    """
    if shard_id is not None:
        return read_correct_routed_local(storage, pages, layout, num_rows,
                                         boundary, num_shards, shard_id,
                                         status=status)
    S = num_shards
    if storage.dim() != 4 or storage.shape[0] != S \
            or storage.shape[2] != LANES or S * storage.shape[1] != num_rows:
        raise ValueError(f"expected ({S}, {num_rows // max(S, 1)}, 9, W) "
                         f"storage, got {tuple(storage.shape)}")
    if boundary % S:
        raise ValueError(f"boundary {boundary} must split over {S} banks")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct_routed", storage, pages)
    W, n = storage.shape[3], pages.shape[0]
    if n == 0:
        return _empty(storage, W, status)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct_routed(storage, pages, layout, num_rows,
                                       boundary, S, status=status)
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct_routed", storage, pages,
                            W=W)
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    st = torch.zeros((n,), dtype=torch.int32, device=storage.device) \
        if status else None
    b_local = boundary // S
    common.launch_for_width("mixed_read_correct_routed", W, storage, pages,
                            out, st, n, W, int(layout == Layout.INTERWRAP),
                            num_rows, S, b_local,
                            extra_base_row(layout, b_local, W))
    return (out, st) if status else out


def read_correct_routed_local(bank: torch.Tensor, pages: torch.Tensor,
                              layout: Layout, num_rows: int, boundary: int,
                              num_shards: int, shard_id: int,
                              status: bool = False,
                              out: torch.Tensor | None = None,
                              *, use_kernel: bool | None = None):
    """Shard-local router-fused read: bank ``shard_id``'s ``(R_local, 9,
    W)`` storage, ``(n,)`` global page ids -> ``(n, 8W)`` data whose rows
    of the pages other banks own are zero, and with ``status=True`` their
    statuses 0 -> ``(data, status)``. The TPU kernel's contract
    (``repro/kernels/mixed/kernel.py`` ``read_correct_routed``): an int32
    SUM all-reduce of every bank's output over a banks mesh is the
    assembled batch, as the reference's ``psum``.

    ``out`` (optional): a contiguous int32 buffer of ``n * 8W`` words, and
    ``n`` more with ``status``, that receives the data and then the
    status, so that one collective reduces both; the results are views of
    it. On the card one ``mixed_read_correct_routed_local`` launch.
    """
    S = num_shards
    if bank.dim() != 3 or bank.shape[1] != LANES \
            or S * bank.shape[0] != num_rows:
        raise ValueError(f"expected one ({num_rows // max(S, 1)}, 9, W) "
                         f"bank, got {tuple(bank.shape)}")
    if boundary % S:
        raise ValueError(f"boundary {boundary} must split over {S} banks")
    if not 0 <= shard_id < S:
        raise ValueError(f"shard_id {shard_id} outside [0, {S})")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    W, n = bank.shape[2], pages.shape[0]
    words = n * DATA_LANES * W
    if out is not None and (out.dim() != 1 or out.dtype != torch.int32
                            or out.numel() != words + n * int(status)
                            or out.device != bank.device):
        raise ValueError(f"out must be {words + n * int(status)} int32 "
                         f"words on {bank.device}")
    common.check_contiguous("mixed_read_correct_routed_local", bank, pages,
                            *(() if out is None else (out,)))
    if out is None:
        out = torch.empty(words + n * int(status), dtype=torch.int32,
                          device=bank.device)
    data = out[:words].view(n, DATA_LANES * W)
    st = out[words:] if status else None
    if n == 0:
        return (data, st) if status else data
    if bank.device.type == "cpu" and pages.device.type == "cpu":
        got = ref.read_correct_routed_local(bank, pages, layout, num_rows,
                                            boundary, S, shard_id,
                                            status=status)
        if status:
            data.copy_(got[0])
            st.copy_(got[1])
        else:
            data.copy_(got)
        return (data, st) if status else data
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct_routed_local", out, bank,
                            pages, W=W)
    # both entries store vectors into ``out``, at any W
    common.check_words("mixed_read_correct_routed_local", out)
    if status:
        st.zero_()
    b_local = boundary // S
    common.launch_for_width("mixed_read_correct_routed_local", W, bank,
                            pages, data, st, n, W,
                            int(layout == Layout.INTERWRAP), num_rows, S,
                            b_local, extra_base_row(layout, b_local, W),
                            shard_id)
    return (data, st) if status else data


def read_pool(state: PoolState, pages: torch.Tensor, *,
              use_kernel: bool | None = None) -> torch.Tensor:
    """:func:`read_correct` of a :class:`~repro_torch.core.pool.PoolState`'s
    storage and geometry."""
    return read_correct(state.storage, pages, state.layout, state.num_rows,
                        state.boundary)
