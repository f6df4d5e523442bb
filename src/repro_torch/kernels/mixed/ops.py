"""Fused mixed-pool reads: the dispatching wrappers.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches
the kernel in ``csrc/mixed.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row)
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ref


def read_correct(storage: torch.Tensor, pages: torch.Tensor, layout: Layout,
                 num_rows: int, boundary: int, status: bool = False):
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
            or storage.shape[0] != num_rows or storage.shape[2] % 8:
        raise ValueError(f"expected ({num_rows}, 9, W) storage with W % 8 "
                         f"== 0, got {tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct(storage, pages, layout, num_rows, boundary,
                                status=status)
    W = storage.shape[2]
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct", storage, pages)
    n = pages.shape[0]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    st = torch.zeros((n,), dtype=torch.int32, device=storage.device) \
        if status else None
    if n:
        common.launch("mixed_read_correct", storage, pages, out, st, n, W,
                      int(layout == Layout.INTERWRAP), num_rows, boundary,
                      extra_base_row(layout, boundary, W))
    return (out, st) if status else out


def read_correct_routed(storage: torch.Tensor, pages: torch.Tensor,
                        layout: Layout, num_rows: int, boundary: int,
                        num_shards: int, status: bool = False):
    """Router-fused read of global page ids from ``(S, R_local, 9, W)``
    banks -> ``(n, 8W)`` corrected page data, each page from its own bank,
    in one launch; with ``status=True`` also each page's worst SECDED
    decode status ``(n,)`` int32 from the same launch (as
    :func:`read_correct`'s) -> ``(data, status)``.

    ``num_rows`` / ``boundary`` are the global geometry (``S * R_local``,
    ``S * b_local``). Page ids must be in range (the pool validates them
    on the host); the kernel clamps banks and rows all the same. A banks
    mesh reads with the shard-local form, :func:`read_correct_routed_local`.
    """
    S = num_shards
    if storage.dim() != 4 or storage.shape[0] != S \
            or storage.shape[2] != LANES or S * storage.shape[1] != num_rows \
            or storage.shape[3] % 8:
        raise ValueError(f"expected ({S}, {num_rows // max(S, 1)}, 9, W) "
                         f"storage with W % 8 == 0, got "
                         f"{tuple(storage.shape)}")
    if boundary % S:
        raise ValueError(f"boundary {boundary} must split over {S} banks")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct_routed", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct_routed(storage, pages, layout, num_rows,
                                       boundary, S, status=status)
    W = storage.shape[3]
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct_routed", storage, pages)
    n = pages.shape[0]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    st = torch.zeros((n,), dtype=torch.int32, device=storage.device) \
        if status else None
    if n:
        b_local = boundary // S
        common.launch("mixed_read_correct_routed", storage, pages, out, st,
                      n, W, int(layout == Layout.INTERWRAP), num_rows, S,
                      b_local, extra_base_row(layout, b_local, W))
    return (out, st) if status else out


def read_correct_routed_local(bank: torch.Tensor, pages: torch.Tensor,
                              layout: Layout, num_rows: int, boundary: int,
                              num_shards: int, shard_id: int,
                              status: bool = False,
                              out: torch.Tensor | None = None):
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
            or S * bank.shape[0] != num_rows or bank.shape[2] % 8:
        raise ValueError(f"expected one ({num_rows // max(S, 1)}, 9, W) "
                         f"bank with W % 8 == 0, got {tuple(bank.shape)}")
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
    common.check_cuda_words("mixed_read_correct_routed_local", bank, pages,
                            out)
    if status:
        st.zero_()
    if n:
        b_local = boundary // S
        common.launch("mixed_read_correct_routed_local", bank, pages, data,
                      st, n, W, int(layout == Layout.INTERWRAP), num_rows, S,
                      b_local, extra_base_row(layout, b_local, W), shard_id)
    return (data, st) if status else data
