"""Paged decode attention: the dispatching wrapper.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel in ``csrc/paged_decode.cu`` or raise. There is no fallback. On the
card one call is one launch of ``paged_decode`` (its C entry also runs
the combine pass when the keys are split into several chunks).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import common
from repro_torch.kernels.paged_decode import ref

#: head dimensions the kernel is built for: those of the configs the
#: engine serves on the card (olmoe-1b-7b, starcoder2-7b, qwen3-0.6b 128;
#: musicgen-large 64; the smoke reductions 16)
HEAD_DIMS = (16, 64, 128)
#: keys a block takes per step at head dim D (csrc Geo<D>::TILE: 4 warps of
#: 32 / (D/4) lane groups, 4 keys each)
TILE_KEYS = 2048
#: blocks of padded keys per SM the split aims at: slots attend to a share
#: of S_pad, and blocks past a slot's length return at once
BLOCKS_PER_SM = 16


def _on_one_card(tensors) -> None:
    dev = tensors[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError("paged_decode: operands must share one CUDA device")


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split(b: int, hkv: int, s_pad: int, d: int, sms: int) -> tuple[int, int]:
    """(keys per chunk, chunks) for B·Hkv (slot, KV head) pairs over S_pad
    positions on ``sms`` SMs: about BLOCKS_PER_SM blocks of the padded
    keys per SM, whole steps of a block, one chunk at most S_pad."""
    tile = TILE_KEYS // d
    per = common.ceil_div(b * hkv * s_pad, BLOCKS_PER_SM * sms)
    chunk = min(common.round_up(max(per, 1), tile),
                common.round_up(s_pad, tile))
    return chunk, common.ceil_div(s_pad, chunk)


def attend(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
           cache_len: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """One decode step's attention over paged K/V -> (B, Hq, D) float32.

    q (B, Hq, D); k_new, v_new (B, Hkv, D), the step's new token, which
    takes position ``cache_len[b]`` (none once it has reached S_pad);
    cache_len (B,); k, v (B, n_blk, bt, Hkv, D) views of S_pad = n_blk·bt
    positions, of which ``[0, cache_len]`` are attended. Query head h
    attends with KV head ``h // (Hq/Hkv)``; scale 1/sqrt(D), softmax and
    sums in float32. On the card: float32 operands, int32 ``cache_len``,
    D in :data:`HEAD_DIMS`, any Hq/Hkv; K and V share their strides,
    with Hkv·D contiguous and every stride a multiple of 4, and positions
    past ``cache_len`` are never read.
    """
    if q.dim() != 3 or k_new.dim() != 3 or k.dim() != 5:
        raise ValueError("expected q (B, Hq, D), k_new / v_new (B, Hkv, D) "
                         "and k / v (B, n_blk, bt, Hkv, D)")
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    if (k_new.shape != v_new.shape or k.shape != v.shape
            or k_new.shape != (b, hkv, d) or k.shape[0] != b
            or k.shape[3:] != (hkv, d) or cache_len.shape != (b,)
            or hkv == 0 or hq % hkv):
        raise ValueError(
            f"paged_decode: q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
            f"k {tuple(k.shape)} and cache_len {tuple(cache_len.shape)} do "
            "not form one grouped-query decode step")
    tensors = (q, k_new, v_new, cache_len, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.attend(q, k_new, v_new, cache_len, k, v)
    _on_one_card(tensors)
    if any(t.dtype != torch.float32 for t in (q, k_new, v_new, k, v)):
        raise TypeError("paged_decode: q, k_new, v_new, k and v must be "
                        "float32")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"paged_decode: cache_len must be int32, got "
                        f"{cache_len.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {d} not in {HEAD_DIMS}")
    _, n_blk, bt = k.shape[:3]
    if n_blk * bt == 0:
        raise ValueError("paged_decode: K/V hold no position")
    common.check_contiguous("paged_decode", q, k_new, v_new, cache_len)
    if k.stride() != v.stride() or k.stride(4) != 1 or (
            hkv > 1 and k.stride(3) != d):
        raise ValueError("paged_decode: K and V must share their strides, "
                         "with (Hkv, D) contiguous")
    if any(s % 4 for s in k.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (q, k_new, v_new, k, v)):
        raise ValueError("paged_decode: K/V strides must be multiples of 4 "
                         "and every operand 16-byte aligned")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if b == 0 or hq == 0:
        return out
    s_pad = n_blk * bt
    chunk, n_chunks = split(b, hkv, s_pad, d, _sms(q.device))
    part_acc = part_ml = None
    if n_chunks > 1:
        part_acc = torch.empty((b, hq, n_chunks, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hq, n_chunks, 2), dtype=torch.float32,
                              device=q.device)
    sb, sn, st = k.stride()[:3]
    common.launch("paged_decode", q, k_new, v_new, cache_len, k, v, out,
                  part_acc, part_ml, b, hkv, hq // hkv, d, s_pad, bt, sb,
                  sn, st, chunk, n_chunks, math.log2(math.e) / math.sqrt(d))
    return out
