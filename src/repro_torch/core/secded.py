"""Hsiao SECDED(72,64) — the plain PyTorch codec stored on "chip 8".

Port of ``repro/core/secded.py``. 64 data bits travel as a pair of
consecutive 32-bit words ``(lo, hi)`` (one beat); the 8 check bits are each
the parity of an odd-weight subset of data bits. H's columns are 56
weight-3 and 8 weight-5 vectors, so a single-bit error's syndrome is its
column (corrected) and any double error gives a nonzero even-weight
syndrome (detected, never miscorrected).

Words are int32 tensors holding uint32 bit patterns. This module is the
plain version the CUDA kernels of :mod:`repro_torch.kernels.secded` are
held against; it runs on any device.
"""
from __future__ import annotations

import functools
from itertools import combinations

import numpy as np
import torch

from repro_torch.kernels.common import lsr, popcount, s32

NUM_DATA_BITS = 64
NUM_CODE_BITS = 8

# Per-beat decode status codes.
CLEAN = 0                     # syndrome zero — no error
CORRECTED_DATA = 1            # single-bit error in the data bits, corrected
CORRECTED_CODE = 2            # single-bit error in the code bits, corrected
DETECTED_UNCORRECTABLE = 3    # even-weight / unmatched syndrome — ≥2 bit errors


def _build_hsiao_code() -> tuple[np.ndarray, np.ndarray]:
    """H-matrix data columns and the 256-entry syndrome -> action table.

    Returns ``columns`` (64,) uint16 — the syndrome of an error in data bit
    i — and ``table`` (256,) int32: -1 clean, 0..63 flip data bit, 64..71
    flip code bit (value - 64), -2 detected uncorrectable.
    """
    cols: list[int] = []
    for weight in (3, 5):
        for combo in combinations(range(NUM_CODE_BITS), weight):
            if len(cols) == NUM_DATA_BITS:
                break
            cols.append(sum(1 << b for b in combo))
    if len(set(cols)) != NUM_DATA_BITS:
        raise AssertionError("Hsiao columns must be 64 distinct vectors")
    table = np.full(256, -2, dtype=np.int32)
    table[0] = -1
    for i, col in enumerate(cols):
        table[col] = i
    for p in range(NUM_CODE_BITS):
        table[1 << p] = 64 + p
    return np.asarray(cols, dtype=np.uint16), table


_COLUMNS, _SYNDROME_TABLE = _build_hsiao_code()

# Per-parity-bit masks over the 64 data bits, split into the (lo, hi) words.
_MASK_LO = np.zeros(NUM_CODE_BITS, dtype=np.uint32)
_MASK_HI = np.zeros(NUM_CODE_BITS, dtype=np.uint32)
for _i, _col in enumerate(_COLUMNS):
    for _p in range(NUM_CODE_BITS):
        if (int(_col) >> _p) & 1:
            if _i < 32:
                _MASK_LO[_p] |= np.uint32(1 << _i)
            else:
                _MASK_HI[_p] |= np.uint32(1 << (_i - 32))

# the masks as int32 scalars (same bits) for tensor & tensor-free use
MASKS = [(s32(int(_MASK_LO[p])), s32(int(_MASK_HI[p])))
         for p in range(NUM_CODE_BITS)]

# The reference's public tables, as int32 CPU tensors holding the same bits
# (``.numpy().view(np.uint32)`` gives the reference's uint32 masks).
MASK_LO = torch.from_numpy(_MASK_LO.view(np.int32).copy())
MASK_HI = torch.from_numpy(_MASK_HI.view(np.int32).copy())
SYNDROME_TABLE = torch.from_numpy(_SYNDROME_TABLE.copy())
H_COLUMNS = torch.from_numpy(_COLUMNS.astype(np.int32))


@functools.cache
def _action_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_SYNDROME_TABLE, device=device)


def encode_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """SECDED code for beats given as two int32 planes -> codes in [0, 256).

    popc(lo & m) + popc(hi & m') has the parity of popc((lo & m) ^ (hi & m')),
    so one SWAR popcount per check bit suffices.
    """
    code = torch.zeros_like(lo)
    for p, (mlo, mhi) in enumerate(MASKS):
        ones = popcount((lo & mlo) ^ (hi & mhi))
        code = code | ((ones & 1) << p)
    return code


def decode_words(lo: torch.Tensor, hi: torch.Tensor, code: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Check + correct beats against their stored codes.

    Returns ``(lo', hi', code', status)`` with status in {CLEAN,
    CORRECTED_DATA, CORRECTED_CODE, DETECTED_UNCORRECTABLE} per beat.
    """
    code = code & 0xFF
    syndrome = (encode_words(lo, hi) ^ code) & 0xFF
    action = _action_table(lo.device)[syndrome.long()]
    is_data = (action >= 0) & (action < 64)
    is_code = action >= 64
    bit = torch.where(action >= 0, action, 0)
    one = torch.ones_like(lo)
    flip_lo = torch.where(is_data & (bit < 32), one << (bit & 31), 0)
    flip_hi = torch.where(is_data & (bit >= 32), one << (bit & 31), 0)
    flip_code = torch.where(is_code, one << ((bit - 64) & 7), 0)
    status = torch.where(
        action == -1, CLEAN,
        torch.where(is_data, CORRECTED_DATA,
                    torch.where(is_code, CORRECTED_CODE,
                                DETECTED_UNCORRECTABLE))).to(torch.int32)
    return lo ^ flip_lo, hi ^ flip_hi, code ^ flip_code, status


# ---------------------------------------------------------------------------
# Block-level helpers: beats are pairs of consecutive words; codes are packed
# 4 per word, low byte first ("chip 8" storage format).
# ---------------------------------------------------------------------------


def split_beats(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2k) -> (lo, hi) each (..., k): beat j = words (2j, 2j+1)."""
    if data.shape[-1] % 2:
        raise ValueError(f"last dim must be even, got {tuple(data.shape)}")
    pairs = data.reshape(*data.shape[:-1], data.shape[-1] // 2, 2)
    return pairs[..., 0], pairs[..., 1]


def merge_beats(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_beats`."""
    return torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1],
                                                 lo.shape[-1] * 2)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., k) byte values -> (..., k//4) words, 4 codes per word."""
    if codes.shape[-1] % 4:
        raise ValueError(
            f"code count must be divisible by 4, got {tuple(codes.shape)}")
    g = codes.reshape(*codes.shape[:-1], codes.shape[-1] // 4, 4)
    return g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., m) words -> (..., 4m) byte values."""
    codes = torch.stack([lsr(packed, 8 * j) & 0xFF for j in range(4)], dim=-1)
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def encode_block(data: torch.Tensor) -> torch.Tensor:
    """(..., 2k) words, k % 4 == 0 -> (..., k//4) packed codes (8:1)."""
    lo, hi = split_beats(data)
    return pack_codes(encode_words(lo, hi))


def decode_block(data: torch.Tensor, packed_codes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check + correct a block against its packed codes.

    Returns ``(data', packed_codes', status)``; status is per beat
    ``(..., k)`` int32.
    """
    lo, hi = split_beats(data)
    codes = unpack_codes(packed_codes)
    lo2, hi2, codes2, status = decode_words(lo, hi, codes)
    return merge_beats(lo2, hi2), pack_codes(codes2), status
