"""Hsiao SECDED(72,64), frozen for the benchmark's reference.

A copy of the plain codec of the program's ``core/secded.py`` as it stood
when the benchmark was written, kept here so that the reference never
imports the program. 64 data bits travel as a pair of consecutive 32-bit
words ``(lo, hi)`` (one beat); the 8 check bits are each the parity of an
odd-weight subset of the data bits (56 weight-3 and 8 weight-5 columns).
Codes are packed 4 to a word, low byte first. Words are int32 tensors that
hold uint32 bit patterns.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

NUM_CODE_BITS = 8


def _columns() -> list[int]:
    cols: list[int] = []
    for weight in (3, 5):
        for combo in combinations(range(NUM_CODE_BITS), weight):
            if len(cols) == 64:
                break
            cols.append(sum(1 << b for b in combo))
    return cols


_COLS = _columns()
_TABLE = np.full(256, -2, dtype=np.int32)    # -1 clean, 0..63 data bit,
_TABLE[0] = -1                               # 64..71 code bit, -2 detected
for _i, _c in enumerate(_COLS):
    _TABLE[_c] = _i
for _p in range(NUM_CODE_BITS):
    _TABLE[1 << _p] = 64 + _p


def _s32(u: int) -> int:
    return u - (1 << 32) if u >= 1 << 31 else u


def _masks() -> list[tuple[int, int]]:
    out = []
    for p in range(NUM_CODE_BITS):
        lo = sum(1 << i for i, c in enumerate(_COLS[:32]) if (c >> p) & 1)
        hi = sum(1 << i for i, c in enumerate(_COLS[32:]) if (c >> p) & 1)
        out.append((_s32(lo), _s32(hi)))
    return out


MASKS = _masks()


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    return x if s == 0 else (x >> s) & ((1 << (32 - s)) - 1)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x - (_lsr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (_lsr(x, 2) & 0x33333333)
    x = (x + _lsr(x, 4)) & 0x0F0F0F0F
    x = x + _lsr(x, 8)
    x = x + _lsr(x, 16)
    return x & 0x3F


def encode_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Check byte of each beat ``(lo, hi)``."""
    code = torch.zeros_like(lo)
    for p, (mlo, mhi) in enumerate(MASKS):
        code = code | ((_popcount((lo & mlo) ^ (hi & mhi)) & 1) << p)
    return code


def encode_block(data: torch.Tensor) -> torch.Tensor:
    """(..., 2k) words -> (..., k // 4) packed check bytes."""
    pairs = data.reshape(*data.shape[:-1], -1, 2)
    codes = encode_words(pairs[..., 0], pairs[..., 1])
    g = codes.reshape(*codes.shape[:-1], -1, 4)
    return g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)


def decode_block(data: torch.Tensor, packed: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Correct ``data`` (..., 2k) against its packed codes (..., k // 4):
    ``(data', status)``, status per beat: 0 clean, 1 a data bit corrected,
    2 a code bit corrected, 3 detected and left as it was."""
    pairs = data.reshape(*data.shape[:-1], -1, 2)
    lo, hi = pairs[..., 0], pairs[..., 1]
    codes = torch.stack([_lsr(packed, 8 * j) & 0xFF for j in range(4)],
                        dim=-1).reshape(lo.shape)
    syndrome = (encode_words(lo, hi) ^ codes) & 0xFF
    action = torch.as_tensor(_TABLE, device=data.device)[syndrome.long()]
    is_data = (action >= 0) & (action < 64)
    bit = torch.where(is_data, action, 0)
    one = torch.ones_like(lo)
    lo = lo ^ torch.where(is_data & (bit < 32), one << (bit & 31), 0)
    hi = hi ^ torch.where(is_data & (bit >= 32), one << (bit & 31), 0)
    status = torch.where(action == -1, 0, torch.where(
        is_data, 1, torch.where(action >= 64, 2, 3)))
    return torch.stack([lo, hi], dim=-1).reshape(data.shape), status.int()
