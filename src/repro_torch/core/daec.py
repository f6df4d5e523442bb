"""SEC-DAEC(144,128): the plain PyTorch codec of the rung above SECDED.

Port of ``repro/core/daec.py``. A 128-bit *superbeat* (4 consecutive
words) is split by bit parity into two Hsiao(72,64) codewords: the even
physical bits form codeword A, the odd bits codeword B. An adjacent
double-bit error hits one even and one odd bit — a single error in each
codeword — so both bits are corrected; a double inside one codeword is
Hsiao-detected, never silent. The two 8-bit codes interleave into one
16-bit field (bit 2i = code-A bit i, bit 2i+1 = code-B bit i), two fields
per word, so the packed code plane has exactly the shapes of
:mod:`repro_torch.core.secded` (``(..., D) -> (..., D//8)``) and DAEC rows
share the pool's code lane.

Words are int32 tensors holding uint32 bit patterns; right shifts are the
masked logical shifts of :func:`repro_torch.kernels.common.lsr`. This
module is the plain version the CUDA kernels of
:mod:`repro_torch.kernels.daec` are held against; it runs on any device.
``decode_block`` reports status per 64-bit beat (each superbeat's verdict
broadcast to its two beats), as the SECDED codec's shape does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import secded
from repro_torch.core.secded import (CLEAN, CORRECTED_CODE,  # noqa: F401
                                     CORRECTED_DATA, DETECTED_UNCORRECTABLE)
from repro_torch.kernels.common import lsr

NUM_DATA_BITS = 128
NUM_CODE_BITS = 16
SUPERBEAT_WORDS = 4        # words per superbeat


def _compact_even(x: torch.Tensor) -> torch.Tensor:
    """Gather the 16 even bits of a word into its low half (Morton)."""
    x = x & 0x55555555
    x = (x | lsr(x, 1)) & 0x33333333
    x = (x | lsr(x, 2)) & 0x0F0F0F0F
    x = (x | lsr(x, 4)) & 0x00FF00FF
    x = (x | lsr(x, 8)) & 0x0000FFFF
    return x


def _spread_even(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_compact_even`: low 16 bits -> even positions."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _spread16(v: int) -> int:
    """Host-side 8 -> 16 even-bit spread (H-matrix construction)."""
    v &= 0xFF
    v = (v | (v << 4)) & 0x0F0F
    v = (v | (v << 2)) & 0x3333
    v = (v | (v << 1)) & 0x5555
    return v


def _build_daec_columns() -> np.ndarray:
    """The 144 H-matrix columns in the 16-bit interleaved-syndrome view:
    column ``p < 128`` is the syndrome of data bit ``p`` of the superbeat
    (Hsiao column ``p >> 1`` of codeword A or B, spread to the even or odd
    syndrome bits); columns ``128 + q`` are the 16 check bits."""
    cols = [_spread16(int(secded._COLUMNS[p >> 1])) << (p & 1)
            for p in range(NUM_DATA_BITS)]
    cols += [1 << q for q in range(NUM_CODE_BITS)]
    return np.asarray(cols, dtype=np.uint32)


_COLUMNS = _build_daec_columns()
H_COLUMNS = torch.as_tensor(_COLUMNS.astype(np.int32))


def split_superbeats(data: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(..., 4k) -> (w0, w1, w2, w3) each (..., k): superbeat j = words
    (4j, 4j+1, 4j+2, 4j+3)."""
    if data.shape[-1] % SUPERBEAT_WORDS:
        raise ValueError(f"last dim must be a multiple of 4, got "
                         f"{tuple(data.shape)}")
    g = data.reshape(*data.shape[:-1], data.shape[-1] // SUPERBEAT_WORDS,
                     SUPERBEAT_WORDS)
    return g[..., 0], g[..., 1], g[..., 2], g[..., 3]


def merge_superbeats(w0, w1, w2, w3) -> torch.Tensor:
    """Inverse of :func:`split_superbeats`."""
    return torch.stack([w0, w1, w2, w3], dim=-1).reshape(
        *w0.shape[:-1], w0.shape[-1] * SUPERBEAT_WORDS)


def _deinterleave(w0, w1, w2, w3):
    """Superbeat words -> ((a_lo, a_hi), (b_lo, b_hi)) codeword planes."""
    e = [_compact_even(w) for w in (w0, w1, w2, w3)]
    o = [_compact_even(lsr(w, 1)) for w in (w0, w1, w2, w3)]
    return ((e[0] | (e[1] << 16), e[2] | (e[3] << 16)),
            (o[0] | (o[1] << 16), o[2] | (o[3] << 16)))


def _interleave(a_lo, a_hi, b_lo, b_hi):
    """Codeword planes -> superbeat words (inverse of
    :func:`_deinterleave`)."""
    w0 = _spread_even(a_lo) | (_spread_even(b_lo) << 1)
    w1 = _spread_even(lsr(a_lo, 16)) | (_spread_even(lsr(b_lo, 16)) << 1)
    w2 = _spread_even(a_hi) | (_spread_even(b_hi) << 1)
    w3 = _spread_even(lsr(a_hi, 16)) | (_spread_even(lsr(b_hi, 16)) << 1)
    return w0, w1, w2, w3


def encode_words(w0, w1, w2, w3) -> torch.Tensor:
    """16-bit DAEC code field of superbeats given as 4 word planes, values
    in [0, 65536): bit 2i = codeword-A Hsiao bit i, bit 2i+1 = codeword-B."""
    (a_lo, a_hi), (b_lo, b_hi) = _deinterleave(w0, w1, w2, w3)
    code_a = secded.encode_words(a_lo, a_hi)
    code_b = secded.encode_words(b_lo, b_hi)
    return _spread_even(code_a) | (_spread_even(code_b) << 1)


def decode_words(w0, w1, w2, w3, field) -> tuple[torch.Tensor, ...]:
    """Check + correct superbeats against their 16-bit code fields.

    Returns ``(w0', w1', w2', w3', field', status)`` with one status per
    superbeat: the worse of the two Hsiao verdicts.
    """
    field = field & 0xFFFF
    (a_lo, a_hi), (b_lo, b_hi) = _deinterleave(w0, w1, w2, w3)
    code_a = _compact_even(field)
    code_b = _compact_even(lsr(field, 1))
    a_lo, a_hi, code_a, st_a = secded.decode_words(a_lo, a_hi, code_a)
    b_lo, b_hi, code_b, st_b = secded.decode_words(b_lo, b_hi, code_b)
    w0, w1, w2, w3 = _interleave(a_lo, a_hi, b_lo, b_hi)
    field = _spread_even(code_a) | (_spread_even(code_b) << 1)
    return w0, w1, w2, w3, field, torch.maximum(st_a, st_b)


# ---------------------------------------------------------------------------
# Block-level helpers — shape-identical to repro_torch.core.secded.
# ---------------------------------------------------------------------------


def pack_fields(fields: torch.Tensor) -> torch.Tensor:
    """(..., k) 16-bit values -> (..., k//2) words, 2 per word."""
    if fields.shape[-1] % 2:
        raise ValueError(f"field count must be even, got "
                         f"{tuple(fields.shape)}")
    g = fields.reshape(*fields.shape[:-1], fields.shape[-1] // 2, 2)
    return g[..., 0] | (g[..., 1] << 16)


def unpack_fields(packed: torch.Tensor) -> torch.Tensor:
    """(..., m) words -> (..., 2m) 16-bit values."""
    fields = torch.stack([packed & 0xFFFF, lsr(packed, 16)], dim=-1)
    return fields.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def encode_block(data: torch.Tensor) -> torch.Tensor:
    """(..., D) words, D % 8 == 0 -> (..., D//8) packed DAEC code fields —
    the shape SECDED packs, so the pool's code lane holds either."""
    return pack_fields(encode_words(*split_superbeats(data)))


def decode_block(data: torch.Tensor, packed_fields: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check + correct a block against its packed DAEC code plane ->
    ``(data', packed_fields', status)``, status per 64-bit beat
    ``(..., D//2)`` int32 (each superbeat's verdict on both its beats)."""
    w0, w1, w2, w3, fields, st = decode_words(
        *split_superbeats(data), unpack_fields(packed_fields))
    status = torch.stack([st, st], dim=-1).reshape(*st.shape[:-1],
                                                   st.shape[-1] * 2)
    return merge_superbeats(w0, w1, w2, w3), pack_fields(fields), status
