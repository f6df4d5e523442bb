"""8-bit interleaved parity per 64-byte line — the paper's detection-only code.

Port of ``repro/core/parity8.py``. Detection-only regions store an 8-bit
parity code per 64B line (bit *i* of the parity byte = XOR of all data bits
congruent to *i* mod 8), at a 1/64 storage cost. A line is 16 consecutive
words; its parity byte is the XOR of its 64 bytes, folded from the XOR of
its 16 words.

Words are int32 tensors holding uint32 bit patterns. This module is the
plain version the CUDA kernels of :mod:`repro_torch.kernels.parity8` are
held against; it runs on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.secded import pack_codes, unpack_codes
from repro_torch.kernels.common import lsr

WORDS_PER_LINE = 16  # 64 bytes
LINE_OK = 0
LINE_CORRUPT = 1


def _fold_byte(word: torch.Tensor) -> torch.Tensor:
    """XOR-fold a word to the XOR of its four bytes."""
    word = word ^ lsr(word, 16)
    word = word ^ lsr(word, 8)
    return word & 0xFF


def encode_lines(data: torch.Tensor) -> torch.Tensor:
    """(..., 16k) words -> (..., k) parity bytes."""
    if data.shape[-1] % WORDS_PER_LINE:
        raise ValueError(
            f"last dim must be a multiple of 16, got {tuple(data.shape)}")
    folded = data.reshape(*data.shape[:-1], data.shape[-1] // WORDS_PER_LINE,
                          WORDS_PER_LINE)
    while folded.shape[-1] > 1:          # XOR tree over the line's words
        half = folded.shape[-1] // 2
        folded = folded[..., :half] ^ folded[..., half:]
    return _fold_byte(folded[..., 0])


def check_lines(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """Per-line status (..., k) int32: LINE_OK or LINE_CORRUPT (detection
    only — no repair) of (..., 16k) words against stored parity bytes."""
    bad = (encode_lines(data) ^ (parity & 0xFF)) != 0
    return bad.to(torch.int32)


def encode_lines_packed(data: torch.Tensor) -> torch.Tensor:
    """Parity bytes packed 4 per word (chip-8 storage format):
    (..., 16k) -> (..., k//4), k % 4 == 0."""
    return pack_codes(encode_lines(data))


def check_lines_packed(data: torch.Tensor,
                       packed_parity: torch.Tensor) -> torch.Tensor:
    """Per-line status against packed parity: (..., 16k), (..., k//4) ->
    (..., k)."""
    return check_lines(data, unpack_codes(packed_parity))
