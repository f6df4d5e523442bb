"""The port's plain Hsiao SECDED(72,64) codec equals the reference bit for bit.

Same numpy inputs through ``repro.core.secded`` (JAX) and
``repro_torch.core.secded`` (PyTorch, on the CPU): the H-matrix tables,
the CUDA header's copy of them, encode over random blocks, and decode over
the enumerations of ``tests/test_codec_conformance.py`` — every single-bit
position (data and code), every adjacent pair, and seeded 2-bit patterns.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import secded as jsec
from repro_torch.core import secded as tsec
from repro_torch.kernels import common

CUH = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / \
    "csrc" / "secded.cuh"


def _t(a: np.ndarray) -> torch.Tensor:
    return common.to_words(np.asarray(a, np.uint32))


def _assert_same(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out, strict=True):
        j = np.asarray(j)
        got = common.to_u32(t) if j.dtype == np.uint32 else t.numpy()
        np.testing.assert_array_equal(got, j)


_jax_decode = jax.jit(jsec.decode_block)


def _decode_both(data: np.ndarray, codes: np.ndarray):
    _assert_same(_jax_decode(jnp.asarray(data), jnp.asarray(codes)),
                 tsec.decode_block(_t(data), _t(codes)))


def _flip(base: np.ndarray, positions) -> np.ndarray:
    """Tile ``base`` (1, W) and XOR one bit per row at global bit positions."""
    pos = np.asarray(positions)
    batch = np.tile(base, (pos.size, 1))
    np.bitwise_xor.at(batch, (np.arange(pos.size), pos // 32),
                      np.uint32(1) << (pos % 32).astype(np.uint32))
    return batch


def _base(seed: int, words: int = 8):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2**32, (1, words), dtype=np.uint32)
    return data, np.asarray(jsec.encode_block(jnp.asarray(data)))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["_COLUMNS", "_SYNDROME_TABLE", "_MASK_LO",
                                  "_MASK_HI"])
def test_h_matrix_tables_equal_reference(name):
    np.testing.assert_array_equal(getattr(tsec, name), getattr(jsec, name))


def test_status_constants_equal_reference():
    for name in ("CLEAN", "CORRECTED_DATA", "CORRECTED_CODE",
                 "DETECTED_UNCORRECTABLE", "NUM_DATA_BITS", "NUM_CODE_BITS"):
        assert getattr(tsec, name) == getattr(jsec, name)


def _cuh_array(name: str) -> list[int]:
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", CUH.read_text(),
                     re.S).group(1)
    return [int(v.rstrip("u"), 0) for v in re.findall(r"-?0x[0-9A-F]+u|-?\d+",
                                                      body)]


@pytest.mark.parametrize("name,ref", [("kMaskLo", "_MASK_LO"),
                                      ("kMaskHi", "_MASK_HI"),
                                      ("kAction", "_SYNDROME_TABLE")])
def test_cuda_header_tables_equal_reference(name, ref):
    """The kernels' constant-memory tables are the reference H-matrix."""
    assert _cuh_array(name) == [int(v) for v in getattr(jsec, ref)]


# ---------------------------------------------------------------------------
# Word helpers and encode
# ---------------------------------------------------------------------------


def test_popcount_and_logical_shift_match_uint32():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint32),
                        np.asarray([0, 1, 2**31, 2**32 - 1], np.uint32)])
    np.testing.assert_array_equal(common.popcount(_t(a)).numpy(),
                                  np.bitwise_count(a).astype(np.int32))
    for s in (0, 1, 7, 16, 31):
        np.testing.assert_array_equal(common.to_u32(common.lsr(_t(a), s)),
                                      a >> np.uint32(s))


@pytest.mark.parametrize("shape", [(1, 8), (16, 64), (3, 2048)])
def test_encode_block_matches(shape):
    rng = np.random.default_rng(shape[1])
    data = rng.integers(0, 2**32, shape, dtype=np.uint32)
    _assert_same([jsec.encode_block(jnp.asarray(data))],
                 [tsec.encode_block(_t(data))])


def test_pack_unpack_match():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (5, 32), dtype=np.uint32)
    packed = np.asarray(jsec.pack_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(common.to_u32(tsec.pack_codes(_t(codes))),
                                  packed)
    np.testing.assert_array_equal(
        common.to_u32(tsec.unpack_codes(_t(packed))), codes)


# ---------------------------------------------------------------------------
# Decode enumerations (tests/test_codec_conformance.py's harness)
# ---------------------------------------------------------------------------


def test_decode_clean_block_matches():
    data, code = _base(0, words=64)
    _decode_both(data, code)


def test_every_single_data_bit():
    data, code = _base(0)
    n = 32 * data.shape[1]
    _decode_both(_flip(data, np.arange(n)), np.tile(code, (n, 1)))


def test_every_single_code_bit():
    data, code = _base(0)
    pos = np.arange(32 * code.shape[1])
    _decode_both(np.tile(data, (pos.size, 1)), _flip(code, pos))


def test_every_adjacent_data_pair():
    data, code = _base(1)
    pos = np.arange(32 * data.shape[1] - 1)
    flipped = _flip(data, pos)
    np.bitwise_xor.at(flipped, (np.arange(pos.size), (pos + 1) // 32),
                      np.uint32(1) << ((pos + 1) % 32).astype(np.uint32))
    _decode_both(flipped, np.tile(code, (pos.size, 1)))


def test_every_adjacent_code_pair():
    data, code = _base(2)
    pos = np.arange(31)
    flipped = _flip(code, pos)
    np.bitwise_xor.at(flipped, (np.arange(pos.size), (pos + 1) // 32),
                      np.uint32(1) << ((pos + 1) % 32).astype(np.uint32))
    _decode_both(np.tile(data, (pos.size, 1)), flipped)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_double_bit_patterns(seed):
    """Seeded random 2-bit patterns over data and code bits together."""
    data, code = _base(3 + seed)
    rng = np.random.default_rng(100 + seed)
    nbits = 32 * (data.shape[1] + code.shape[1])
    pairs = np.asarray([rng.choice(nbits, 2, replace=False)
                        for _ in range(512)])
    block = np.concatenate([data, code], axis=1)
    flipped = _flip(block, pairs[:, 0])
    np.bitwise_xor.at(flipped, (np.arange(len(pairs)), pairs[:, 1] // 32),
                      np.uint32(1) << (pairs[:, 1] % 32).astype(np.uint32))
    w = data.shape[1]
    _decode_both(flipped[:, :w], flipped[:, w:])
