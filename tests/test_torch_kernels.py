"""Each ported kernel's plain version equals the reference's Pallas kernel,
and each wrapper dispatches by the device of its tensors.

The Pallas kernels run as the reference's own tests run them on the CPU
(interpret mode); the port's wrappers take their plain versions for CPU
tensors. Both get the same numpy inputs: random pool words whose SECDED
rows carry valid codes plus planted single data-bit, single code-bit and
same-beat double-bit flips, so every decode status occurs. The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers are checked to refuse any non-CPU tensor rather than fall back,
and to hand the C entry the argument list it declares.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import secded as jsec
from repro.core.layouts import Layout as JLayout
from repro.kernels.migrate import kernel as jmigrate
from repro.kernels.mixed import kernel as jmixed
from repro.kernels.secded import kernel as jsecded
from repro_torch.core.layouts import Layout, extra_base_row, total_pages
from repro_torch.kernels import common
from repro_torch.kernels.hash import ops as hash_ops
from repro_torch.kernels.migrate import ops as migrate_ops
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.scrub import ops as scrub_ops
from repro_torch.kernels.secded import ops as secded_ops

ROWS, W = 32, 64


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _plant_flips(data: np.ndarray, codes: np.ndarray, first: int):
    """Flip, in rows ``first``, ``first+1`` and ``first+2`` of (data, codes):
    one data bit (status 1), one code bit (status 2), and two bits of one
    beat (status 3)."""
    data[first, 5] ^= np.uint32(1 << 3)
    codes[first + 1, 1] ^= np.uint32(1 << 9)
    data[first + 2, 6] ^= np.uint32((1 << 2) | (1 << 9))


def _storage(seed: int, boundary: int) -> np.ndarray:
    """(ROWS, 9, W) random words; rows [boundary, ROWS) carry SECDED codes
    over their data lanes, with flips planted in the first three."""
    rng = np.random.default_rng(seed)
    sto = rng.integers(0, 2**32, (ROWS, 9, W), dtype=np.uint32)
    if boundary < ROWS:
        data = sto[boundary:, :8].reshape(ROWS - boundary, 8 * W)
        codes = np.array(jsec.encode_block(jnp.asarray(data)))
        _plant_flips(data, codes, 0)
        sto[boundary:, :8] = data.reshape(-1, 8, W)
        sto[boundary:, 8] = codes
    return sto


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def test_secded_encode_decode_match_pallas():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2**32, (16, 8 * W), dtype=np.uint32)
    codes = np.array(jsecded.encode(jnp.asarray(data)))
    np.testing.assert_array_equal(
        _u32(secded_ops.encode(common.to_words(data))), codes)
    _plant_flips(data, codes, 4)
    want = jsecded.decode(jnp.asarray(data), jnp.asarray(codes))
    got = secded_ops.decode(common.to_words(data), common.to_words(codes))
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert sorted(np.unique(got[2].numpy()).tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("boundary", [0, 16, ROWS])
@pytest.mark.parametrize("layout", list(Layout))
def test_mixed_read_correct_matches_pallas(layout, boundary):
    sto = _storage(10 + boundary, boundary)
    n_pages = total_pages(layout, boundary, W) + (ROWS - boundary)
    rng = np.random.default_rng(boundary)
    # the flipped SECDED rows, the last page, and a random sample
    ids = np.unique(np.concatenate([
        [boundary, boundary + 1, boundary + 2, n_pages - 1, 0],
        rng.permutation(n_pages)[:7]]))
    ids = rng.permutation(ids[ids < n_pages]).astype(np.int32)
    want = jmixed.read_correct(jnp.asarray(sto), jnp.asarray(ids),
                               JLayout(layout.value), ROWS, boundary)
    got = mixed_ops.read_correct(common.to_words(sto), torch.as_tensor(ids),
                                 layout, ROWS, boundary)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_migrate_gather_encode_matches_pallas():
    sto = _storage(4, ROWS)
    ids = np.asarray([0, ROWS + 3, 8, ROWS, 21, 31, ROWS + 1], np.int32)
    want = jmigrate.gather_encode(jnp.asarray(sto), jnp.asarray(ids), ROWS)
    got = migrate_ops.gather_encode(common.to_words(sto),
                                    torch.as_tensor(ids), ROWS)
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(got[1]), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# Dispatch: plain version only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


CALLS = {
    "secded_encode": lambda: secded_ops.encode(_meta(4, 8 * W)),
    "secded_decode": lambda: secded_ops.decode(_meta(4, 8 * W),
                                               _meta(4, W)),
    "mixed_read_correct": lambda: mixed_ops.read_correct(
        _meta(ROWS, 9, W), _meta(5), Layout.PARITY, ROWS, 16),
    "migrate_gather_encode": lambda: migrate_ops.gather_encode(
        _meta(ROWS, 9, W), _meta(5), ROWS),
    "parity8_encode": lambda: parity8_ops.encode(_meta(4, 8 * W)),
    "parity8_check": lambda: parity8_ops.check(_meta(4, 8 * W),
                                               _meta(4, W // 8)),
    "parity8_write": lambda: parity8_ops.write(
        _meta(ROWS, 9, W), _meta(5), _meta(5, 8 * W), 16),
    "hash_lookup_read": lambda: hash_ops.lookup_read(
        _meta(ROWS, 9, W), _meta(64), _meta(64), _meta(5), Layout.PARITY,
        ROWS, 16, 8),
    "scrub_rows": lambda: scrub_ops.scrub_rows(_meta(ROWS, 9, W)),
}


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    common.LAUNCHES.clear()
    data = common.to_words(np.arange(8 * W * 2, dtype=np.uint32)
                           .reshape(2, 8 * W))
    secded_ops.decode(data, secded_ops.encode(data))
    sto = common.to_words(_storage(0, 16))
    mixed_ops.read_correct(sto, torch.arange(4), Layout.INTERWRAP, ROWS, 16)
    migrate_ops.gather_encode(sto, torch.arange(4), ROWS)
    parity8_ops.check(data, parity8_ops.encode(data))
    parity8_ops.write(sto.clone(), torch.arange(2), data, 16)
    hash_ops.lookup_read(sto, torch.arange(64, dtype=torch.int32),
                         torch.arange(64, dtype=torch.int32),
                         torch.arange(4, dtype=torch.int32),
                         Layout.INTERWRAP, ROWS, 16, 8)
    scrub_ops.scrub_rows(sto)
    assert sum(common.LAUNCHES.values()) == 0


def _strided(*shape) -> torch.Tensor:
    """A CPU view with a row stride, as a pool slice gives."""
    return torch.zeros((*shape[:-1], shape[-1] + 8), dtype=torch.int32)[
        ..., :shape[-1]]


STRIDED = {
    "secded_encode": lambda: secded_ops.encode(_strided(4, 8 * W)),
    "secded_decode": lambda: secded_ops.decode(
        torch.zeros((4, 8 * W), dtype=torch.int32), _strided(4, W)),
    "mixed_read_correct": lambda: mixed_ops.read_correct(
        _strided(ROWS, 9, W), torch.arange(2), Layout.INTERWRAP, ROWS, 16),
    "migrate_gather_encode": lambda: migrate_ops.gather_encode(
        _strided(ROWS, 9, W), torch.arange(2), ROWS),
    "parity8_encode": lambda: parity8_ops.encode(_strided(4, 8 * W)),
    "parity8_check": lambda: parity8_ops.check(
        _strided(4, 8 * W), torch.zeros((4, W // 8), dtype=torch.int32)),
    "parity8_write": lambda: parity8_ops.write(
        torch.zeros((ROWS, 9, W), dtype=torch.int32), torch.arange(2),
        _strided(2, 8 * W), 16),
    "hash_lookup_read": lambda: hash_ops.lookup_read(
        torch.zeros((ROWS, 9, W), dtype=torch.int32),
        torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32)[::2], Layout.INTERWRAP, ROWS, 16,
        8),
    "scrub_rows": lambda: scrub_ops.scrub_rows(_strided(ROWS, 9, W)),
}


@pytest.mark.parametrize("name", list(STRIDED))
def test_strided_views_are_refused_on_the_cpu_too(name):
    """The kernels take contiguous operands only; the wrappers refuse a
    strided view before dispatching, so the CPU path cannot accept what
    the card would refuse."""
    assert set(STRIDED) == set(CALLS)
    with pytest.raises(ValueError, match="contiguous"):
        STRIDED[name]()


@pytest.mark.parametrize("name", list(CALLS))
def test_non_cpu_tensors_never_fall_back(name):
    """A tensor off the CPU goes to the kernel or raises — here, with no
    card, it must raise before anything is built or launched."""
    with pytest.raises(ValueError, match="CUDA device"):
        CALLS[name]()


@pytest.mark.parametrize("name", list(CALLS))
def test_wrappers_marshal_the_declared_c_arguments(name, monkeypatch):
    """With the device checks lifted, each wrapper calls its C entry with
    exactly the arguments ``ENTRIES`` declares (the stream comes last)."""
    seen = []
    monkeypatch.setattr(common, "check_cuda_words", lambda *a, **k: None)
    monkeypatch.setattr(common, "launch",
                        lambda entry, *args: seen.append((entry, args)))
    CALLS[name]()
    [(entry, args)] = seen
    assert entry == name
    declared = common.ENTRIES[name]
    assert len(args) + 1 == len(declared)
    for i, (arg, ctype) in enumerate(zip(args, declared)):
        if name == "mixed_read_correct" and i == 3:   # no status asked
            assert arg is None
            continue
        want = torch.Tensor if ctype is common.ctypes.c_void_p else int
        assert isinstance(arg, want), (entry, arg)
    if name == "mixed_read_correct":  # status, n, W, interwrap, rows, b, ebase
        assert args[3:] == (None, 5, W, 0, ROWS, 16,
                            extra_base_row(Layout.PARITY, 16, W))
    if name == "hash_lookup_read":   # n, W, C, probe, interwrap, rows, b, ebase
        assert args[5:] == (5, W, 64, 8, 0, ROWS, 16,
                            extra_base_row(Layout.PARITY, 16, W))
    if name in ("parity8_encode", "parity8_check"):   # 16-byte vectors
        assert args[-1] == 4 * 8 * W // 4
    if name == "parity8_write":    # n, W, rows, boundary, ebase, tables
        assert args[1].dtype == torch.int64    # the kernel reads int64 ids
        assert args[3:] == (5, W, ROWS, 16,
                            extra_base_row(Layout.PARITY, 16, W), 2)
    if name == "scrub_rows":               # packed code words, W
        assert args[3:] == (ROWS * W, W)
