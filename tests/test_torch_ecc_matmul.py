"""The SECDED decode-on-load matrix product equals the reference.

The same numpy weights go through the reference (its plain version and
its Pallas kernel in interpret mode) and the port's wrapper, which takes
its plain version on the CPU; one bit of a protected weight word is
flipped. The CUDA kernel runs on the card only (``chip_smoke.py``); here
the wrapper is checked to refuse a non-CPU tensor rather than fall back,
and to hand the C entry of the design it picks by N the declared
arguments, counting one launch either way.

Tolerances: ``protect`` / ``unprotect`` are bit-exact; the product
matches the reference within 1e-5 of the output's scale (its largest
magnitude) — both sum exact bf16 x bf16 products in float32, in another
order — and the product of the corrupted words equals the product of the
clean ones exactly (the correction restores A bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ecc_matmul import kernel as jkernel
from repro.kernels.ecc_matmul import ref as jref
from repro_torch.kernels import common
from repro_torch.kernels.ecc_matmul import ops, ref

#: the last two are ragged: no dimension of (200, 208, 1001) fits a tile
#: or a TMA stride, and (3, 16, 4) is one code word a row
SHAPES = [(64, 128, 64), (128, 256, 128), (256, 512, 128), (48, 32, 5),
          (200, 208, 1001), (3, 16, 4)]


def _bf16_torch(a: jnp.ndarray) -> torch.Tensor:
    """A JAX bf16 array -> the torch bf16 tensor of the same bits."""
    bits = np.asarray(a).view(np.uint16).astype(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_product_equals_the_reference_with_a_corrupted_bit(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    jbits, jcodes = jref.protect(a)
    bits, codes = ops.protect(_bf16_torch(a))
    np.testing.assert_array_equal(common.to_u32(bits), np.asarray(jbits))
    np.testing.assert_array_equal(common.to_u32(codes), np.asarray(jcodes))
    assert torch.equal(ops.unprotect(bits), _bf16_torch(a))
    np.testing.assert_array_equal(
        np.asarray(jref.unprotect(jbits)).view(np.uint16),
        ops.unprotect(bits).view(torch.int16).numpy().view(np.uint16))

    arr = np.asarray(jbits).copy()
    arr[m // 3, k // 8] ^= np.uint32(1 << 21)          # a weight bit
    tb = _bf16_torch(b)
    got = ops.ecc_matmul(common.to_words(arr), codes, tb).numpy()
    want = np.asarray(jref.ecc_matmul(jnp.asarray(arr), jcodes, b))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if m % 8 == 0:          # the Pallas kernel's tiles need whole blocks
        wk = np.asarray(jkernel.ecc_matmul(jnp.asarray(arr), jcodes, b))
        np.testing.assert_allclose(got, wk, rtol=0, atol=1e-5 * scale)
    assert np.array_equal(got, ops.ecc_matmul(bits, codes, tb).numpy())
    assert np.array_equal(got, (ops.unprotect(bits).float()
                                @ tb.float()).numpy())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((4, 24), dtype=torch.bfloat16)
    b = torch.zeros((24, 3), dtype=torch.bfloat16)
    bits = a.view(torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.ecc_matmul(bits, torch.zeros((4, 1), dtype=torch.int32), b)
    a = torch.zeros((4, 32), dtype=torch.bfloat16)
    bits, codes = ref.protect(a)
    with pytest.raises(ValueError, match="codes"):
        ops.ecc_matmul(bits, codes[:, :1], torch.zeros((32, 3),
                                                       dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ecc_matmul(bits, codes, torch.zeros((32, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ecc_matmul(bits, codes, torch.zeros((3, 32),
                                                dtype=torch.bfloat16).T)


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def test_non_cpu_tensors_never_fall_back():
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ecc_matmul(_meta(8, 16), _meta(8, 2),
                       _meta(32, 5, dtype=torch.bfloat16))


def test_wrapper_marshals_the_declared_c_arguments(monkeypatch):
    seen = []
    monkeypatch.setattr(common, "check_cuda_words", lambda *a: None)
    monkeypatch.setattr(common, "launch", lambda entry, *args, **kw:
                        seen.append((entry, args, kw)))
    out = ops.ecc_matmul(_meta(8, 16), _meta(8, 2),
                         _meta(32, 5, dtype=torch.bfloat16))
    [(entry, args, kw)] = seen
    assert entry == "ecc_matmul_decode"
    assert kw == {"counts_as": "ecc_matmul"}
    assert len(args) + 1 == len(common.ENTRIES[entry])
    assert all(isinstance(t, torch.Tensor) for t in args[:4])
    assert args[4:] == (8, 5, 32)
    assert out.shape == (8, 5) and out.dtype == torch.float32


class _Library:
    """Stands in for the built library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


T = ops.DECODE_MAX_N
#: K too deep for B[:, :4] in the decode pass's shared memory
DEEP_K = 16 * (ops.DECODE_SMEM_B // (2 * 4 * 16) + 1)


@pytest.mark.parametrize("k,n,entry", [
    (32, T - 1, "ecc_matmul_decode"), (32, T, "ecc_matmul_decode"),
    (32, T + 1, "ecc_matmul_tiled"), (32, 4096, "ecc_matmul_tiled"),
    (DEEP_K, 4, "ecc_matmul_tiled")])
def test_threshold_picks_the_c_entry_and_counts_one_launch(k, n, entry,
                                                           monkeypatch):
    """N at and below the threshold reaches the decode pass, above it (or
    where B would not fit in shared memory) the tiled product; the real
    ``common.launch`` passes the declared arguments and the stream and
    counts the call once under ``ecc_matmul``, whichever entry ran."""
    lib = _Library()
    monkeypatch.setattr(common, "check_cuda_words", lambda *a: None)
    monkeypatch.setattr(common, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(common, "LAUNCHES", common.collections.Counter())
    ops.ecc_matmul(_meta(8, k // 2), _meta(8, k // 16),
                   _meta(k, n, dtype=torch.bfloat16))
    [(name, args)] = lib.calls
    assert name == entry
    assert len(args) == len(common.ENTRIES[entry])
    assert all(isinstance(p, int) for p in args[:4])      # device pointers
    assert args[4:] == (8, n, k, 7)
    assert common.LAUNCHES == {"ecc_matmul": 1}
