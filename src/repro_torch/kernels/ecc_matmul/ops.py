"""SECDED decode-on-load matrix product: the dispatching wrapper.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch one
of the two kernels in ``csrc/ecc_matmul.cu`` or raise. There is no
fallback. Up to :data:`DECODE_MAX_N` columns of B the bytes-bound decode
pass runs (``ecc_matmul_decode``: A streamed once, B in shared memory);
above it, or where B[:, :N] would not fit in shared memory, the tiled
tensor-core product (``ecc_matmul_tiled``). Either counts one launch of
``ecc_matmul``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.ecc_matmul import ref

protect = ref.protect
unprotect = ref.unprotect

#: widest B the decode pass takes: on an H100 it beats the tiled product
#: at N = 4, 8 and 16 and loses from N = 24 (chip_smoke.py's
#: phase_ecc_kernel times both designs at N = 15, 16 and 17; PERF.md)
DECODE_MAX_N = 16
#: most bytes of B[:, :N] (N padded to 4, 8 or 16) the decode pass keeps
#: in shared memory (csrc/ecc_matmul.cu kDecodeSmemB)
DECODE_SMEM_B = 192 * 1024


def uses_decode(k: int, n: int) -> bool:
    """Whether an (M, K) x (K, N) product takes the decode pass."""
    if n > DECODE_MAX_N:
        return False
    padded = next(p for p in (4, 8, 16) if n <= p)
    return k * padded * 2 <= DECODE_SMEM_B


def ecc_matmul(a_bits: torch.Tensor, a_codes: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """A (M, K) bf16 as SECDED-protected words (bits (M, K//2), codes
    (M, K//16) int32) @ B (K, N) bf16 -> (M, N) float32, with single
    data-bit errors of A corrected on load. K must be a multiple of 16."""
    if a_bits.dim() != 2 or b.dim() != 2:
        raise ValueError("expected A bits (M, K//2) and B (K, N)")
    m, kw = a_bits.shape
    k, n = b.shape
    if k != 2 * kw or k % 16:
        raise ValueError(f"K mismatch or not a multiple of 16: bits "
                         f"{tuple(a_bits.shape)}, b {tuple(b.shape)}")
    if a_codes.shape != (m, k // 16):
        raise ValueError(f"codes must be {(m, k // 16)}, got "
                         f"{tuple(a_codes.shape)}")
    if b.dtype != torch.bfloat16:
        raise TypeError(f"ecc_matmul: B must be bfloat16, got {b.dtype}")
    common.check_contiguous("ecc_matmul", a_bits, a_codes, b)
    if all(t.device.type == "cpu" for t in (a_bits, a_codes, b)):
        return ref.ecc_matmul(a_bits, a_codes, b)
    common.check_cuda_words("ecc_matmul", a_bits, a_codes)
    if b.device != a_bits.device:
        raise ValueError("ecc_matmul: operands must share one CUDA device")
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if not k:
        return out.zero_()
    if m and n:
        entry = ("ecc_matmul_decode" if uses_decode(k, n)
                 else "ecc_matmul_tiled")
        common.launch(entry, a_bits, a_codes, b, out, m, n, k,
                      counts_as="ecc_matmul")
    return out
