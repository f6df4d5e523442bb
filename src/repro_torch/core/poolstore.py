"""PoolStore — keep a tree of tensors inside a CREAM pool.

Port of ``repro/core/poolstore.py``. Bridges the framework's tensors and
the pool's page world: leaves are bitcast to 32-bit words (each padded to
a 4-byte multiple), laid end to end in the tree's leaf order, and written
as consecutive pages. The table of contents records each leaf's word span
so single leaves can be located again. The trainer keeps a
SECDED-protected warm snapshot of its optimizer moments this way.

The leaves stay on their device: :func:`store_tree` copies each leaf's
bytes into one word buffer on the pool's device and writes it with one
:func:`repro_torch.core.pool.write_pages_any` (on the card: one SECDED
encode launch for a whole-SECDED pool), and :func:`load_tree` reads every
page back with one decode-corrected status read. For the same tree, the
pool's storage and the table of contents are the reference's, bit for bit;
dtype names are numpy's (``"float32"``, ``"bfloat16"``, ...).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import pool as pool_lib
from repro_torch.core.pool import PoolState
from repro_torch.distributed.sharding import tree_paths

#: torch dtype <-> the numpy dtype name the reference records
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.bfloat16: "bfloat16",
               torch.int64: "int64", torch.int32: "int32",
               torch.int16: "int16", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}
TORCH_DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}
TORCH_DTYPES["uint32"] = torch.int32     # the same bits (kernels.common)


def as_tensor(leaf, device=None) -> torch.Tensor:
    """A tree leaf as a tensor: a tensor as it is, an array (or number)
    copied. A numpy ``bfloat16`` array (``ml_dtypes``) goes through its
    16-bit pattern, so no ``ml_dtypes`` is needed here."""
    if isinstance(leaf, torch.Tensor):
        return leaf if device is None else leaf.to(device)
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t if device is None else t.to(device)


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """The leaf's bytes, row-major, as a flat uint8 view (or copy, for a
    strided leaf) on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def from_bytes(raw: torch.Tensor, shape, dtype: str) -> torch.Tensor:
    """Inverse of :func:`leaf_bytes`: ``raw`` (uint8, exactly the leaf's
    bytes) -> a new tensor of ``shape`` and the named dtype."""
    return raw.clone().view(TORCH_DTYPES[dtype]).reshape(tuple(shape))


@dataclass(frozen=True)
class LeafEntry:
    word_offset: int
    num_words: int
    pad_bytes: int
    shape: tuple
    dtype: str


@dataclass(frozen=True)
class TableOfContents:
    entries: dict[str, LeafEntry]
    total_pages: int


def _leaf_words(t: torch.Tensor) -> tuple[int, int]:
    """A leaf's ``(words, pad bytes)`` at a 4-byte padding."""
    nbytes = t.numel() * t.element_size()
    pad = (-nbytes) % 4
    return (nbytes + pad) // 4, pad


def required_rows(tree, row_words: int = 256) -> int:
    """Pool rows needed to store ``tree`` (SECDED region sizing helper)."""
    total_bytes = sum(as_tensor(l).numel() * as_tensor(l).element_size()
                      for l in tree_paths(tree).values())
    words = math.ceil(total_bytes / 4)
    page_words = 8 * row_words
    rows = math.ceil(words / page_words)
    return math.ceil(rows / 8) * 8  # group-aligned


def store_tree(state: PoolState, tree, first_page: int = 0
               ) -> tuple[PoolState, TableOfContents]:
    """Write all leaves into consecutive pages starting at ``first_page``.
    Functional, as :func:`~repro_torch.core.pool.write_pages_any`."""
    flat = {p: as_tensor(l) for p, l in tree_paths(tree).items()}
    entries: dict[str, LeafEntry] = {}
    offset = 0
    for path, t in flat.items():
        n, pad = _leaf_words(t)
        entries[path] = LeafEntry(offset, n, pad, tuple(t.shape),
                                  DTYPE_NAMES[t.dtype])
        offset += n
    pw = state.page_words
    n_pages = math.ceil(offset / pw)
    if first_page + n_pages > state.num_pages:
        raise ValueError(
            f"tree needs {n_pages} pages at offset {first_page}, pool has "
            f"{state.num_pages}")
    blob = torch.zeros(n_pages * pw, dtype=torch.int32, device=state.device)
    raw = blob.view(torch.uint8)
    for path, t in flat.items():
        e = entries[path]
        b = leaf_bytes(t)
        raw[4 * e.word_offset:4 * e.word_offset + b.numel()] = b.to(
            state.device)
    # one batched write of every page (one code pass)
    state = pool_lib.write_pages_any(
        state, np.arange(first_page, first_page + n_pages),
        blob.view(n_pages, pw))
    return state, TableOfContents(entries, n_pages)


def load_tree(state: PoolState, toc: TableOfContents, like,
              first_page: int = 0) -> tuple[object, int]:
    """Read the tree back -> ``(tree of new tensors on the pool's device,
    worst page status)``; ``like`` gives the structure."""
    n = toc.total_pages
    data, status = pool_lib.read_pages_any_status(
        state, np.arange(first_page, first_page + n))
    raw = data.reshape(-1).view(torch.uint8)
    worst = int(status.max()) if n else 0
    del data, status

    def rebuild(prefix, node):
        if isinstance(node, dict):
            return {k: rebuild(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rebuild(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(t)
        e = toc.entries[prefix]
        start = 4 * e.word_offset
        return from_bytes(raw[start:start + 4 * e.num_words - e.pad_bytes],
                          e.shape, e.dtype)

    return rebuild("", like), worst
