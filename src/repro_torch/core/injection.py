"""Bit-flip fault injection — drives the reliability tests and the campaign.

Port of ``repro/core/injection.py``. Models DRAM soft and hard errors
(paper §2.2):

  * **soft errors** arrive as a Poisson process whose rate scales with the
    resident capacity (events per GB per step, see
    :mod:`repro_torch.faults.fit`); each event is one shape drawn from an
    :class:`ErrorMix`: ``single`` (one bit), ``adjacent_double`` (bits b,
    b+1 of one word) or ``random_double`` (two independent bits);
  * **hard errors** are a sticky set of (row, lane, word, bit) cells,
    concentrated in a few rows, that re-assert (stuck-at-1) every step.

The draws happen on the host from one ``np.random.Generator``, in the
reference's call order, so a seed gives the reference's flips. The flips
then go to the pool's storage on its device without a host copy of the
storage: the cells are folded on the host first — the XOR masks of every
cell drawn into one word combine, so a bit drawn twice cancels as under
the reference's ``np.bitwise_xor.at`` — and land in one gather/XOR/scatter
over distinct words (``index_put_`` keeps an unspecified one of several
duplicate indices, so duplicates must never reach it). Hard cells are
OR-ed after the XOR, as in the reference. The functions return new
storage and leave their input as it was, like the reference.

:meth:`FaultModel.step_pool` also steps a CREAM-Shard pool's ``(S,
R_local, 9, W)`` storage: global row ``r`` is bank ``r % S``, local row
``r // S`` (the router's convention), drawn over the global ``(S *
R_local, 9, W)`` shape as the reference draws it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.common import upload


@dataclass(frozen=True)
class FlipRecord:
    row: int
    lane: int
    word: int
    bit: int


def _one(bits: np.ndarray) -> np.ndarray:
    """``1 << bits`` as uint32 (numpy promotes plain ``1 <<`` to int64)."""
    return np.left_shift(np.uint32(1), bits.astype(np.uint32),
                         dtype=np.uint32)


def _check_local(storage: torch.Tensor) -> None:
    if storage.dim() != 3:
        raise ValueError(f"expected (R, 9, W) storage, got rank "
                         f"{storage.dim()} (sharded pools: step_pool)")


def _fold(words: np.ndarray, masks: np.ndarray, reduce
          ) -> tuple[np.ndarray, np.ndarray]:
    """Distinct linear word indices and the masks of each folded with the
    ufunc ``reduce`` (XOR for soft flips, OR for stuck-at cells)."""
    if not words.size:
        return words, masks
    order = np.argsort(words, kind="stable")
    words, masks = words[order], masks[order]
    start = np.flatnonzero(np.r_[True, words[1:] != words[:-1]])
    return words[start], reduce.reduceat(masks, start)


def _land(storage: torch.Tensor, words: np.ndarray, masks: np.ndarray,
          op: str) -> None:
    """XOR (``op="xor"``) or OR the masks into the distinct linear words of
    ``storage``, in place, with one gather and one scatter."""
    if not words.size:
        return
    flat = storage.view(-1)
    idx = upload(words.astype(np.int64), storage.device)
    m = upload(masks.astype(np.uint32).view(np.int32), storage.device)
    flat[idx] = flat[idx] ^ m if op == "xor" else flat[idx] | m


def _xor_cells(storage: torch.Tensor, rows, lns, words, bits) -> None:
    """``np.bitwise_xor.at`` of single-bit cells into ``storage``, in place."""
    _, L, W = storage.shape
    lin = (np.asarray(rows, np.int64) * L + lns) * W + words
    _land(storage, *_fold(lin, _one(np.asarray(bits)), np.bitwise_xor),
          "xor")


def inject_flips(storage: torch.Tensor, rng: np.random.Generator,
                 n_flips: int, row_range: tuple[int, int] | None = None,
                 lanes: tuple[int, ...] | None = None,
                 ) -> tuple[torch.Tensor, list[FlipRecord]]:
    """Flip ``n_flips`` uniformly random distinct bits -> ``(storage',
    ground truth)``. Oversampled batch draws deduped on a linear cell code,
    in the reference's draw order, until the exact count is reached."""
    _check_local(storage)
    R, L, W = storage.shape
    r0, r1 = row_range or (0, R)
    lane_pool = np.asarray(lanes if lanes is not None else range(L),
                           dtype=np.int64)
    chosen = np.empty(0, np.int64)      # linear cell codes, draw order kept
    while chosen.size < n_flips:
        m = 2 * max(n_flips - chosen.size, 16)
        rows = rng.integers(r0, r1, size=m)
        lns = lane_pool[rng.integers(0, lane_pool.size, size=m)]
        words = rng.integers(0, W, size=m)
        bits = rng.integers(0, 32, size=m)
        lin = ((rows * L + lns) * W + words) * 32 + bits
        cat = np.concatenate([chosen, lin])
        _, first = np.unique(cat, return_index=True)
        chosen = cat[np.sort(first)]    # dedupe, preserving draw order
    chosen = chosen[:n_flips]
    bits = chosen % 32
    words = (chosen // 32) % W
    lns = (chosen // (32 * W)) % L
    rows = chosen // (32 * W * L)
    out = storage.clone()
    _xor_cells(out, rows, lns, words, bits)
    records = [FlipRecord(int(r), int(ln), int(w), int(b))
               for r, ln, w, b in zip(rows, lns, words, bits)]
    return out, records


def apply_flips(storage: torch.Tensor,
                records: list[FlipRecord]) -> torch.Tensor:
    """XOR a known set of cells (targeted injection for tests and replays)
    -> new storage."""
    _check_local(storage)
    out = storage.clone()
    if records:
        _xor_cells(out, [c.row for c in records], [c.lane for c in records],
                   [c.word for c in records], [c.bit for c in records])
    return out


@dataclass(frozen=True)
class ErrorMix:
    """Relative weights of the soft-error event shapes.

    ``single`` flips one bit; ``adjacent_double`` flips two neighbouring
    bits of one word (one SECDED beat: detected-uncorrectable by Hsiao,
    never miscorrected; corrected outright in the SEC-DAEC tier);
    ``random_double`` flips two independent uniform bits. Weights need not
    sum to 1.
    """
    single: float = 1.0
    adjacent_double: float = 0.0
    random_double: float = 0.0

    def probs(self) -> np.ndarray:
        w = np.asarray([self.single, self.adjacent_double,
                        self.random_double], float)
        total = w.sum()
        if total <= 0:
            raise ValueError("ErrorMix weights must sum to > 0")
        return w / total


#: Single-bit upsets only.
SINGLES = ErrorMix()
#: Field-shaped mix: mostly singles, a tail of multi-bit upsets.
FIELD_MIX = ErrorMix(single=0.88, adjacent_double=0.08, random_double=0.04)


@dataclass
class FaultModel:
    """Stateful injector: soft error process + sticky hard-fault cells."""
    rng: np.random.Generator
    soft_rate_per_gb_per_step: float = 0.0
    hard_cells: list[FlipRecord] = field(default_factory=list)
    mix: ErrorMix = SINGLES

    @staticmethod
    def make(seed: int, soft_rate: float = 0.0, n_hard: int = 0,
             shape: tuple[int, int, int] | None = None,
             hard_row_fraction: float = 0.05,
             mix: ErrorMix = SINGLES) -> "FaultModel":
        """``shape`` is the storage geometry ``(R, L, W)``."""
        rng = np.random.default_rng(seed)
        hard: list[FlipRecord] = []
        if n_hard:
            R, L, W = shape
            # hard faults cluster in a few rows (field-study behaviour)
            bad_rows = rng.choice(R, size=max(1, int(R * hard_row_fraction)),
                                  replace=False)
            for _ in range(n_hard):
                hard.append(FlipRecord(int(rng.choice(bad_rows)),
                                       int(rng.integers(0, L)),
                                       int(rng.integers(0, W)),
                                       int(rng.integers(0, 32))))
        return FaultModel(rng, soft_rate, hard, mix)

    def _draw_soft(self, R: int, L: int, W: int, nbytes: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One step's soft flips as (rows, lanes, words, bits) arrays. The
        Poisson draw counts events; each contributes 1 or 2 bit flips."""
        gb = nbytes / 2**30
        n_events = int(self.rng.poisson(self.soft_rate_per_gb_per_step * gb))
        if not n_events:
            z = np.empty(0, np.int64)
            return z, z, z, z
        n1, n_adj, n_rnd = self.rng.multinomial(n_events, self.mix.probs())
        parts = []
        # singles + random doubles: independent uniform cells
        n_uni = int(n1) + 2 * int(n_rnd)
        if n_uni:
            parts.append((self.rng.integers(0, R, n_uni),
                          self.rng.integers(0, L, n_uni),
                          self.rng.integers(0, W, n_uni),
                          self.rng.integers(0, 32, n_uni)))
        # adjacent doubles: bits (b, b+1) of one word — one SECDED beat
        if n_adj:
            rows = self.rng.integers(0, R, n_adj)
            lns = self.rng.integers(0, L, n_adj)
            words = self.rng.integers(0, W, n_adj)
            b0 = self.rng.integers(0, 31, n_adj)
            parts.append((np.repeat(rows, 2), np.repeat(lns, 2),
                          np.repeat(words, 2),
                          np.stack([b0, b0 + 1], axis=1).reshape(-1)))
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))

    def step(self, storage: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Apply one step of faults -> ``(storage', flips applied)``."""
        _check_local(storage)
        return self._step(storage, lambda r: r)

    def _step(self, storage: torch.Tensor, phys
              ) -> tuple[torch.Tensor, int]:
        """One step over ``storage`` viewed as ``(rows, L, W)``; ``phys``
        maps the drawn (global) row ids to rows of that view."""
        out = storage.clone()
        flat = out.view(-1, *out.shape[-2:])
        R, L, W = flat.shape
        rows, lns, words, bits = self._draw_soft(
            R, L, W, out.numel() * out.element_size())
        _xor_cells(flat, phys(rows), lns, words, bits)
        count = int(rows.size)
        if self.hard_cells:                  # stuck-at-1, after the XOR
            hrows = phys(np.asarray([c.row for c in self.hard_cells],
                                    np.int64))
            lin = (hrows * L + [c.lane for c in self.hard_cells]) * W \
                + [c.word for c in self.hard_cells]
            _land(flat, *_fold(lin, _one(np.asarray(
                [c.bit for c in self.hard_cells])), np.bitwise_or), "or")
            count += len(self.hard_cells)
        return out, count

    def step_pool(self, pool) -> tuple[object, int]:
        """Inject one step of faults into a live pool -> ``(pool', flips
        applied)``: a local pool's ``(R, 9, W)`` storage, or a sharded
        pool's ``(S, R_local, 9, W)`` with global row ``r`` at bank ``r %
        S``, local row ``r // S``."""
        storage = pool.storage
        if storage.dim() == 4:
            S, R_local = storage.shape[:2]
            new, count = self._step(storage,
                                    lambda r: r % S * R_local + r // S)
        else:
            new, count = self.step(storage)
        return dataclasses.replace(pool, storage=new), count
