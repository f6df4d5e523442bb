"""Traffic: what the generators share, and how a mix finds its generator.

A mix is a data file, ``bench/traffic/<mix>.json``, whose ``kind`` names
its generator, ``bench/traffic/<kind>.py``. So a new mix of a known kind
is a new data file, and a new kind of traffic a new generator file. A
generator module gives:

* ``turns(mix, seed, vocab)`` — the seeded list of turns, longer than any
  window can serve;
* ``openings(mix, seed, vocab)`` — the sessions opened in set-up (may be
  empty);
* ``request(turn, client, mix, opened)`` — the turn as ``(session id,
  prompt, tier)``;
* ``CLOSE_AFTER_TURN`` — whether a session is closed when its turn ends;
* ``ready(idle, poll)`` — which idle clients send their next turn at this
  poll (the arrival policy, counted in polls and never in host time).

Lengths are drawn as stratified quantiles: each block of ``block`` turns
holds the same ``block`` sizes, evenly spaced in probability over a
log-normal of spread ``sigma`` clipped to [``min``, ``max``], in an order
drawn from the seed. The log-normal is placed by its ``median`` or, where
the mix gives a ``mean``, so that the block's mean is that mean. So every
seed sends the same sizes in another order, and any prefix of the list is
near the mix's distribution. Without ``sigma`` the sizes are uniform over
[``min``, ``max``]. Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np

KINDS = Path(__file__).resolve().parents[1] / "traffic"


@dataclass
class Turn:
    session: int            # session index (a fresh one per single turn)
    prompt: np.ndarray      # int32 token ids (used when the session opens)
    max_new: int
    tier: str


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def _block(dist: dict, median: float, z: np.ndarray) -> np.ndarray:
    base = np.exp(math.log(median) + dist["sigma"] * z)
    return np.clip(np.rint(base), dist["min"], dist["max"]).astype(np.int64)


def block_sizes(dist: dict) -> np.ndarray:
    """The ``block`` sizes every block of turns holds, ascending."""
    block = int(dist.get("block", 64))
    probs = (np.arange(block) + 0.5) / block
    if "sigma" not in dist:             # uniform over [min, max]
        base = dist["min"] + (dist["max"] - dist["min"]) * probs
        return np.clip(np.rint(base), dist["min"], dist["max"]).astype(
            np.int64)
    z = np.array([NormalDist().inv_cdf(p) for p in probs])
    if "median" in dist:
        return _block(dist, dist["median"], z)
    lo, hi = math.log(dist["min"]), math.log(dist["max"])
    for _ in range(60):                 # the block's mean rises with it
        mid = (lo + hi) / 2
        if _block(dist, math.exp(mid), z).mean() < dist["mean"]:
            lo = mid
        else:
            hi = mid
    return _block(dist, math.exp(hi), z)


def sizes(dist: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` lengths, stratified: whole blocks of the same sizes, each
    block in its own seeded order."""
    base = block_sizes(dist)
    reps = -(-n // len(base))
    return np.concatenate([gen.permutation(base) for _ in range(reps)])[:n]


def tier_of(index: int, paid_share: float) -> str:
    """Every ``1 / paid_share``-th index is the ``paid`` tier."""
    every = round(1 / paid_share) if paid_share else 0
    return "paid" if every and index % every == 0 else "batch"


def tokens(gen: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return gen.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def kind(name: str):
    """The generator module ``bench/traffic/<name>.py``."""
    path = KINDS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no generator for traffic kind {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "bench_traffic_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turns(mix: dict, seed: int, vocab: int) -> list[Turn]:
    return kind(mix["kind"]).turns(mix, seed, vocab)


def openings(mix: dict, seed: int, vocab: int) -> list[Turn]:
    return kind(mix["kind"]).openings(mix, seed, vocab)
