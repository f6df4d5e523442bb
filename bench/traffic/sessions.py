"""Multi-turn sessions in a closed loop: ``sessions`` conversations are
opened in set-up with prompts of ``first_prompt`` tokens; each of
``clients`` users continues one of them by ``output`` new tokens, and
sends the next turn at the same poll as the last one ends. Session ``r``
has popularity rank ``r``, Zipf(``zipf``): each block of ``pick_block``
turns holds every session as often as its weight says (largest
remainders), in an order drawn from the seed. A session's prompt size and
tier go with its rank, the same for every seed. A turn whose session is
still busy waits: the next turn of the list whose session is free goes
first."""
from __future__ import annotations

import numpy as np

from harness import traffic

CLOSE_AFTER_TURN = False


def openings(mix: dict, seed: int, vocab: int) -> list:
    """Prompt and one new token each; the prompt sizes go to the ranks in
    one fixed order, only the token ids come from the seed."""
    n = mix["sessions"]
    lens = traffic.sizes(mix["first_prompt"], n, np.random.default_rng(0))
    gen = traffic.rng(seed, 1)
    return [traffic.Turn(i, traffic.tokens(gen, int(lens[i]), vocab), 1,
                         traffic.tier_of(i, mix["paid_share"]))
            for i in range(n)]


def zipf_counts(k: int, alpha: float, block: int) -> np.ndarray:
    """How often each of ``k`` ranks appears in a block of ``block`` turns:
    Zipf weights, rounded by largest remainders to sum ``block``."""
    w = 1.0 / np.arange(1, k + 1) ** alpha
    exact = block * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    short = block - counts.sum()
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return counts


def turns(mix: dict, seed: int, vocab: int) -> list:
    n, k = mix["turns"], mix["sessions"]
    gen = traffic.rng(seed, 2)
    out_lens = traffic.sizes(mix["output"], n, gen)
    block = np.repeat(np.arange(k), zipf_counts(k, mix["zipf"],
                                                mix["pick_block"]))
    picks = np.concatenate([gen.permutation(block) for _ in range(
        -(-n // len(block)))])[:n]
    return [traffic.Turn(int(s), np.zeros(0, np.int32), int(out_lens[i]),
                         traffic.tier_of(int(s), mix["paid_share"]))
            for i, s in enumerate(picks)]


def request(turn, client: int, mix: dict, opened: list):
    return f"s{turn.session}", opened[turn.session].prompt, turn.tier


def ready(idle: list[int], poll: int) -> list[int]:
    return idle
