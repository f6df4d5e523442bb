"""Single turns in a closed loop: ``clients`` users each send a turn,
wait for its last token and send the next at the same poll, so the batch
stays full. Every turn opens a new session with a prompt of ``prompt``
tokens and asks for ``output`` new ones; the session is closed when the
turn ends. ``paid_share`` of the users (every ``1 / paid_share``-th, by
index) are the ``paid`` tier, the others ``batch``."""
from __future__ import annotations

from harness import traffic

CLOSE_AFTER_TURN = True


def openings(mix: dict, seed: int, vocab: int) -> list:
    return []


def turns(mix: dict, seed: int, vocab: int) -> list:
    n = mix["turns"]
    gen = traffic.rng(seed, 2)
    out_lens = traffic.sizes(mix["output"], n, gen)
    p_lens = traffic.sizes(mix["prompt"], n, gen)
    return [traffic.Turn(i, traffic.tokens(gen, int(p_lens[i]), vocab),
                         int(out_lens[i]), "") for i in range(n)]


def request(turn, client: int, mix: dict, opened: list):
    return (f"u{turn.session}", turn.prompt,
            traffic.tier_of(client, mix["paid_share"]))


def ready(idle: list[int], poll: int) -> list[int]:
    return idle
