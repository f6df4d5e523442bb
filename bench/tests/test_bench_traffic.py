"""The traffic generators: found by the mix's kind, seeded, stratified,
the same sizes for every seed; every mix names its source."""
import numpy as np
import pytest

from conftest import TINY_SESSIONS, TINY_SINGLE
from harness import spec, traffic

BIG_SEEDS = (2**31 + 11, 2**40 + 3)


def _flat(turns):
    return [(t.session, t.max_new, t.tier, t.prompt.tolist()) for t in turns]


@pytest.mark.parametrize("mix", [TINY_SINGLE, TINY_SESSIONS])
@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_same_seed_same_turns(mix, seed):
    a = traffic.turns(mix, seed, 256) + traffic.openings(mix, seed, 256)
    b = traffic.turns(mix, seed, 256) + traffic.openings(mix, seed, 256)
    assert _flat(a) == _flat(b)


@pytest.mark.parametrize("mix", [TINY_SINGLE, TINY_SESSIONS])
def test_seeds_differ(mix):
    a = _flat(traffic.turns(mix, BIG_SEEDS[0], 256))
    b = _flat(traffic.turns(mix, BIG_SEEDS[1], 256))
    assert a != b


MIXES = sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_every_block_has_the_same_sizes(name):
    mix = spec._load(spec.BENCH / "traffic" / f"{name}.json")
    key = "prompt" if mix["kind"] == "single" else "first_prompt"
    for dist in (mix["output"], mix[key]):
        block = dist["block"]
        a = traffic.sizes(dist, 4 * block, np.random.default_rng(1))
        b = traffic.sizes(dist, 4 * block, np.random.default_rng(2))
        assert not np.array_equal(a, b)
        for i in range(4):
            part = slice(i * block, (i + 1) * block)
            assert sorted(a[part]) == sorted(b[part])
        assert a.min() >= dist["min"] and a.max() <= dist["max"]


def test_lognormal_median():
    dist = {"median": 160, "sigma": 0.5, "min": 64, "max": 512, "block": 64}
    s = traffic.sizes(dist, 64, np.random.default_rng(0))
    assert 150 <= np.median(s) <= 170


@pytest.mark.parametrize("mean", [69.5, 214.5])
def test_lognormal_mean_is_the_blocks(mean):
    """A mix that gives a mean gets it in every block, clipping and all."""
    dist = {"mean": mean, "sigma": 0.5, "min": 1, "max": 256, "block": 64}
    s = traffic.sizes(dist, 128, np.random.default_rng(0))
    assert abs(s[:64].mean() - mean) <= 0.5 and s.max() <= 256


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_its_source_and_generator(name):
    mix = spec._load(spec.BENCH / "traffic" / f"{name}.json")
    assert mix["source"] and "\n" not in mix["source"]
    gen = traffic.kind(mix["kind"])
    for attr in ("turns", "openings", "request", "ready",
                 "CLOSE_AFTER_TURN"):
        assert hasattr(gen, attr)
    assert gen.ready([3, 1], 0) == [3, 1]      # closed loops


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="no generator"):
        traffic.kind("no_such_kind")


def test_sessions_are_zipf_skewed():
    mix = dict(TINY_SESSIONS, sessions=32, turns=4096, pick_block=256)
    picks = np.bincount([t.session for t in traffic.turns(mix, 5, 256)],
                        minlength=32)
    assert list(picks) == sorted(picks, reverse=True)    # rank order
    assert picks[0] > 4 * picks[-1] > 0
    assert picks.sum() == 4096


def test_every_seed_sends_the_same_session_work():
    mix = dict(TINY_SESSIONS, sessions=32, turns=512, pick_block=256)
    runs = [traffic.turns(mix, s, 256) for s in BIG_SEEDS]
    for a, b in ((runs[0][:256], runs[1][:256]), (runs[0][256:],
                                                  runs[1][256:])):
        assert sorted(t.session for t in a) == sorted(t.session for t in b)
        assert [t.session for t in a] != [t.session for t in b]
    opened = [traffic.openings(mix, s, 256) for s in BIG_SEEDS]
    assert [(len(t.prompt), t.tier) for t in opened[0]] == \
        [(len(t.prompt), t.tier) for t in opened[1]]
    assert opened[0][0].prompt.tolist() != opened[1][0].prompt.tolist()


def test_tiers():
    assert [traffic.tier_of(i, 0.25) for i in range(8)] == \
        ["paid", "batch", "batch", "batch"] * 2
    opened = traffic.openings(TINY_SESSIONS, 3, 256)
    assert sum(t.tier == "paid" for t in opened) == 2


def test_tokens_in_vocabulary():
    for t in traffic.turns(TINY_SINGLE, BIG_SEEDS[1], 100)[:50]:
        assert t.prompt.dtype == np.int32
        assert 0 <= t.prompt.min() and t.prompt.max() < 100
