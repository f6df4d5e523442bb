"""BENCHMARK.json keeps to the benchmark's contract: keys, names, units,
files, bounds."""
import json
import re

import pytest

from harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "proj", "head",
          "expansion", "experts_per_tok", "_dim", "_rank")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_command_stays_in_paths():
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and cmd[0] == "python3"
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
        assert (spec.ROOT / word).is_file()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["source"].startswith("https://")
    assert cfg["file"].startswith(BENCH["paths"][0] + "/")
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data
        assert not any(w in key for w in WIDTHS)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert 1 <= len(cfg["why"]) <= 200


def test_cells():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]


def test_metrics():
    e2e = BENCH["end_to_end"]
    names = [m["name"] for m in e2e + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for m in e2e + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_pool_and_gather_fit_int32_indexing(cell):
    """The port's pool kernels index with int32: a cell's pool storage (9
    lanes a row) and a step's gathered pages stay under 2**31 words."""
    import math

    from harness import program
    c = spec.load_cell(cell)
    cfg, wk = c.config, c.workload
    token_words = 2 * cfg["num_key_value_heads"] * (
        cfg["hidden_size"] // cfg["num_attention_heads"])
    bt = 8 * wk["row_words"] // token_words
    rows, _ = program.pool_rows(wk, cfg, bt)
    assert rows * 9 * wk["row_words"] < 2**31
    page_words = 8 * wk["row_words"]
    assert wk["max_batch"] * cfg["num_hidden_layers"] * math.ceil(
        wk["max_len"] / bt) * page_words < 2**31
