"""The plain references against the port, at a tiny size on the CPU."""
import time

import numpy as np
import pytest
import torch

from conftest import TINY_OLMOE, TINY_STARCODER2, tiny_cell
from harness import program, runner
from reference import decoder, olmoe, pool as rpool, secded, weights

SEED = 2**31 + 77


def test_frozen_codec_is_the_ports():
    from repro_torch.core import secded as port
    g = torch.Generator().manual_seed(1)
    d = torch.randint(-2**31, 2**31 - 1, (64, 256), generator=g,
                      dtype=torch.int64).to(torch.int32)
    codes = port.encode_block(d)
    assert torch.equal(secded.encode_block(d), codes)
    d2 = d.clone()
    d2[3, 5] ^= 1 << 7          # one bit: corrected
    d2[4, 8] ^= 3               # two bits: detected
    mine, st = secded.decode_block(d2, codes)
    theirs, _, st2 = port.decode_block(d2, codes)
    assert torch.equal(mine, theirs) and torch.equal(st, st2.int())


@pytest.mark.parametrize("boundary", [0, 40, 64])
def test_pool_layout_is_the_ports(boundary):
    from repro_torch.core.layouts import Layout
    from repro_torch.core.pool import make_pool
    R, W = 64, 16
    st = make_pool(R, Layout.INTERWRAP, boundary=boundary, row_words=W,
                   device="cpu")
    g = torch.Generator().manual_seed(boundary)
    ids = torch.randperm(R + boundary // 8, generator=g)[:50]
    data = torch.randint(-2**31, 2**31 - 1, (50, 8 * W), generator=g,
                         dtype=torch.int64).to(torch.int32)
    st = st.write(ids.numpy(), data)
    mine = torch.zeros_like(st.storage)
    rpool.write(mine, ids, data, R, boundary)
    assert torch.equal(mine, st.storage)
    assert torch.equal(rpool.read(st.storage, ids, R, boundary), data)


@pytest.mark.parametrize("cfg", [TINY_OLMOE, TINY_STARCODER2],
                         ids=["olmoe", "starcoder2"])
def test_reference_forward_is_the_ports(cfg):
    """The port's dense forward on the benchmark's weights against the
    reference's prefill of the same prompt."""
    from repro_torch.models import build_model
    model = build_model(program.port_config(cfg), device="cpu")
    program.load_weights(model, cfg, SEED)
    toks = torch.randint(0, cfg["vocab_size"], (1, 24),
                         generator=torch.Generator().manual_seed(3))
    theirs, _ = model.forward(toks)
    fam = weights.family(cfg)
    x = weights.outer(cfg, SEED, "cpu")["embed"][toks[0]]
    pos = torch.arange(24)
    for layer in range(cfg["num_hidden_layers"]):
        w = weights.layer(cfg, SEED, layer, "cpu")
        q, k, v = decoder.qkv(w, cfg, decoder.attn_in(w, cfg, x), pos, False)
        x = x + decoder.attend(q, k, v, pos, None, False) @ w["wo"]
        x = x + fam.mixer(w, cfg, decoder.mixer_in(w, cfg, x), False)[0]
    mine = decoder.logits(weights.outer(cfg, SEED, "cpu"), cfg, x, False)
    assert (mine - theirs[0]).abs().max() <= 1e-5 * mine.abs().max()


def test_a_tie_takes_the_programs_side_and_nothing_else():
    probs = torch.tensor([[0.30, 0.25, 0.2500001, 0.10, 0.0999999]])
    mine, ties = olmoe.choose(probs, 2, None)
    assert sorted(mine[0].tolist()) == [0, 2] and ties == 0
    theirs = torch.tensor([[0, 1]])
    got, ties = olmoe.choose(probs, 2, theirs)
    assert sorted(got[0].tolist()) == [0, 1] and ties == 1
    far = torch.tensor([[0, 3]])
    got, ties = olmoe.choose(probs, 2, far)
    assert sorted(got[0].tolist()) == [0, 2] and ties == 0


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0])
    y = decoder.tf32_round(x)
    assert y.tolist() == [1.0, 1.0 + 2**-9, -3.0]


@pytest.mark.parametrize("family,mix", [("olmoe", "single"),
                                        ("starcoder2", "single"),
                                        ("olmoe", "sessions")])
def test_a_whole_run_comes_out_correct(family, mix):
    out = runner.run_cell(tiny_cell(family, mix), SEED, 1.5, False, "cpu",
                          time.perf_counter())
    nums = out["numbers"]
    assert out["correct"], out["checks"]
    assert nums["tokens"] >= 8 and nums["kv_blocks"] > 0
    assert nums["gathers"] >= 3 and nums["writes"] >= 3
    w = out["run"].window
    assert w["tokens"] > 0 and w["attempted"] > 0 and w["failed"] == 0
    if mix == "sessions":
        assert out["run"].restores > 0 and out["run"].cont_admitted > 0


def test_an_untraced_run_profiles_the_slice_of_a_device_metric():
    """A cell that reports an end-to-end metric from the device's trace has
    its slice profiled in every run: the tokens stamped in the slice are
    counted, and the run is judged as any other."""
    cell = tiny_cell("olmoe")
    cell.end_to_end = [{"name": "device_ms_per_token",
                        "source": "device_trace"}]
    out = runner.run_cell(cell, SEED, 1.5, False, "cpu",
                          time.perf_counter())
    run = out["run"]
    assert out["correct"], out["checks"]
    assert run.timeline is not None and run.traced_steps > 0
    assert 0 < run.slice_tokens <= run.window["tokens"]
    assert 0 < run.slice_flops <= run.flops
