"""The port's roofline and dry-run against the reference's.

  * ``parse_collectives`` gives the reference's ``as_dict()`` on the same
    HLO text (async pairs, tuples, every collective kind).
  * ``analyze_record`` with the reference's v5e rates passed gives every
    ``Roofline`` field of the reference's on the same record (floats within
    1e-12 relative), for every arch × shape × mesh; ``model_flops_for``
    equals the reference's and ``interesting_cells`` picks the same cells.
  * ``CostCounter`` on plain tensors: a product's FLOPs and bytes by hand.
  * A dry-run in a subprocess (the fake process group belongs to the whole
    process): qwen3-0.6b ``smoke()`` on fake (2, 4) and (2, 2, 4) meshes
    records ``ok`` for a train, a prefill and a decode cell, each with
    positive FLOPs, bytes and collective traffic; a step's FLOPs are its
    stages' (``stage_cost_probe``) plus its embedding and head; a
    row-parallel product's all-reduce and FLOPs match a hand count, a
    product sharded over all 8 ranks counts 1/8 of its FLOPs and a
    replicated one all of them; ``roofline.analysis`` reads the records.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.roofline import analysis as janalysis
from repro.roofline import hlo_parse as jhlo
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import hlo_parse as thlo

ROOT = Path(__file__).resolve().parent.parent
V5E = (197e12, 819e9, 50e9)     # the reference's PEAK_FLOPS_BF16, HBM_BW, ICI

HLO = """\
HloModule m
ENTRY %main {
  %p0 = bf16[16,4096]{1,0} parameter(0)
  %all-reduce.1 = f32[128,1024]{1,0} all-reduce(f32[128,1024]{1,0} %x), replica_groups={}
  %ag-start = (bf16[16,4096]{1,0}, bf16[256,4096]{1,0}) all-gather-start(bf16[16,4096]{1,0} %p0), dimensions={0}
  %ag-done = bf16[256,4096]{1,0} all-gather-done((bf16[16,4096]{1,0}, bf16[256,4096]{1,0}) %ag-start)
  %rs = bf16[8,512]{1,0} reduce-scatter(bf16[128,512]{1,0} %y), dimensions={0}
  %a2a = (s32[4,8]{1,0}, s32[4,8]{1,0}) all-to-all(s32[4,8]{1,0} %a, s32[4,8]{1,0} %b)
  %cp = u8[1024]{0} collective-permute(u8[1024]{0} %c), source_target_pairs={{0,1}}
  %ar-start = f32[7]{0} all-reduce-start(f32[7]{0} %z)
  %ar-done = f32[7]{0} all-reduce-done(f32[7]{0} %ar-start)
  ROOT %cb = pred[3,3]{1,0} collective-broadcast(pred[3,3]{1,0} %q)
}
"""


def test_parse_collectives_equals_reference():
    assert thlo.parse_collectives(HLO).as_dict() == \
        jhlo.parse_collectives(HLO).as_dict()
    assert thlo.COLLECTIVE_OPS == jhlo.COLLECTIVE_OPS
    assert thlo._DTYPE_BYTES == jhlo._DTYPE_BYTES
    assert set(thlo.TORCH_COLLECTIVES.values()) <= set(jhlo.COLLECTIVE_OPS)


def _cells():
    return [(a, s, m) for a in ARCH_IDS for s in SHAPES
            for m in ("pod16x16", "pod2x16x16")
            if shape_applicable(get_config(a), SHAPES[s])]


def _record(arch, shape, mesh, i) -> dict:
    """A synthetic dry-run record, its numbers drawn from ``i``."""
    rng = np.random.default_rng(i)
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
            "kind": SHAPES[shape].kind,
            "hlo_flops_scaled": float(rng.uniform(1e9, 1e15)),
            "hlo_bytes_scaled": float(rng.uniform(1e8, 1e13)),
            "collective_wire_bytes_scaled": float(rng.uniform(0, 1e12))}


def _fields_equal(got, want):
    for k, w in want.__dict__.items():
        g = getattr(got, k)
        if isinstance(w, float):
            assert math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0), (k, g, w)
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_record_equals_reference(arch):
    for i, (a, s, m) in enumerate(_cells()):
        if a != arch:
            continue
        rec = _record(a, s, m, i)
        _fields_equal(tanalysis.analyze_record(rec, rates=V5E),
                      janalysis.analyze_record(rec))
        shp = SHAPES[s]
        assert tanalysis.model_flops_for(a, s, shp.kind, shp.global_batch,
                                         shp.seq_len) == \
            janalysis.model_flops_for(a, s, shp.kind, shp.global_batch,
                                      shp.seq_len)
    assert tanalysis.analyze_record({"ok": False}) is None


def test_interesting_cells_and_rates():
    recs = [_record(a, s, m, i) for i, (a, s, m) in enumerate(_cells())]
    got = tanalysis.interesting_cells(
        [tanalysis.analyze_record(r, rates=V5E) for r in recs])
    want = janalysis.interesting_cells(
        [janalysis.analyze_record(r) for r in recs])
    assert list(got) == list(want)
    for k in want:
        _fields_equal(got[k], want[k])
    # the default rates are the H100's: one card, no mesh in the name
    card = dict(recs[0], mesh="card", global_batch=4, seq_len=1)
    r = tanalysis.analyze_record(card)
    assert r.compute_s == card["hlo_flops_scaled"] / 1070.5e12
    assert r.memory_s == card["hlo_bytes_scaled"] / 3.35e12
    assert r.model_flops_per_dev == tanalysis.model_flops_for(
        card["arch"], card["shape"], card["kind"], 4, 1)


def test_cost_counter_on_plain_tensors():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    with thlo.CostCounter() as c:
        y = torch.relu(a @ b).reshape(-1)
    assert y.shape == (2048,)
    assert c.flops == 2 * 64 * 128 * 32
    # mm reads a and b and writes y; relu reads and writes y; the view is free
    assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32) + 4 * 2 * 64 * 32
    assert c.collectives.as_dict()["wire_bytes"] == 0


SCRIPT = r"""
import json, sys
import torch
from torch.distributed.tensor import Replicate
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import NamedSharding, P, use_mesh
from repro_torch.launch import dryrun, shardings as sh
from repro_torch.models import transformer
from repro_torch.models.common import cross_entropy, rms_norm
from repro_torch.roofline.hlo_parse import CostCounter

out = sys.argv[1]
dryrun.start_fake_world(16)
cfg = get_config("qwen3-0.6b").smoke()
res = {"cells": {}, "head": {}}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    for ms in ((2, 4), (2, 2, 4)):
        rec = dryrun.run_cell(cfg, SHAPES[shape], len(ms) == 3,
                              out_dir=out, mesh_shape=ms)
        res["cells"][shape + "/" + dryrun.mesh_name(ms)] = rec

mesh = dryrun.make_mesh((2, 4))
dm = mesh.device_mesh


def dt(shape, spec, dtype=torch.float32):
    return sh.ShapeDtypeStruct(shape, dtype, NamedSharding(mesh, P(*spec))).make()


def counted(fn, *args):
    with use_mesh(mesh):
        c, out = dryrun._count(fn, *args)
    return c, out


# the embedding and head of each kind, on the cells' specs
with use_mesh(mesh):
    params = sh.make_tree(sh.param_specs(cfg, mesh))
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    s = SHAPES[shape]
    seq = 1 if s.kind == "decode" else s.seq_len
    b = s.global_batch
    with use_mesh(mesh):
        x = sh.ShapeDtypeStruct((b, seq, cfg.d_model), cfg.activation_dtype,
                                sh.shard(mesh, P("data", None, None),
                                         (b, seq, cfg.d_model))).make()
        tok = sh.batch_specs(cfg, s, mesh, True)
        toks, labs = tok["tokens"].make(), tok["labels"].make()

    def head(x, params=params, s=s):
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if s.kind == "prefill":
            h = h[:, -1, :]
        spec = ("data", None, "model") if s.kind != "prefill" else \
            ("data", "model")
        return transformer._lm_logits(params, cfg, h, spec)

    def step(x, toks=toks[:, :seq], labs=labs, s=s):
        transformer._embed(params, toks)
        if s.kind != "train":
            with torch.no_grad():
                return head(x)
        table = params["embed"]["table"].detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = cross_entropy(head(xx, dict(params, embed={"table": table})),
                                 labs)
            return torch.autograd.grad(loss, [table, xx])
    c, _ = counted(step, x)
    res["head"][shape] = c.flops

# hand counts on (data=2, model=4)
with torch.no_grad():
    x = dt((64, 256), (None, "model"))
    w = dt((256, 128), ("model", None))
    c, y = counted(lambda a, b: (a @ b).redistribute(dm, [Replicate()] * 2),
                   x, w)
    res["row_parallel"] = dict(c.as_dict(), out_placements=str(y.placements))
    c, _ = counted(lambda a, b: a @ b, dt((64, 256), ()), dt((256, 128), ()))
    res["replicated_flops"] = c.flops
    c, _ = counted(lambda a, b: a @ b, dt((64, 256), ()),
                   dt((256, 128), (None, ("data", "model"))))
    res["sharded_flops"] = c.flops
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def dryrun_result(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT "):]), out, r.stdout


@pytest.mark.parametrize("mesh", ["mesh2x4", "mesh2x2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_cell_records_ok(dryrun_result, shape, mesh):
    res, out, stdout = dryrun_result
    rec = res["cells"][f"{shape}/{mesh}"]
    assert rec["ok"], rec.get("traceback")
    assert f"[OK ] qwen3-0.6b-smoke__{shape}__{mesh}" in stdout
    on_disk = json.loads(
        (out / f"qwen3-0.6b-smoke__{shape}__{mesh}.json").read_text())
    assert on_disk["ok"] and on_disk["hlo_flops"] == rec["hlo_flops"]
    for key in ("hlo_flops", "hlo_bytes", "hlo_flops_scaled",
                "hlo_bytes_scaled", "collective_wire_bytes_scaled",
                "argument_size_in_bytes", "output_size_in_bytes"):
        assert rec[key] > 0, key
    assert rec["hlo_flops_scaled"] == rec["hlo_flops"]
    assert rec["chips"] == (8 if mesh == "mesh2x4" else 16)
    for key in ("lower_s", "compile_s", "total_s"):
        assert rec[key] >= 0
    assert rec["stage"]["num_stages"] == get_config("qwen3-0.6b").smoke() \
        .num_stages


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_step_flops_are_stages_plus_embedding_and_head(dryrun_result, shape):
    """Exact for prefill. In a decode step a stage's input is what the
    stage before left (the reference's decode stages carry no
    constraint), and in a train step the gradients reach each stage as
    the next one's backward leaves them, so DTensor plans a few products
    otherwise than for a stage traced alone: about 1 % of the FLOPs,
    held within 2 %."""
    res, _, _ = dryrun_result
    rec = res["cells"][f"{shape}/mesh2x4"]
    st = rec["stage"]
    assert st["flops"] > 0 and st["bytes"] > 0
    parts = st["num_stages"] * st["flops"] + res["head"][shape]
    if shape == "prefill_32k":
        assert rec["hlo_flops"] == parts
    else:
        assert abs(rec["hlo_flops"] - parts) <= 0.02 * parts


def test_collective_and_flop_counts_match_a_hand_count(dryrun_result):
    res, _, _ = dryrun_result
    row = res["row_parallel"]
    # (64, 256/4) @ (256/4, 128) on each rank, then one all-reduce over the
    # model axis of the (64, 128) float32 partial sums
    assert row["flops"] == 2 * 64 * 64 * 128
    assert row["collectives"]["count_by_op"] == {"all-reduce": 1}
    assert row["collectives"]["bytes_by_op"] == {"all-reduce": 64 * 128 * 4}
    assert row["collectives"]["wire_bytes"] == 2 * 64 * 128 * 4
    assert res["replicated_flops"] == 2 * 64 * 256 * 128
    assert res["sharded_flops"] == 2 * 64 * 256 * 128 // 8


def test_analysis_reads_the_dryrun_records(dryrun_result, tmp_path):
    _, out, _ = dryrun_result
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert len(recs) == 6
    for rec in recs:
        rec["arch"] = "qwen3-0.6b"         # model_flops_for's registry name
        (tmp_path / f"{rec['shape']}__{rec['mesh']}.json").write_text(
            json.dumps(rec))
    rows = tanalysis.load_all(str(tmp_path))
    assert len(rows) == 6
    for r in rows:
        assert r.compute_s > 0 and r.memory_s > 0 and r.collective_s > 0
        assert r.step_s == max(r.compute_s, r.memory_s, r.collective_s)
        chips = 8 if r.mesh == "mesh2x4" else 16
        shp = SHAPES[r.shape]
        assert r.model_flops_per_dev == tanalysis.model_flops_for(
            "qwen3-0.6b", r.shape, r.kind, shp.global_batch,
            shp.seq_len) / chips
