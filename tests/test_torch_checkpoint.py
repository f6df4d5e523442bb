"""The moment pool, the SECDED checkpoints and the recovery ladder.

``store_tree`` of the same tree (float32, bfloat16 and integer leaves, the
moment tree of the reference's ``adamw.init``) gives the pool storage and
table of contents of the reference's ``poolstore``, bit for bit;
``load_tree`` round trips it, and planted single and double flips give
the reference's worst status. A checkpoint written by either package
restores in the other with equal arrays, manifests, ``.npz`` payloads and
``RestoreReport``s, also after single and double flips in an ``.npz``.
The recovery ladder's rungs run on the port's trainer as
``tests/test_fault_tolerance.py`` runs them on the reference's, and the
training launcher prints the reference's two lines.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs.base import ModelConfig as JConfig
from repro.core import poolstore as jps
from repro.core.layouts import Layout as JLayout
from repro.core.pool import make_pool as jmake_pool
from repro.distributed.sharding import tree_paths as jtree_paths
from repro.models import transformer as jtransformer
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import injection
from repro_torch.core import poolstore as tps
from repro_torch.core.layouts import Layout
from repro_torch.core.pool import make_pool
from repro_torch.distributed.fault_tolerance import recover
from repro_torch.distributed.sharding import tree_map, tree_paths
from repro_torch.kernels import common
from repro_torch.launch import train as train_launch
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_trainer

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(name="tiny-ft", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, dtype="float32")


def _np_tree(seed: int) -> dict:
    """A tree with float32, bfloat16, int and odd-sized leaves, keys
    deliberately unsorted (each package keeps a tree's own order)."""
    rng = np.random.default_rng(seed)
    return {
        "z": {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(ml_dtypes.bfloat16)},
        "a": rng.standard_normal((17, 3)).astype(ml_dtypes.bfloat16),
        "step": np.int32(9),
        "count": np.int64(123456789012),
        "u": rng.integers(0, 255, (13,)).astype(np.uint8),
    }


def _bits(x) -> np.ndarray:
    """Any leaf's bytes (a tensor's, a numpy array's or a jax array's)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_leaves(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]),
                                      err_msg=path)
        assert tuple(got[path].shape) == tuple(np.shape(want[path])), path
        assert tps.DTYPE_NAMES[got[path].dtype] == \
            str(np.asarray(want[path]).dtype), path


def _pools(rows: int):
    return (jmake_pool(rows, JLayout.INTERWRAP, boundary=0, row_words=16),
            make_pool(rows, Layout.INTERWRAP, boundary=0, row_words=16,
                      device="cpu"))


def _toc(toc) -> tuple:
    return ([(p, dataclasses.astuple(e)) for p, e in toc.entries.items()],
            toc.total_pages)


def test_store_tree_storage_and_toc_equal_the_reference():
    tree = _np_tree(0)
    rows = jps.required_rows(tree, row_words=16)
    assert tps.required_rows(tree_map_np(tree), row_words=16) == rows
    jpool, tpool = _pools(rows + 8)
    jpool, jtoc = jps.store_tree(jpool, tree, first_page=3)
    tpool, ttoc = tps.store_tree(tpool, tree_map_np(tree), first_page=3)
    assert _toc(ttoc) == _toc(jtoc)
    np.testing.assert_array_equal(common.to_u32(tpool.storage),
                                  np.asarray(jpool.storage))
    back, worst = tps.load_tree(tpool, ttoc, tree, first_page=3)
    assert worst == 0
    _same_leaves(tree_paths(back), tree_paths(tree))
    with pytest.raises(ValueError):
        tps.store_tree(tpool, tree_map_np(tree), first_page=rows + 8)


def tree_map_np(tree):
    """The numpy tree as the port takes it: tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: tree_map_np(v) for k, v in tree.items()}
    return tps.as_tensor(tree)


def test_moment_pool_of_the_trainer_tree_is_the_reference_pool():
    """The reference's moment tree (sorted keys at every level, from
    jax.tree.map) and the port's (adamw.init over params_tree) lay out the
    same pages: the pool storage and table of contents are equal."""
    jparams = jtransformer.init_params(JConfig(**TINY), jax.random.key(0))
    rng = np.random.default_rng(1)
    jm = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape),
                                            jnp.float32), jparams)
    jv = jax.tree.map(lambda p: p * p, jm)
    jtree = {"m": jm, "v": jv}
    ttree = tree_map(lambda a: tps.as_tensor(np.asarray(a)), jtree)
    state = adamw.init(tree_map(lambda a: tps.as_tensor(np.asarray(a)),
                                jparams))
    assert list(tree_paths(state.m)) == list(jtree_paths(jm))
    rows = jps.required_rows(jtree, row_words=16)
    jpool, tpool = _pools(rows)
    jpool, jtoc = jps.store_tree(jpool, jtree)
    tpool, ttoc = tps.store_tree(tpool, ttree)
    assert _toc(ttoc) == _toc(jtoc)
    np.testing.assert_array_equal(common.to_u32(tpool.storage),
                                  np.asarray(jpool.storage))


@pytest.mark.parametrize("flips,worst", [
    ([(0, 0, 3, 5)], 1), ([(0, 8, 1, 2)], 2),
    ([(0, 1, 7, 4), (0, 1, 7, 9)], 3), ([(0, 2, 0, 1), (0, 5, 2, 30)], 1)])
def test_load_tree_flips_give_the_reference_worst_status(flips, worst):
    tree = _np_tree(2)                 # one page: the flips hit row 0
    rows = jps.required_rows(tree, row_words=16)
    jpool, tpool = _pools(rows)
    jpool, jtoc = jps.store_tree(jpool, tree)
    tpool, ttoc = tps.store_tree(tpool, tree_map_np(tree))
    recs = [injection.FlipRecord(*f) for f in flips]
    tpool = dataclasses.replace(tpool, storage=injection.apply_flips(
        tpool.storage, recs))
    arr = np.asarray(jpool.storage).copy()
    for r, lane, word, bit in flips:
        arr[r, lane, word] ^= np.uint32(1 << bit)
    jpool = dataclasses.replace(jpool, storage=jnp.asarray(arr))
    jback, jworst = jps.load_tree(jpool, jtoc, tree)
    tback, tworst = tps.load_tree(tpool, ttoc, tree)
    assert tworst == jworst == worst
    got, want = tree_paths(tback), tree_paths(jback)
    # the reference hands its leaves to jnp.asarray, which narrows the
    # int64 leaf to int32 with JAX's x64 off; the port keeps int64
    assert want.pop("count").dtype == jnp.int32
    count = got.pop("count")
    assert count.dtype == torch.int64 and int(count) == 123456789012
    _same_leaves(got, want)


def _files(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".npz"):
            z = np.load(path)
            out[name] = {k: z[k] for k in z.files}
        else:
            with open(path) as f:
                out[name] = json.load(f)
    return out


def _same_files(a: str, b: str) -> None:
    fa, fb = _files(a), _files(b)
    assert list(fa) == list(fb)
    for name in fa:
        if name.endswith(".npz"):
            assert list(fa[name]) == list(fb[name])
            for k in fa[name]:
                assert fa[name][k].dtype == fb[name][k].dtype == np.uint32
                np.testing.assert_array_equal(fa[name][k], fb[name][k])
        else:
            assert fa[name] == fb[name]
    with open(os.path.join(a, "manifest.json")) as f, \
            open(os.path.join(b, "manifest.json")) as g:
        assert list(json.load(f)["leaves"]) == list(json.load(g)["leaves"])


@pytest.mark.parametrize("protect", [True, False])
def test_checkpoints_cross_restore_between_the_packages(tmp_path, protect):
    tree = _np_tree(3)
    jc = jck.Checkpointer(str(tmp_path / "j"), protect=protect)
    tc = tck.Checkpointer(str(tmp_path / "t"), protect=protect,
                          device="cpu")
    jc.save(7, tree)              # numpy leaves, written as they are
    tc.save(7, tree_map_np(tree))
    _same_files(jc.step_dir(7), tc.step_dir(7))
    assert tc.latest_step() == jc.latest_step() == 7
    # each package restores the other's checkpoint
    for writer in (jc, tc):
        jflat, jrep = jck.Checkpointer(writer.dir).restore(7)
        tflat, trep = tck.Checkpointer(writer.dir, device="cpu").restore(7)
        assert dataclasses.astuple(trep) == dataclasses.astuple(jrep)
        assert trep.clean
        _same_leaves(tflat, jflat)
        _same_leaves(tflat, tree_paths(tree))
    like = tree_map_np(tree)
    back, _ = tc.restore(7, like=like)
    assert list(tree_paths(back)) == list(tree_paths(like))
    sub = tc.restore_leaves(7, ["z/b", "count"])
    _same_leaves(sub, {k: tree_paths(tree)[k] for k in ("z/b", "count")})


@pytest.mark.parametrize("bits,status", [((5,), "corrected"),
                                         ((3, 11), "corrupt")])
def test_flipped_npz_gives_equal_restore_reports(tmp_path, bits, status):
    tree = _np_tree(4)
    tc = tck.Checkpointer(str(tmp_path), device="cpu")
    tc.save(1, tree_map_np(tree))
    path = os.path.join(tc.step_dir(1), "z__w.npz")
    z = np.load(path)
    data, codes = z["data"].copy(), z["codes"].copy()
    for b in bits:               # one beat (words 2 and 3): same codeword
        data[2] ^= np.uint32(1 << b)
    np.savez(path, data=data, codes=codes)
    jflat, jrep = jck.Checkpointer(str(tmp_path)).restore(1)
    tflat, trep = tc.restore(1)
    assert dataclasses.astuple(trep) == dataclasses.astuple(jrep)
    want = ([], ["z/w"]) if status == "corrupt" else (["z/w"], [])
    assert (trep.corrected_leaves, trep.corrupt_leaves) == want
    _same_leaves(tflat, jflat)
    if status == "corrected":
        _same_leaves(tflat, tree_paths(tree))


# -- the recovery ladder, as tests/test_fault_tolerance.py runs it -----------


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ft"))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=40,
                       scrub_every=0, checkpoint_every=5)
    tr = make_trainer(ModelConfig(**TINY), tcfg, ckpt_dir=tmp, seq_len=32,
                      global_batch=4, device="cpu")
    tr.run(6)
    return tr


def test_rung1_scrub_repair(trainer):
    rng = np.random.default_rng(0)
    trainer.snapshot_moments()
    stor, _ = injection.inject_flips(trainer.moment_pool.storage, rng, 4)
    trainer.moment_pool = dataclasses.replace(trainer.moment_pool,
                                              storage=stor)
    rep = recover(trainer, "sdc_single_bit")
    assert rep.rung == "scrub-repair"
    assert rep.details["corrected"] == 4


def test_rung2_targeted_restore(trainer):
    rep = recover(trainer, "sdc_multi_bit")
    assert rep.rung == "targeted-restore"
    assert rep.details["restored_at_step"] == 5


def test_rung3_warm_restart(trainer):
    trainer.snapshot_moments()
    before = {k: [t.clone() for t in tree_paths(getattr(
        trainer.opt_state, k)).values()] for k in ("m", "v")}
    rep = recover(trainer, "process_crash")
    assert rep.rung == "warm-restart"
    assert rep.details["worst_status"] == 0
    for k in ("m", "v"):
        for a, b in zip(before[k], tree_paths(getattr(
                trainer.opt_state, k)).values()):
            assert torch.equal(a, b)


def test_rung4_warm_restart_falls_to_cold_on_uncorrectable_pages(trainer):
    trainer.snapshot_moments()
    recs = [injection.FlipRecord(0, 0, 0, 1), injection.FlipRecord(0, 0, 0, 2)]
    trainer.moment_pool = dataclasses.replace(
        trainer.moment_pool,
        storage=injection.apply_flips(trainer.moment_pool.storage, recs))
    rep = recover(trainer, "process_crash")
    assert rep.rung == "cold-restart" and rep.details["restored"]
    trainer.snapshot_moments()


def test_rung5_cold_restart(trainer):
    step_before = trainer.step
    rep = recover(trainer, "host_loss")
    assert rep.rung == "cold-restart" and rep.details["restored"]
    assert trainer.step <= step_before
    log = trainer.run(2)
    assert len(log) >= 2
    with pytest.raises(ValueError):
        recover(trainer, "meteor")


def test_restore_refuses_an_uncorrectable_checkpoint(tmp_path):
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=40,
                       scrub_every=0, checkpoint_every=2)
    tr = make_trainer(ModelConfig(**TINY), tcfg, ckpt_dir=str(tmp_path),
                      seq_len=32, global_batch=4, device="cpu")
    tr.run(2)
    path = os.path.join(tr.checkpointer.step_dir(2),
                        "params__final_norm.npz")
    z = np.load(path)
    data = z["data"].copy()
    data[0] ^= np.uint32(3)
    np.savez(path, data=data, codes=z["codes"])
    with pytest.raises(RuntimeError, match="uncorrectable"):
        tr.restore()


# -- the launcher -------------------------------------------------------------


def test_train_launcher_prints_both_lines(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--smoke", "--steps", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(args, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300, check=True).stdout
    assert first.startswith("qwen3-0.6b-smoke: loss ")
    assert first.strip().endswith("over 4 steps")
    second = subprocess.run(args, capture_output=True, text=True, env=env,
                            cwd=ROOT, timeout=300, check=True).stdout
    lines = second.strip().splitlines()
    assert lines[0] == "resumed at step 4"
    assert lines[1].startswith("qwen3-0.6b-smoke: loss ")


def test_train_launcher_refuses_tpu_meshes(monkeypatch):
    """``--production-mesh`` (with ``--multi-pod``: the 512-rank mesh)
    goes through ``make_production_mesh``, which raises its world-size
    error in one process."""
    built = []
    real = train_launch.make_production_mesh

    def spy(**kw):
        built.append(kw)
        return real(**kw)

    monkeypatch.setattr(train_launch, "make_production_mesh", spy)
    for flags, ranks in ((["--production-mesh"], 256),
                         (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks; the "
                           "process group has 1"):
            train_launch.main(["--arch", "qwen3-0.6b", "--smoke", *flags,
                               "--device", "cpu"])
    assert built == [{"multi_pod": False}, {"multi_pod": True}]
