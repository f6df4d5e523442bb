"""The port's training path against the reference's on the CPU.

At the ``TINY`` config of ``tests/test_fault_tolerance.py`` (float32): a
reference trainer and a port trainer start from the reference's
parameters and take the reference's batches; after 3 steps the losses,
grad norms, parameters and moments agree within 1e-5 relative (each
leaf's largest difference against its largest magnitude), for ``remat``
none and block and microbatch None and 2, and with int8 gradient
compression. Also: the parameter tree's paths and leaf order, the loss
against the serving model's, ``count_params``, the cosine schedule (to a
float32 ulp), the int8 round trip (one quantum), the Zipf logits (equal),
the stream's determinism and motif, ``reshard_tree`` / ``plan_remesh``,
and the flash wrapper's refusal under autograd.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import TrainConfig as JTrain
from repro.configs.registry import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.distributed import elastic as jel
from repro.distributed.sharding import tree_paths as jtree_paths
from repro.models import count_params as jcount_params
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train.trainer import make_trainer as jmake_trainer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import elastic as tel
from repro_torch.distributed.sharding import (tree_leaves, tree_map,
                                              tree_paths, tree_unflatten)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import (build_model, count_params, load_jax_params,
                                params_tree, transformer)
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_trainer

TINY = dict(name="tiny-ft", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, dtype="float32")
SEQ, BATCH, STEPS = 32, 4, 3


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rel: float, what: str) -> None:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        what, np.abs(got - want).max(), scale)


class RefBatches:
    """The reference stream's batches, as the port's trainer takes them."""

    def __init__(self, stream):
        self.stream = stream

    def batch(self, step: int) -> dict:
        b = self.stream.batch(step)
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _pair(remat: str = "none", micro=None, compression: str = "none"):
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=40,
              scrub_every=0, checkpoint_every=0, remat=remat,
              microbatch=micro, grad_compression=compression)
    ref = jmake_trainer(JConfig(**TINY), JTrain(**kw), seq_len=SEQ,
                        global_batch=BATCH)
    port = make_trainer(ModelConfig(**TINY), TrainConfig(**kw), seq_len=SEQ,
                        global_batch=BATCH, device="cpu")
    port.load_params(jax.tree.map(np.asarray, ref.params))
    port.data = RefBatches(ref.data)
    return ref, port


@pytest.mark.parametrize("micro", [None, 2])
@pytest.mark.parametrize("remat", ["none", "block"])
def test_three_steps_match_the_reference(remat, micro):
    ref, port = _pair(remat, micro)
    jlog, tlog = ref.run(STEPS), port.run(STEPS)
    for j, t in zip(jlog, tlog):
        for k in ("loss", "grad_norm"):
            _close(t[k], j[k], 1e-5, k)
        assert t["step"] == j["step"]
    assert int(port.opt_state.step) == int(ref.opt_state.step) == STEPS
    jp, tp = jtree_paths(ref.params), tree_paths(port.params)
    assert list(tp) == list(jp)
    for path in jp:
        _close(tp[path], jp[path], 1e-5, path)
    for name in ("m", "v"):
        jm = jtree_paths(getattr(ref.opt_state, name))
        tm = tree_paths(getattr(port.opt_state, name))
        assert list(tm) == list(jm)
        for path in jm:
            _close(tm[path], jm[path], 1e-5, f"{name}/{path}")
            assert tm[path].dtype == torch.float32


def test_int8_compressed_steps_match_the_reference():
    ref, port = _pair(compression="int8")
    jlog, tlog = ref.run(2), port.run(2)
    for j, t in zip(jlog, tlog):
        _close(t["loss"], j["loss"], 1e-5, "loss")
        _close(t["grad_norm"], j["grad_norm"], 1e-4, "grad_norm")


def test_params_tree_is_the_reference_tree():
    jcfg, cfg = JConfig(**TINY), ModelConfig(**TINY)
    jparams = jtransformer.init_params(jcfg, jax.random.key(3))
    model = load_jax_params(build_model(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    tree = params_tree(model)
    jflat, tflat = jtree_paths(jparams), tree_paths(tree)
    assert list(tflat) == list(jflat)
    for path in jflat:
        np.testing.assert_array_equal(_np(tflat[path]),
                                      np.asarray(jflat[path]))
    # the leaves are the trainer's own: no parameter of the model is shared
    own = {p.data_ptr() for p in model.parameters()}
    assert not own & {t.data_ptr() for t in tree_leaves(tree)}
    # the moment tree's leaf order is the reference's too
    assert list(tree_paths(adamw.init(tree).m)) == \
        list(jtree_paths(jadamw.init(jparams).m))
    # an untied head is exported as lm_head/w
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    t2 = params_tree(build_model(untied, device="cpu"))
    assert list(t2) == ["embed", "final_norm", "lm_head", "stages"]
    assert tuple(t2["lm_head"]["w"].shape) == (64, 256)


def test_grad_loss_equals_the_serving_loss_and_the_reference():
    jcfg, cfg = JConfig(**TINY), ModelConfig(**TINY)
    jparams = jtransformer.init_params(jcfg, jax.random.key(4))
    model = load_jax_params(build_model(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labs = rng.integers(0, 256, (2, 16)).astype(np.int32)
    want = float(jtransformer.loss_fn(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(labs)))
    tree = tree_map(lambda p: p.requires_grad_(True), params_tree(model))
    for remat in ("none", "block", "full"):
        loss = transformer.loss_fn(tree, cfg, torch.as_tensor(toks),
                                   torch.as_tensor(labs), remat=remat)
        assert loss.requires_grad
        _close(loss, want, 1e-6, remat)
    served = model.loss(torch.as_tensor(toks), torch.as_tensor(labs))
    assert not served.requires_grad          # serving stays grad-free
    _close(served, want, 1e-6, "served")
    with pytest.raises(ValueError):
        transformer.loss_fn(tree, cfg, torch.as_tensor(toks),
                            torch.as_tensor(labs), remat="some")


def test_remat_gives_the_same_gradient():
    cfg = ModelConfig(**TINY)
    tree = params_tree(build_model(cfg, seed=2, device="cpu"))
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                         .manual_seed(0))
    grads = {}
    for remat in ("none", "block"):
        t = tree_map(lambda p: p.detach().requires_grad_(True), tree)
        loss = transformer.loss_fn(t, cfg, toks, toks, remat=remat)
        grads[remat] = torch.autograd.grad(loss, tree_leaves(t))
    for a, b in zip(grads["none"], grads["block"]):
        _close(b, a, 1e-6, "remat grad")


def test_flash_wrapper_raises_under_autograd():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.attention(q, k, k)
    with torch.no_grad():
        assert fa.attention(q, k, k).shape == q.shape
    cfg = ModelConfig(**TINY)
    tree = tree_map(lambda p: p.requires_grad_(True),
                    params_tree(build_model(cfg, device="cpu")))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        transformer.loss_fn(tree, cfg, toks, toks, attn_impl="flash")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-7b",
                                  "musicgen-large"])
def test_count_params_equals_the_reference(arch):
    assert count_params(get_config(arch)) == jcount_params(jget_config(arch))
    assert count_params(get_config(arch).smoke()) == \
        jcount_params(jget_config(arch).smoke())
    assert count_params(ModelConfig(**TINY)) == jcount_params(JConfig(**TINY))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3, warmup_steps=2, total_steps=40), dict(),
    dict(warmup_steps=0, total_steps=7)])
def test_cosine_schedule_equals_the_reference(kw):
    j, t = jadamw.cosine_schedule(JTrain(**kw)), \
        adamw.cosine_schedule(TrainConfig(**kw))
    for s in range(0, 130, 3):
        got = t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(jnp.int32(s))),
                                   rtol=1e-6, atol=0)


def test_int8_round_trip_within_one_quantum():
    g = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32)
    jq, js = jadamw.compress_int8(jnp.asarray(g))
    tq, ts = adamw.compress_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    assert float(ts) == float(js)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1
    back = adamw.decompress_int8(tq, ts).numpy()
    assert np.abs(back - g).max() <= float(ts)
    np.testing.assert_allclose(
        back, np.asarray(jadamw.decompress_int8(jq, js)), rtol=0,
        atol=float(ts))
    tree = {"a": torch.from_numpy(g), "b": torch.zeros(3)}
    out = adamw.maybe_compress_grads(tree, "int8")
    assert torch.equal(out["b"], torch.zeros(3))
    assert adamw.maybe_compress_grads(tree, "none") is tree
    with pytest.raises(ValueError):
        adamw.maybe_compress_grads(tree, "topk")


@pytest.mark.parametrize("vocab", [256, 151936])
def test_zipf_logits_equal_the_reference(vocab):
    np.testing.assert_array_equal(
        tpipe._zipf_logits(tpipe.DataConfig(vocab, 8, 2)),
        jpipe._zipf_logits(jpipe.DataConfig(vocab, 8, 2)))


def test_stream_is_deterministic_with_a_motif_every_8th_position():
    cfg = tpipe.DataConfig(vocab_size=512, seq_len=40, global_batch=4,
                           seed=7)
    a = tpipe.SyntheticStream(cfg, device="cpu")
    b = tpipe.SyntheticStream(cfg, device="cpu")
    for step in (0, 3):
        x, y = a.batch(step), b.batch(step)
        assert torch.equal(x["tokens"], y["tokens"])
        assert x["tokens"].dtype == torch.int32
        assert tuple(x["tokens"].shape) == (4, 40)
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
        seq = torch.cat([x["tokens"], x["labels"][:, -1:]], dim=1)
        motif = seq[:, 0::8]
        assert (motif == motif[:, :1]).all()
        assert int(seq.min()) >= 0 and int(seq.max()) < 512
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    s0 = tpipe.SyntheticStream(cfg, num_shards=2, shard_id=0, device="cpu")
    s1 = tpipe.SyntheticStream(cfg, num_shards=2, shard_id=1, device="cpu")
    assert s0.local_batch == 2
    assert not torch.equal(s0.batch(0)["tokens"], s1.batch(0)["tokens"])
    other = tpipe.SyntheticStream(dataclasses.replace(cfg, seed=8),
                                  device="cpu")
    assert not torch.equal(other.batch(0)["tokens"], a.batch(0)["tokens"])
    with pytest.raises(ValueError):
        tpipe.SyntheticStream(cfg, num_shards=3, device="cpu")
    step, first = next(a.batches(5))
    assert step == 5 and torch.equal(first["tokens"], a.batch(5)["tokens"])


def test_reshard_and_remesh_equal_the_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 3)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "s": np.float32(2.5), "odd": np.arange(5)}
    for n in (1, 2, 4):
        got, want = tel.reshard_tree(tree, n), jel.reshard_tree(tree, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        back_t, back_j = tel.reshard_tree(got, 1), jel.reshard_tree(want, 1)
        for k in tree:
            np.testing.assert_array_equal(back_t[0][k], back_j[0][k])
    for old, new, axis in ((512, 496, 16), (512, 250, 16), (8, 8, 2),
                           (16, 7, 4)):
        assert tel.plan_remesh(old, new, axis) == \
            jel.plan_remesh(old, new, axis)


def test_tree_helpers_follow_jax_tree_order():
    tree = {"b": {"y": torch.ones(2), "x": torch.zeros(1)},
            "a": [torch.ones(1), torch.ones(3)]}
    mapped = tree_map(lambda t: t + 1, tree)
    assert list(mapped) == ["a", "b"] and list(mapped["b"]) == ["x", "y"]
    jt = jax.tree.map(lambda t: t + 1, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree))
    assert list(tree_paths(mapped)) == list(jtree_paths(jt))
    leaves = tree_leaves(tree)
    back = tree_unflatten(tree, [t * 2 for t in leaves])
    assert list(tree_paths(back)) == list(tree_paths(tree))
    assert torch.equal(back["b"]["y"], 2 * torch.ones(2))
