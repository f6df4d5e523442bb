"""The port's sharding rules equal the reference's.

  * ``spec_for_param`` of every parameter path of every arch (stacked and
    not, with and without the leaf's rank) equals the reference's
    ``PartitionSpec`` as tuples; the port's parameter tree has the
    reference's paths and shapes.
  * ``_filter_spec``, ``_fit_dims`` and ``launch.shardings._fit`` agree
    with the reference's on the (16, 16) and (2, 16, 16) axis sizes, and
    so do ``param_specs``' fitted specs, leaf for leaf. A stand-in mesh
    carries ``axis_names`` and ``devices.shape``: both packages' rules
    read nothing else, and no process group is started in the test
    process.
  * The counterparts of ``tests/test_distributed.py``'s
    ``test_param_specs_cover_tree``, ``test_decode_state_specs_cover_tree``
    and ``test_no_large_param_replicated``.
  * Without a mesh, ``constraint`` is the identity, and qwen3-0.6b
    ``smoke()``'s ``forward_fn`` and ``decode_step_fn`` over the
    reference's weights give the reference's logits and state within
    1e-4 (the GQA branch and the constraints are live only on a mesh).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import shardings as jshardings
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import P, tree_paths
from repro_torch.launch import shardings as tshardings
from repro_torch.models import transformer

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TOL = dict(atol=1e-4, rtol=1e-4)


def _mesh(name: str) -> SimpleNamespace:
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_shapes(cfg) -> dict:
    return jsh.tree_paths(jax.eval_shape(
        lambda key: jtf.init_params(cfg, key),
        jax.ShapeDtypeStruct((2,), jnp.uint32)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_param_equals_reference(arch):
    ref = _ref_shapes(jconfigs.get_config(arch))
    port = tree_paths(tshardings.param_shapes(get_config(arch)))
    assert list(port) == list(ref)
    for path, leaf in ref.items():
        assert tuple(port[path].shape) == tuple(leaf.shape), path
        for stacked in (False, True):
            for ndim in (None, leaf.ndim - 1, leaf.ndim):
                got = tsh.spec_for_param(path, stacked, ndim)
                want = jsh.spec_for_param(path, stacked, ndim)
                assert isinstance(got, P)
                assert tuple(got) == tuple(want), (path, stacked, ndim)


SPECS = [((), (8, 4)), (("data",), (32, 4)), (("data", "model"), (32, 48)),
         ((("pod", "data"), None), (64, 3)), ((("pod", "data"),), (16, 5)),
         (("model", "data", None), (384, 7168, 2048)),
         ((None, "model", None), (61, 8, 128)), (("model",), (4,)),
         ((("data", "model"), None), (512, 2)), (("pod", "model"), (2, 17)),
         (("bogus", ("pod", "bogus"), None), (4, 4, 4))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_filter_and_fit_agree_with_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for spec, shape in SPECS:
        f_port = tsh._filter_spec(P(*spec), mesh)
        f_ref = jsh._filter_spec(jsh.P(*spec), mesh)
        assert tuple(f_port) == tuple(f_ref), spec
        assert tuple(tsh._fit_dims(f_port, shape, mesh)) == \
            tuple(jsh._fit_dims(f_ref, shape, mesh)), spec
        assert tuple(tshardings._fit(f_port, shape, mesh)) == \
            tuple(jshardings._fit(f_ref, shape, mesh)), spec
    assert tshardings.dp_axes(mesh) == jshardings.dp_axes(mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_translate_specs(mesh_name):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh(mesh_name)
    n = len(mesh.axis_names)
    dp = ("pod", "data") if n == 3 else "data"
    assert tsh.placements(P(dp, None, "model"), mesh) == \
        (Shard(0),) * (n - 1) + (Shard(2),)
    assert tsh.placements(P(None, "model"), mesh) == \
        (Replicate(),) * (n - 1) + (Shard(1),)
    assert tsh.placements(P(), mesh) == (Replicate(),) * n


def _local(shape, spec, mesh) -> tuple:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = list(shape)
    for d, e in enumerate(spec):
        for a in () if e is None else e if isinstance(e, tuple) else (e,):
            out[d] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_rules(arch, mesh_name):
    """Every leaf gets a sharding of at most its rank, the reference's
    fitted spec; the moments mirror it in float32."""
    mesh = _mesh(mesh_name)
    specs = tree_paths(tshardings.param_specs(get_config(arch), mesh))
    ref = _ref_shapes(jconfigs.get_config(arch))
    assert list(specs) == sorted(ref)
    for path, sds in specs.items():
        stacked = path.startswith("stages")
        nd = len(sds.shape)
        want = jsh.spec_for_param(path, stacked, nd - 1 if stacked else nd)
        want = jshardings._fit(jsh._fit_dims(
            jsh._filter_spec(jsh.P(*tuple(want)[:nd]), mesh), sds.shape,
            mesh), sds.shape, mesh)
        assert len(sds.sharding.spec) <= nd
        assert tuple(sds.sharding.spec) + (None,) * (
            nd - len(sds.sharding.spec)) == tuple(want) + (None,) * (
            nd - len(want)), path
        assert sds.local_shape == _local(sds.shape, want, mesh), path
    opt = tshardings.opt_specs(tshardings.param_specs(get_config(arch),
                                                      mesh), mesh)
    for m in tree_paths(opt.m).values():
        assert m.dtype == torch.float32
    assert opt.step.shape == ()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b",
                                  "xlstm-1.3b", "kimi-k2-1t-a32b"])
def test_decode_state_specs_cover_tree(arch):
    mesh = _mesh("pod16x16")
    st = tshardings.decode_state_specs(get_config(arch),
                                       SHAPES["decode_32k"], mesh)
    assert "cache_len" in st
    ref = jsh.tree_paths(jax.eval_shape(
        lambda: jtf.init_decode_state(jconfigs.get_config(arch), 128,
                                      32_768)))
    got = tree_paths(st)
    assert sorted(got) == sorted(ref)
    for path, sds in got.items():
        assert sds.sharding is not None
        assert tuple(sds.shape) == tuple(ref[path].shape), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_large_param_replicated(arch):
    """Every big layer weight is sharded on the production mesh."""
    for path, leaf in tree_paths(
            tshardings.param_shapes(get_config(arch))).items():
        if leaf.numel() < 2_000_000:
            continue
        stacked = path.startswith("stages")
        spec = tsh.spec_for_param(path, stacked,
                                  leaf.dim() - 1 if stacked else leaf.dim())
        assert any(e is not None for e in spec), \
            f"{arch}: {path} {tuple(leaf.shape)} would be replicated"


def test_constraint_is_identity_without_mesh():
    x = torch.randn(4, 6)
    assert tsh.active_mesh() is None
    assert tsh.constraint(x, "data", "model") is x
    assert tsh.axis_size("model") == 1
    with pytest.raises(RuntimeError, match="no active mesh"):
        tsh.named_sharding("data")
    mesh = _mesh("pod16x16")
    with tsh.use_mesh(mesh):
        assert tsh.active_mesh() is mesh
        assert tsh.axis_size("model") == 16 and tsh.axis_size("pod") == 1
        assert tsh.named_sharding("pod", "data").spec == P(None, "data")
    assert tsh.active_mesh() is None


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def test_forward_and_decode_without_mesh_equal_reference():
    jcfg = jconfigs.get_config("qwen3-0.6b").smoke()
    cfg = get_config("qwen3-0.6b").smoke()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = _torch_tree(params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    for mode in ("all", "last"):
        want, _ = jtf.forward(params, jcfg, jnp.asarray(tokens),
                              logits_mode=mode)
        got, _ = transformer.forward_fn(tparams, cfg,
                                        torch.tensor(tokens),
                                        logits_mode=mode)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    _, state = jtf.prefill(params, jcfg, jnp.asarray(tokens), 16)
    nxt = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
    want, want_state = jtf.decode_step(params, jcfg, state,
                                       jnp.asarray(nxt))
    got, got_state = transformer.decode_step_fn(
        tparams, cfg, _torch_tree(state), torch.tensor(nxt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_paths = jsh.tree_paths(want_state)
    got_paths = tree_paths(got_state)
    assert sorted(got_paths) == sorted(want_paths)
    for path, leaf in want_paths.items():
        np.testing.assert_allclose(got_paths[path].numpy(),
                                   np.asarray(leaf), **TOL)
