"""The port's public surface, name by name, against the reference's.

Reads both trees with :mod:`ast` and imports neither. For each module of
``src/repro/`` other than the Pallas ``kernel.py`` files, the port module
at the same relative path under ``src/repro_torch/`` must hold:

  * every public top-level name (a ``def``, ``class`` or assignment);
  * every public member of each public class;
  * in an ``__init__.py``, every public name it imports or lists in
    ``__all__``;
  * every parameter of a public function or method (a public class's
    ``__init__`` too), by name, and where the reference's has a default,
    with a default.

An item the port lacks must match a row of :data:`EXCEPTIONS`, which
names the port's counterpart (asserted to exist) and gives the reason.
This test is what "the port does all that the JAX package does" means.
"""
from __future__ import annotations

import ast
import fnmatch
from functools import cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: (reference items, port counterparts, reason). An item is
#: ``<module path>:<name>``, ``<module path>:<Class>.<member>``,
#: ``<module path>:<function>(<parameter>)`` or, for a parameter with a
#: default, ``<module path>:<function>(<parameter>=)``, the module path
#: relative to the package root; patterns are :func:`fnmatch.fnmatch`'s.
#: A counterpart is a port item (or a file under the package) that must
#: exist; None only where the reference's name has no use in the port.
EXCEPTIONS: list[tuple[tuple[str, ...], tuple[str, ...] | None, str]] = [
    (("kernels/common.py:use_interpret",), None,
     "Pallas interpret mode; the port dispatches by tensor device"),
    (("kernels/*/kernel.py", "kernels/migrate/__init__.py:kernel"),
     ("csrc/secded.cu", "csrc/mixed.cu", "csrc/migrate.cu", "csrc/scrub.cu",
      "csrc/parity8.cu", "csrc/hash.cu", "csrc/daec.cu", "csrc/interwrap.cu",
      "csrc/flash_attention.cu", "csrc/ecc_matmul.cu"),
     "the Pallas kernels; the port's are the hand-written kernels in "
     "csrc/*.cu"),
    (("launch/mesh.py:ICI_BW_PER_LINK",),
     ("launch/mesh.py:NET_BW_PER_GPU",),
     "a TPU link's rate; the port's is the H100's, and no TPU number "
     "enters the port"),
    (("models/model.py:Model", "models/__init__.py:Model"),
     ("models/transformer.py:Transformer",),
     "the functional model record; build_model returns the Transformer "
     "module (the nn.Module idiom)"),
    (("models/*:init_attn", "models/*:init_rms", "models/*:init_mlp",
      "models/*:init_embed", "models/*:init_lm_head", "models/*:init_moe",
      "models/*:init_ssm", "models/*:init_mlstm", "models/*:init_slstm"),
     ("models/attention.py:Attention", "models/common.py:RMSNorm",
      "models/common.py:MLP", "models/common.py:Embedding",
      "models/transformer.py:Transformer", "models/moe.py:MoE",
      "models/ssm.py:SSM", "models/xlstm.py:MLSTM", "models/xlstm.py:SLSTM"),
     "the per-block parameter initialisers; the port's are the modules' "
     "constructors (the LM head is drawn inside Transformer)"),
    (("models/common.py:dense_init(key)",
      "models/transformer.py:init_params(key)"),
     ("models/common.py:dense_init(gen)",
      "models/transformer.py:init_params(seed=)"),
     "a JAX key; the port draws from an explicit torch.Generator "
     "(init_params: one seeded from its seed)"),
    (("launch/dryrun.py:run_cell(save_hlo=)",), None,
     "torch has no HLO; the dry-run's CostCounter records the counts"),
]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node) -> list[str]:
    """Names an assignment binds at module or class level."""
    out = []
    for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                out.append(e.id)
    return out


def _defaults(fn) -> dict[str, bool]:
    """Parameter name -> whether it has a default."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: False for p in pos}
    out.update({p.arg: True for p in pos[len(pos) - len(a.defaults):]})
    out.update({p.arg: d is not None
                for p, d in zip(a.kwonlyargs, a.kw_defaults)})
    return out


@cache
def surface(path: Path) -> dict:
    """A module's names, class members and function parameters."""
    tree = ast.parse(path.read_text())
    names, imported, members, params = set(), set(), {}, {}
    sources, aliases = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            params[node.name] = _defaults(node)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            own = members.setdefault(node.name, set())
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    own.add(b.name)
                    params[f"{node.name}.{b.name}"] = _defaults(b)
                elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                    own.update(_targets(b))
                    v = b.value
                    if isinstance(v, ast.Attribute) \
                            and isinstance(v.value, ast.Name):
                        # ``streams = PoolState.streams``: another's method
                        aliases.update({f"{node.name}.{t}": (v.value.id,
                                                             v.attr)
                                        for t in _targets(b)})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            bound = _targets(node)
            names.update(bound)
            if "__all__" in bound and isinstance(node.value,
                                                 (ast.List, ast.Tuple)):
                imported.update(e.value for e in node.value.elts)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0]
                            for a in node.names)
            if isinstance(node, ast.ImportFrom) and node.module:
                sources.update({a.asname or a.name: node.module
                                for a in node.names})
    return dict(names=names, imported=imported, members=members,
                params=params, sources=sources, aliases=aliases)


def _params(path: Path, fn: str) -> dict[str, bool]:
    """``fn``'s parameters in the module at ``path``, following a class
    attribute that names a method of a class imported from the port."""
    s = surface(path)
    if fn in s["params"] or fn not in s["aliases"]:
        return s["params"].get(fn, {})
    cls, attr = s["aliases"][fn]
    module = s["sources"].get(cls, "")
    if not module.startswith("repro_torch."):
        return {}
    target = PORT.joinpath(*module.split(".")[1:]).with_suffix(".py")
    return _params(target, f"{cls}.{attr}") if target.exists() else {}


def required(rel: Path) -> list[str]:
    """The items of reference module ``rel`` the port must hold."""
    s = surface(REF / rel)
    items = {n for n in s["names"] if _public(n)}
    if rel.name == "__init__.py":
        items |= {n for n in s["imported"] if _public(n)}
    items |= {f"{c}.{m}" for c, ms in s["members"].items() if _public(c)
              for m in ms if _public(m)}
    out = [f"{rel}:{i}" for i in sorted(items)]
    for fn, ps in sorted(s["params"].items()):
        if all(_public(p) or p == "__init__" for p in fn.split(".")):
            out += [f"{rel}:{fn}({p}{'=' if d else ''})"
                    for p, d in ps.items() if p not in ("self", "cls")]
    return out


def present(item: str) -> bool:
    """Whether the port holds ``item`` (see :func:`required`)."""
    rel, _, what = item.partition(":")
    path = PORT / rel
    if not path.exists():
        return False
    if not what:
        return True
    s = surface(path)
    if what.endswith(")"):
        fn, _, p = what[:-1].partition("(")
        ps = _params(path, fn)
        if p.endswith("="):
            return ps.get(p[:-1], False)
        return p in ps
    if "." in what:
        cls, _, member = what.partition(".")
        return member in s["members"].get(cls, ())
    return what in s["names"] or what in s["imported"]


def excepted(item: str) -> bool:
    """Whether ``item``, its module, or the name it belongs to (a class's
    member, a function's parameter) matches a row of :data:`EXCEPTIONS`."""
    rel, _, what = item.partition(":")
    owner = f"{rel}:{what.partition('(')[0].partition('.')[0]}"
    return any(fnmatch.fnmatch(x, pat) for pats, _, _ in EXCEPTIONS
               for pat in pats for x in (item, rel, owner))


REF_MODULES = sorted(p.relative_to(REF) for p in REF.rglob("*.py")
                     if p.name != "kernel.py")


@pytest.mark.parametrize("rel", REF_MODULES, ids=str)
def test_port_module_holds_the_reference_surface(rel):
    assert (PORT / rel).exists(), f"no port module at {rel}"
    missing = [i for i in required(rel) if not present(i) and not excepted(i)]
    assert not missing, f"the port lacks {missing}"


@pytest.mark.parametrize("row", EXCEPTIONS, ids=lambda r: r[0][0])
def test_each_exception_names_a_counterpart_that_exists(row):
    patterns, counterparts, reason = row
    assert reason
    for c in counterparts or ():
        assert present(c), c
    # every pattern names something the reference has
    items = [i for rel in REF_MODULES for i in required(rel)]
    for pat in patterns:
        hit = any(fnmatch.fnmatch(str(p.relative_to(REF)), pat)
                  for p in REF.rglob("kernel.py")) or any(
            fnmatch.fnmatch(i, pat) for i in items)
        assert hit, pat


def test_every_pallas_kernel_file_has_a_cuda_source():
    for path in sorted(REF.rglob("kernel.py")):
        name = path.parent.name
        assert (PORT / "csrc" / f"{name}.cu").exists(), name


def test_the_walk_sees_what_it_must():
    """The walk itself: names, members, ``__init__`` re-exports and
    defaulted parameters are all found, and a name taken out of a copy of
    a port module's source is reported missing."""
    pool = required(Path("core/pool.py"))
    for item in ("core/pool.py:PoolLike", "core/pool.py:make_pool",
                 "core/pool.py:PoolState.read",
                 "core/pool.py:make_pool(num_rows)",
                 "core/pool.py:make_pool(daec_rows=)"):
        assert item in pool and present(item), item
    shard = required(Path("shard/__init__.py"))
    assert "shard/__init__.py:read_any" in shard
    assert present("shard/__init__.py:read_any")
    assert present("shard/pool.py:make_sharded_pool(use_kernel=)")
    assert not present("shard/pool.py:make_sharded_pool(no_such_param)")
    # a parameter the reference defaults must be defaulted in the port
    assert present("kernels/mixed/ops.py:read_correct_routed(shard_id)")
    assert not present("kernels/mixed/ops.py:read_correct(pages=)")
    assert not present("core/pool.py:NoSuchName")
    assert not present("core/pool.py:PoolState.no_such_member")
    assert excepted("kernels/mixed/kernel.py")
    assert not excepted("kernels/mixed/ops.py:read_pool")
