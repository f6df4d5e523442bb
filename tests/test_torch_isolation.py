"""The port stands alone: it loads no JAX, imports nothing of the reference
package, and never runs on the CPU unless asked.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import make_pool
from repro_torch.core.regions import RegionManager
from repro_torch.launch.serve import main as serve_main
from repro_torch.objcache.hash_index import make_index
from repro_torch.models import build_model
from repro_torch.serve import Engine, SequenceCache
from repro_torch.shard import make_sharded_pool
from repro_torch.vm.address_space import VirtualMemory

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)\S*\s*import)", re.M)
CFG = ModelConfig(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_every_port_module_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert {"repro_torch.serve.engine", "repro_torch.objcache.cache",
            "repro_torch.vm.policy", "repro_torch.core.daec",
            "repro_torch.core.injection", "repro_torch.obs.slo",
            "repro_torch.faults.shadow", "repro_torch.faults.campaign",
            "repro_torch.faults.fit",
            "repro_torch.kernels.daec.ops",
            "repro_torch.kernels.interwrap.ops",
            "repro_torch.kernels.interwrap.ref",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.serve.kv_cache", "repro_torch.shard.pool",
            "repro_torch.shard.router",
            "repro_torch.kernels.ecc_matmul.ops",
            "repro_torch.kernels.ecc_matmul.ref",
            "repro_torch.core.regions", "repro_torch.configs.registry",
            "repro_torch.configs.starcoder2_7b",
            "repro_torch.configs.musicgen_large",
            "repro_torch.launch.serve"} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   cwd=ROOT, timeout=120)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "import repro.core", "from repro.core import pool",
                 "from repro import serve", "  import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import pool",
                 "# a comment naming repro.core"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("entry", [
    lambda: Engine(CFG, max_batch=2, max_len=32),
    lambda: VirtualMemory(row_words=64),
    lambda: make_pool(16, row_words=64),
    lambda: make_index(64),
    lambda: build_model(CFG, attn_impl="flash"),
    lambda: SequenceCache(16, row_words=64),
    lambda: make_sharded_pool(32, num_shards=4),
    lambda: RegionManager(),
    lambda: serve_main(["--arch", "qwen3-0.6b", "--smoke"]),
], ids=["Engine", "VirtualMemory", "make_pool", "make_index", "build_model",
        "SequenceCache", "make_sharded_pool", "RegionManager",
        "launch.serve"])
def test_entry_points_without_cuda_raise(entry, monkeypatch):
    """No device and no CUDA: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_serve_launcher_cli_imports_no_jax():
    """``python -m repro_torch.launch.serve --help`` with ``jax`` and the
    reference package made unimportable: the CLI's import chain needs
    neither."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None   # any import of it now raises\n"
            "sys.argv = ['repro_torch.launch.serve', '--help']\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--arch", "--smoke", "--pool-mode", "--secded-rows",
                 "--device"):
        assert flag in proc.stdout


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
