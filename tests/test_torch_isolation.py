"""The port stands alone: it loads no JAX, imports nothing of the reference
package or of ``benchmarks/``, and never runs on the CPU unless asked.
"""
import importlib
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.softecc import make_softecc
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.core.pool import make_pool
from repro_torch.core.regions import RegionManager
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.objcache.hash_index import make_index
from repro_torch.models import build_model
from repro_torch.serve import Engine, SequenceCache
from repro_torch.shard import make_sharded_pool
from repro_torch.tools.creamtop import main as creamtop_main
from repro_torch.train.trainer import make_trainer
from repro_torch.vm.address_space import VirtualMemory

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)\S*\s*import|import\s+benchmarks\b|"
    r"from\s+benchmarks\b)", re.M)
EXAMPLES = ("quickstart", "vm_multitenant", "adaptive_reliability",
            "objcache_memcached", "serve_kv_cream", "observe_serving",
            "train_lm")
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
            "repro_torch.launch.serve", "repro_torch.obs.metrics",
            "repro_torch.obs.tracing", "repro_torch.obs.dashboard",
            "repro_torch.obs.memprof", "repro_torch.obs.dram_sim",
            "repro_torch.tools.creamtop", "repro_torch.core.softecc",
            "repro_torch.core.poolstore", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.train.train_step", "repro_torch.train.trainer",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.distributed.elastic",
            "repro_torch.launch.train"} | {
                f"repro_torch.examples.{e}" for e in EXAMPLES + (
                    "cache_sim",)} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.')\n"
            "             or m.split('.')[0] == 'benchmarks')\n"
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
                 "from repro import serve", "  import repro",
                 "import benchmarks.dram_sim", "from benchmarks import x",
                 "from benchmarks.dram_sim import BankArray"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import pool",
                 "# a comment naming repro.core",
                 "from repro_torch.obs import dram_sim",
                 "# the reference is benchmarks/dram_sim.py"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_cli_imports_no_jax(name):
    """``python -m repro_torch.examples.<name> --help``: the example's
    import chain needs neither JAX, the reference package nor
    ``benchmarks``."""
    assert "--device" in _help_without_jax(f"repro_torch.examples.{name}")


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
    lambda: creamtop_main(["--demo"]),
    lambda: make_trainer(CFG, TrainConfig()),
    lambda: train_main(["--arch", "qwen3-0.6b", "--smoke"]),
    lambda: make_softecc(18, 64),
    lambda: SyntheticStream(DataConfig(256, 8, 2)),
    lambda: Checkpointer(str(ROOT / "build" / "no-ckpt")),
    *(lambda name=name: importlib.import_module(
        f"repro_torch.examples.{name}").main([]) for name in EXAMPLES),
], ids=["Engine", "VirtualMemory", "make_pool", "make_index", "build_model",
        "SequenceCache", "make_sharded_pool", "RegionManager",
        "launch.serve", "creamtop.demo", "make_trainer", "launch.train",
        "make_softecc", "SyntheticStream", "Checkpointer",
        *(f"examples.{name}" for name in EXAMPLES)])
def test_entry_points_without_cuda_raise(entry, monkeypatch):
    """No device and no CUDA: raise, never fall back to the CPU, and turn
    no telemetry plane on (a plane left on would change every later
    engine's step in the same process)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    assert not obs.metrics.enabled() and not obs.tracing.enabled()


def _help_without_jax(module: str) -> str:
    """``python -m <module> --help`` with ``jax``, the reference package
    and ``benchmarks`` made unimportable -> its standard output."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "    sys.modules[name] = None   # any import of it now raises\n"
            f"sys.argv = [{module!r}, '--help']\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_launcher_cli_imports_no_jax():
    """``python -m repro_torch.launch.serve --help``: the CLI's import
    chain needs neither JAX nor the reference package."""
    out = _help_without_jax("repro_torch.launch.serve")
    for flag in ("--arch", "--smoke", "--pool-mode", "--secded-rows",
                 "--device"):
        assert flag in out


def test_train_launcher_cli_imports_no_jax():
    """``python -m repro_torch.launch.train --help``: the training path's
    import chain (trainer, checkpointer, moment pool, optimizer, data)
    needs neither JAX nor the reference package."""
    out = _help_without_jax("repro_torch.launch.train")
    for flag in ("--arch", "--smoke", "--steps", "--ckpt-dir",
                 "--microbatch", "--grad-compression", "--device"):
        assert flag in out


def test_creamtop_cli_imports_no_jax():
    """``python -m repro_torch.tools.creamtop --help``: the dashboard's
    import chain needs neither JAX, the reference package nor
    ``benchmarks``."""
    out = _help_without_jax("repro_torch.tools.creamtop")
    for flag in ("--bench", "--snapshot", "--demo", "--device"):
        assert flag in out


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
