"""Rank programs of ``tests/test_torch_mesh.py``, and the harness that
starts them.

Each program runs in a process of its own, started by
``torch.multiprocessing`` (spawn), joins a gloo group of its ranks through
a ``FileStore`` and writes what it saw as ``.npy`` files. This module
imports no JAX and nothing of the reference package: the test that starts
the ranks holds their files against the reference in its own process.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.kernels import common

#: seconds a collective waits for a peer before its rank fails
RANK_TIMEOUT_S = 60.0


def run_ranks(fn, world: int, tmp_path: Path, *args,
              timeout: float = 90.0) -> None:
    """``fn(rank, world, store, *args)`` in ``world`` spawned processes.
    Raises when a rank fails (the others are ended) or when the group is
    not done within ``timeout`` seconds (a hung rank)."""
    store = str(tmp_path / f"store_{fn.__name__}_{world}")
    ctx = mp.start_processes(fn, args=(world, store, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks not done "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def join_group(rank: int, world: int, store: str) -> None:
    """Join the gloo group of ``world`` ranks over the file ``store``."""
    from repro_torch.launch.mesh import start_process_group
    torch.set_num_threads(1)
    start_process_group("cpu", rank=rank, world_size=world,
                        store=dist.FileStore(store, world),
                        timeout_s=RANK_TIMEOUT_S)


def leave_group(out: Path, rank: int) -> None:
    """Record which modules the rank loaded, then leave the group."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    (out / f"modules_r{rank}.json").write_text(json.dumps(bad))
    dist.destroy_process_group()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return common.to_u32(x) if x.dtype == torch.int32 \
            else x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# CREAM-Shard's verbs
# ---------------------------------------------------------------------------


def flip(pool, cells) -> None:
    """XOR ``(bank, row, lane, word, bit)`` cells into the banks this
    process holds (every bank on one card, its own on a mesh)."""
    banks = range(pool.num_shards) if pool.mesh is None else [pool.bank_id]
    for s in banks:
        sto = pool.bank(s).storage
        words = common.to_u32(sto)
        for b, r, ln, w, bit in cells:
            if b == s:
                words[r, ln, w] ^= np.uint32(1 << int(bit))
        sto.copy_(common.to_words(words))


def pool_sequence(pool, spec: dict, record) -> None:
    """The sequence every test pool runs: write (duplicates and a valid
    mask) -> read -> status read -> planted flips -> status read ->
    ``read_writeback`` -> migration across banks -> repartition down and
    up -> streams -> ``set_daec_rows`` -> scrub. ``record(name, value)``
    gets each read and, after each step, the pool."""
    S = pool.num_shards
    pool = pool.write(spec["ids"], common.to_words(spec["data"]),
                      valid=spec["valid"])
    record("write", pool)
    all_ids = spec["all_ids"]
    record("read", pool.read(all_ids))
    record("read_status", pool.read(all_ids, status=True))
    flip(pool, spec["flips"])
    record("flipped_status", pool.read(all_ids, status=True))
    data, status, pool = pool.read_writeback(all_ids)
    record("writeback", (data, status))
    record("after_writeback", pool)
    pool = pool.migrate(spec["src"], spec["dst"])
    record("migrate", pool)
    record("migrate_read", pool.read(all_ids, status=True))
    pool, info = pool.move_boundary(0)
    record("down_evicted", np.asarray(info["evicted_extra_pages"]))
    record("down", pool)
    pool, info = pool.move_boundary(int(spec["boundary"]))
    record("up", pool)
    record("up_read", pool.read(np.arange(pool.num_pages), status=True))
    streams = spec["streams"]
    pool = pool.streams(streams, common.to_words(spec["stream_data"]))
    record("streams", pool.streams(streams))
    pool = pool.set_daec_rows(int(spec["daec"]))
    record("daec", pool)
    record("daec_read", pool.read(np.arange(pool.num_pages), status=True))
    pool, stats = pool.scrub()
    record("scrub", pool)
    census = dict(vars(stats), corrupt_rows=list(stats.corrupt_rows))
    record("census", np.frombuffer(json.dumps(census).encode(), np.uint8))
    assert S == pool.num_shards


def mesh_pool_rank(rank: int, world: int, store: str, spec_path: str,
                   out: str) -> None:
    """One bank of a ``world``-bank mesh pool through
    :func:`pool_sequence`; every record to ``out/r<rank>_<name>.npy``."""
    from repro_torch.core.layouts import Layout
    from repro_torch.launch.mesh import make_banks_mesh
    from repro_torch.shard import ShardedPool, make_sharded_pool
    join_group(rank, world, store)
    out = Path(out)
    spec = dict(np.load(spec_path))
    mesh = make_banks_mesh(world)
    refused = []
    try:                                # S must be the mesh's size
        make_sharded_pool(int(spec["rows"]), num_shards=2 * world,
                          row_words=int(spec["W"]), mesh=mesh, device="cpu")
    except ValueError:
        refused.append("make_sharded_pool")
    try:                                # one bank a rank, every rank a bank
        make_banks_mesh(world + 1)
    except ValueError:
        refused.append("make_banks_mesh")
    (out / f"r{rank}_refused.json").write_text(json.dumps(refused))
    pool = make_sharded_pool(int(spec["rows"]), Layout(str(spec["layout"])),
                             int(spec["boundary"]), num_shards=world,
                             row_words=int(spec["W"]), mesh=mesh,
                             device="cpu")

    def record(name, value):
        if isinstance(value, ShardedPool):
            value = value.storage[0]
        vals = value if isinstance(value, tuple) else (value,)
        for i, v in enumerate(vals):
            np.save(out / f"r{rank}_{name}_{i}.npy", _np(v))

    with lens_on():
        pool_sequence(pool, spec, record)
        (out / f"r{rank}_memprof.json").write_text(json.dumps(lens_records()))
    leave_group(out, rank)


@contextlib.contextmanager
def lens_on():
    """CREAM-Lens on for the body, off and emptied after it."""
    from repro_torch.obs import memprof
    memprof.clear()
    memprof.enable()
    try:
        yield
    finally:
        memprof.disable()
        memprof.clear()


def lens_records() -> list:
    """CREAM-Lens's records, without their step and clock: ``[op, stream,
    pages, num_rows, boundary]`` each."""
    from repro_torch.obs import memprof
    return [[r.op, r.stream, r.pages.tolist(), r.num_rows, r.boundary]
            for r in memprof.records()]


# ---------------------------------------------------------------------------
# CREAM-Serve on a mesh pool
# ---------------------------------------------------------------------------

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")
SERVE_ROWS = 32
ROW_WORDS = 2 * 2 * 16          # one KV token per row: 8 tokens a page
MIG_FRAMES = 8


def nest(flat: dict) -> dict:
    """``{'a/b/c': leaf}`` -> the nested dicts of the reference's tree."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def serve_rank(rank: int, world: int, store: str, spec_path: str,
               out: str) -> None:
    """The serve-test engine on a ``world``-bank mesh pool of
    ``SERVE_ROWS`` global rows: the reference's weights and prompts, a
    payload migrated across banks beside step 3, read back after step 4.
    Writes the tokens, the read-back and the rank's bank."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.layouts import Layout
    from repro_torch.launch.mesh import make_banks_mesh
    from repro_torch.models import load_jax_params
    from repro_torch.serve import Engine, ServeRequest
    from repro_torch.vm import VirtualMemory
    join_group(rank, world, store)
    out = Path(out)
    spec = dict(np.load(spec_path))
    vm = VirtualMemory(row_words=ROW_WORDS, device="cpu")
    vm.add_pool("kv", SERVE_ROWS, Layout.INTERWRAP,
                boundary=SERVE_ROWS - int(spec["secded_rows"]), shards=world,
                mesh=make_banks_mesh(world))
    eng = Engine(ModelConfig(**SERVE_TEST), vm=vm, pool="kv", max_batch=4,
                 max_len=32, seed=0)
    load_jax_params(eng.model, nest({k[2:]: v for k, v in spec.items()
                                     if k.startswith("w:")}))
    vm.create_tenant("mig")
    vm.alloc("mig", MIG_FRAMES, allow_host=False)
    ents = vm.tenants["mig"].entries
    phys = np.asarray([ents[v].phys for v in sorted(ents)])
    src, dst = spec["src"], spec["dst"]
    np.testing.assert_array_equal(phys, spec["mig_phys"])
    vm.pools["kv"] = eng.pool.write(src, common.to_words(spec["payload"]))
    reqs = [ServeRequest(f"s{i}", p, 10) for i, p in enumerate(
        spec["prompts"])]
    for r in reqs:
        eng.submit(r)
    k = 0
    while eng.sched.has_work():
        eng.poll()
        k += 1
        if k == 3:
            eng.schedule_migration(src, dst)
        if k == 4:
            assert eng._pending_migration is None
            np.save(out / f"r{rank}_moved.npy", _np(eng.pool.read(dst)))
    np.save(out / f"r{rank}_tokens.npy",
            np.asarray([r.generated for r in reqs], np.int64))
    np.save(out / f"r{rank}_bank.npy", _np(eng.pool.storage[0]))
    np.save(out / f"r{rank}_steps.npy", np.asarray([eng.steps]))
    leave_group(out, rank)


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------


class GlobalBatches:
    """The reference's global batches, each rank taking its rows."""

    def __init__(self, batches: dict, replica: int, replicas: int):
        self.batches, self.replica, self.replicas = batches, replica, \
            replicas

    def batch(self, step: int) -> dict:
        from repro_torch.data.pipeline import replica_rows
        full = {k: torch.from_numpy(self.batches[f"{k}{step}"])
                for k in ("tokens", "labels")}
        return replica_rows(full, self.replica, self.replicas)


def train_rank(rank: int, world: int, store: str, spec_path: str,
               out: str, steps: int, micro) -> None:
    """The smoke qwen3 trained data-parallel over a ``(world, 1)`` host
    mesh from the reference's parameters on its global batches; writes
    the losses, gradient norms and final parameters."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import tree_paths, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import make_trainer
    join_group(rank, world, store)
    out = Path(out)
    spec = dict(np.load(spec_path))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=40,
                       scrub_every=0, checkpoint_every=0, remat="none",
                       microbatch=micro)
    with use_mesh(make_host_mesh()):
        tr = make_trainer(get_config("qwen3-0.6b").smoke(), tcfg,
                          seq_len=int(spec["seq"]),
                          global_batch=int(spec["batch"]), device="cpu")
        assert tr.replicas.size == world and tr.replicas.rank == rank
        tr.load_params(nest({k[2:]: v for k, v in spec.items()
                             if k.startswith("p:")}))
        tr.data = GlobalBatches(spec, rank, world)
        log = tr.run(steps)
    np.save(out / f"r{rank}_loss.npy", np.asarray([r["loss"] for r in log]))
    np.save(out / f"r{rank}_gnorm.npy",
            np.asarray([r["grad_norm"] for r in log]))
    np.savez(out / f"r{rank}_params.npz",
             **{p: v.detach().numpy() for p, v in
                tree_paths(tr.params).items()})
    leave_group(out, rank)
