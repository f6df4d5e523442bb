"""SECDED-protected checkpointing with targeted restore.

Port of ``repro/checkpoint/checkpointer.py``, with its on-disk layout, so a
checkpoint written by either package restores in the other. Every leaf is
serialised with a SECDED(72,64) code plane — the checkpoint *itself* is an
ECC memory region at rest. On load, single-bit corruption
(disk/DRAM/transfer) is corrected transparently and double-bit corruption
is detected and reported per leaf, enabling the targeted-restore path
(re-fetch only the corrupt leaves from a replica) instead of failing the
whole restore.

Layout on disk:
  <dir>/step_<N>/manifest.json        paths, shapes, dtypes, pad bytes
  <dir>/step_<N>/<mangled-path>.npz   ``data`` uint32 words (each leaf's
                                      bytes padded to 32) + ``codes``

The codes are computed on the leaf's device with the SECDED wrapper
(:mod:`repro_torch.kernels.secded`: the encode kernel for a leaf on the
card) and decoded on the checkpointer's ``device`` at restore (the decode
kernel on the card). Restored leaves are tensors on that device. dtypes are
recorded by their numpy names; ``bfloat16`` maps to ``torch.bfloat16``
through its bytes, so no ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import secded
from repro_torch.core.poolstore import (DTYPE_NAMES, as_tensor, from_bytes,
                                        leaf_bytes)
from repro_torch.distributed.sharding import tree_paths
from repro_torch.kernels.common import resolve_device, to_u32
from repro_torch.kernels.secded import ops as secded_ops


def _mangle(path: str) -> str:
    return path.replace("/", "__")


def _to_words(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Any-dtype tensor -> (int32 words padded to an 8-word multiple, on
    the tensor's device; pad bytes)."""
    raw = leaf_bytes(t)
    pad = (-raw.numel()) % 32  # 8 words = 32 bytes
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32), pad


def _from_words(words: torch.Tensor, pad: int, shape, dtype: str
                ) -> torch.Tensor:
    raw = words.reshape(-1).view(torch.uint8)
    if pad:
        raw = raw[:-pad]
    return from_bytes(raw, shape, dtype)


@dataclass
class RestoreReport:
    corrected_leaves: list[str]
    corrupt_leaves: list[str]      # detected-uncorrectable -> caller re-fetches

    @property
    def clean(self) -> bool:
        return not self.corrected_leaves and not self.corrupt_leaves


class Checkpointer:
    """Checkpoints under ``directory``; restores onto ``device`` (``cuda``
    unless asked otherwise)."""

    def __init__(self, directory: str, protect: bool = True,
                 async_save: bool = False, device=None):
        self.dir = directory
        self.protect = protect
        self.async_save = async_save
        self.device = resolve_device(device)
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        flat = {p: as_tensor(l).detach() for p, l in tree_paths(tree).items()}
        if self._pending is not None:
            self._pending.join()  # one outstanding async save max
            self._pending = None
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._pending.start()
        else:
            self._write(step, flat)
        return self.step_dir(step)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, flat: dict[str, torch.Tensor]) -> None:
        d = self.step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for path, t in flat.items():
            words, pad = _to_words(t)
            entry = {"shape": list(t.shape), "dtype": DTYPE_NAMES[t.dtype],
                     "pad": pad}
            payload = {"data": to_u32(words)}
            if self.protect:
                payload["codes"] = to_u32(secded_ops.encode(words[None])[0])
            del words
            np.savez(os.path.join(tmp, _mangle(path) + ".npz"), **payload)
            manifest[path] = entry
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "protect": self.protect,
                       "leaves": manifest}, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)

    # -- load ---------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> int | None:
        steps = [int(n.split("_")[1]) for n in os.listdir(self.dir)
                 if n.startswith("step_") and not n.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: int, like=None) -> tuple[dict, RestoreReport]:
        """Returns (flat {path: tensor}, report). Use ``unflatten_like``
        to rebuild the tree structure (``like`` does it here)."""
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        corrected, corrupt = [], []
        out: dict[str, torch.Tensor] = {}
        for path, entry in manifest["leaves"].items():
            arr, status = self._load_leaf(d, path, entry, manifest["protect"])
            out[path] = arr
            if status == "corrected":
                corrected.append(path)
            elif status == "corrupt":
                corrupt.append(path)
        report = RestoreReport(corrected, corrupt)
        if like is not None:
            return unflatten_like(like, out), report
        return out, report

    def restore_leaves(self, step: int, paths: list[str]
                       ) -> dict[str, torch.Tensor]:
        """Targeted restore of only the named leaves (corrupt-page
        recovery)."""
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for path in paths:
            arr, _ = self._load_leaf(d, path, manifest["leaves"][path],
                                     manifest["protect"])
            out[path] = arr
        return out

    def _load_leaf(self, d: str, path: str, entry: dict, protected: bool
                   ) -> tuple[torch.Tensor, str]:
        z = np.load(os.path.join(d, _mangle(path) + ".npz"))
        words = as_tensor(z["data"].view(np.int32), self.device)
        status = "clean"
        if protected and "codes" in z.files:
            codes = as_tensor(z["codes"].view(np.int32), self.device)
            fixed, _, st = secded_ops.decode(words[None], codes[None])
            st = int(st.max()) if st.numel() else secded.CLEAN
            if st == secded.DETECTED_UNCORRECTABLE:
                status = "corrupt"
            elif st != secded.CLEAN:
                status = "corrected"
            words = fixed[0]
        arr = _from_words(words, entry["pad"], entry["shape"], entry["dtype"])
        return arr, status


def unflatten_like(like, flat: dict):
    """Rebuild a tree with ``like``'s structure from a flat path dict: each
    leaf takes the matching ``like`` leaf's dtype and device."""

    def rebuild(prefix, node):
        if isinstance(node, dict):
            return {k: rebuild(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rebuild(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(t)
        arr = as_tensor(flat[prefix])
        if isinstance(node, torch.Tensor):
            return arr.to(device=node.device, dtype=node.dtype)
        return arr

    return rebuild("", like)
