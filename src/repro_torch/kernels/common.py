"""Shared kernel utilities: device resolution, int32-word helpers, the
kernel build and loader, and the launch counters.

uint32 bit patterns live in ``torch.int32`` tensors (the same bits; numpy
bridges with ``.view(np.uint32)``). On the CPU torch's ``uint32`` has no
shifts and ``int32 >>`` is arithmetic, so the plain versions use
:func:`lsr` (a masked logical shift) and :func:`popcount` (SWAR); left
shifts and multiplies wrap in two's complement, as uint32 arithmetic does.

The CUDA kernels are built at first use: :func:`library` runs ``nvcc`` on
every source in ``repro_torch/csrc/`` (one process per source, all started
together), links one shared library with a plain C interface into
``build/repro_torch/`` and loads it with ``ctypes``. It rebuilds when a
source is newer than the library. Nothing is built or loaded on the CPU
path.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Never falls back to the CPU on its own — without a GPU the caller must
    pass ``device="cpu"`` explicitly; asking for ``cuda`` without one
    raises the same way. A CUDA device comes back with its index (``cuda``
    becomes ``cuda:<current>``), so it compares equal to the ``.device``
    of the tensors made on it.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


# ---------------------------------------------------------------------------
# int32 words
# ---------------------------------------------------------------------------


def to_words(a) -> torch.Tensor:
    """numpy uint32 (or any integer array) -> int32 tensor of the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``. To the card the array is staged
    in pinned memory and copied without blocking the host: a copy from
    pageable memory would first wait for every launch queued on the
    stream, and so hold the host back from queuing anything else."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array of the same bits: a host copy,
    also of a CPU tensor (``.cpu()`` alone would share its memory)."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


def empty_words(like: torch.Tensor, *shape: int) -> torch.Tensor:
    """An uninitialised int32 tensor of ``shape`` on ``like``'s device:
    the wrappers' outputs, and their empty results at n = 0."""
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words by a static amount."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int32 words (as uint32 bit patterns)."""
    x = x - (lsr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (lsr(x, 2) & 0x33333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F
    x = x + lsr(x, 8)
    x = x + lsr(x, 16)
    return x & 0x3F


def s32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return u - (1 << 32) if u >= 1 << 31 else u


def pick_block(n: int, preferred: int) -> int:
    """Largest divisor of n that is <= preferred (keeps grids exact)."""
    b = min(preferred, n)
    while n % b:
        b -= 1
    return b


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

#: kernel name -> launches. Each wrapper adds one where it launches its
#: kernel and nowhere else; ``LAUNCHES.clear()`` resets them.
LAUNCHES: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("secded.cu", "mixed.cu", "migrate.cu", "parity8.cu", "hash.cu",
           "scrub.cu", "daec.cu", "interwrap.cu", "flash_attention.cu",
           "ecc_matmul.cu")
HEADERS = ("secded.cuh", "coords.cuh", "groups.cuh")
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry -> argument types; every entry returns cudaGetLastError().
ENTRIES = {
    # data, codes, n_code_words, stream
    "secded_encode": (_P, _P, _I, _P),
    # data, codes, out_data, out_codes, status, n_code_words, stream
    "secded_decode": (_P, _P, _P, _P, _P, _I, _P),
    # storage, pages, out, status (or NULL), n, W, interwrap, num_rows,
    # boundary, ebase, stream
    "mixed_read_correct": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # storage, pages, out, status (or NULL), n, W, interwrap, num_rows,
    # num_shards, boundary_local, ebase, stream
    "mixed_read_correct_routed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _P),
    # bank, pages, out, status (or NULL), n, W, interwrap, num_rows,
    # num_shards, boundary_local, ebase, shard_id, stream
    "mixed_read_correct_routed_local": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _P),
    # storage, pages, data, codes, n, W, num_rows, stream
    "migrate_gather_encode": (_P, _P, _P, _P, _I, _I, _I, _P),
    # data, parity, n_vectors, stream
    "parity8_encode": (_P, _P, _I, _P),
    # data, parity, status, n_vectors, stream
    "parity8_check": (_P, _P, _P, _I, _P),
    # storage, pages, data, n, W, num_rows, boundary, ebase, tables, stream
    "parity8_write": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # storage, keys, slot_pages, queries, out, n, W, capacity, probe,
    # interwrap, num_rows, boundary, ebase, stream
    "hash_lookup_read": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # storage, out, status, n_code_words, W, stream
    "scrub_rows": (_P, _P, _P, _I, _I, _P),
    # data, codes, n_code_words, stream
    "daec_encode": (_P, _P, _I, _P),
    # data, codes, out_data, out_codes, status, n_code_words, stream
    "daec_decode": (_P, _P, _P, _P, _P, _I, _P),
    # storage, pages, out, n, W, num_rows, stream
    "interwrap_gather": (_P, _P, _P, _I, _I, _I, _P),
    # storage, pages, data, n, W, num_rows, stream
    "interwrap_scatter": (_P, _P, _P, _I, _I, _I, _P),
    # q, k, v, out, B, Hq, Hkv, S, D, bf16, scale_log2, causal, stream
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # a_bits, a_codes, b, out, M, N, K, stream (both designs)
    "ecc_matmul_tiled": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ecc_matmul_decode": (_P, _P, _P, _P, _I, _I, _I, _P),
}
#: The pool kernels' word-granular entries, for row widths W % 8 != 0:
#: the same arguments as the vector entry of the same stem.
WORD_ENTRIES = ("mixed_read_correct", "mixed_read_correct_routed",
                "mixed_read_correct_routed_local", "migrate_gather_encode",
                "hash_lookup_read", "scrub_rows", "interwrap_gather",
                "interwrap_scatter")
ENTRIES.update({f"{name}_words": ENTRIES[name] for name in WORD_ENTRIES})


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _fresh(lib: Path) -> bool:
    deps = [CSRC / s for s in SOURCES + HEADERS]
    return lib.exists() and lib.stat().st_mtime >= max(
        d.stat().st_mtime for d in deps)


def build() -> Path:
    """Compile every source in ``csrc/`` and link the shared library.

    One ``nvcc -c`` per source, all running at once, then one link. A file
    lock makes concurrent callers (test workers) build once. The compiler's
    output (``-Xptxas -v``: registers, spills) goes to ``build.log``.
    """
    lib = BUILD_DIR / LIB_NAME
    if _fresh(lib):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(lib):
            return lib
        nvcc = _nvcc()
        objs = [BUILD_DIR / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        tmp = BUILD_DIR / (LIB_NAME + ".tmp")
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(
                [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        if link is None or link.returncode:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(logs))
        os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args, counts_as: str | None = None) -> None:
    """Call C entry ``name`` on torch's current stream; raise on a CUDA
    error. Tensors pass as device pointers (None as a null pointer),
    numbers as ``ENTRIES`` types them. The launch counts under ``counts_as`` (a kernel with several C
    entries), else under ``name``."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*conv, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")
    LAUNCHES[counts_as or name] += 1


def launch_for_width(name: str, W: int, *args) -> None:
    """Launch a pool kernel at row width ``W``: its vector entry ``name``
    (16-byte loads of whole 8-word groups of a slice) when ``W % 8 ==
    0``, else its word-granular entry ``name + "_words"``, counted under
    ``name`` either way. The two take the same arguments."""
    if W % 8:
        launch(name + "_words", *args, counts_as=name)
    else:
        launch(name, *args)


def check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Kernel operands must be contiguous on every device. The wrappers
    check before they dispatch, so a strided view that the kernel would
    refuse on the card fails the CPU tests too, instead of passing through
    the plain version."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_cuda_words(name: str, *tensors: torch.Tensor,
                     W: int | None = None) -> None:
    """Validate kernel operands: one CUDA device, then
    :func:`check_words`."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device")
    check_words(name, *tensors, W=W)


def check_words(name: str, *tensors: torch.Tensor,
                W: int | None = None) -> None:
    """Kernel operands must be int32, contiguous, indexable with int32 and,
    where the kernel moves them with 16-byte vectors, 16-byte aligned.
    Every operand of a vector entry is moved so. A pool kernel at row
    width ``W % 8 != 0`` runs its word entry, which reads its operands
    word by word and stores vectors only into the fresh outputs its
    wrapper allocates: there a view of a pool at any row offset (a bank,
    the rows a scrub sweeps) is a valid operand."""
    vectors = W is None or W % 8 == 0
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if vectors and t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: operand too large for int32 indexing")
