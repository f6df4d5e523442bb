"""The paged decode attention (``kernels/paged_decode``) equals the reference.

  * The wrapper sends CPU tensors to the plain version (:mod:`.ref`), which
    is the einsum chain the reference's ``apply_attn_decode_paged`` runs
    after its projections: held against that function on the same numpy
    inputs (``wo`` the identity, so its output is the attention's), within
    1e-5 (float32, other reduction orders), at 1, 2, 9 and 48 query heads
    a KV head; the port's ``apply_attn_decode_paged`` is the plain version then
    ``@ wo``, bit for bit.
  * Edge cases through the wrapper: ``cache_len`` 0, S_pad - 1, S_pad and
    beyond; NaN and Inf past every slot's length; a strided (B, n_blk, bt,
    Hkv, D) view of engine-like pages (K, V and a tail a page), equal to its
    contiguous copy; each against a slot-by-slot float64 softmax.
  * The card path without a card: non-CPU operands never fall back; the
    dtypes, head dims and strides the kernel does not take raise; with the
    library stubbed the real ``common.launch`` passes the declared C
    arguments (the view's strides, the group, the split) and counts one
    ``paged_decode`` launch, at every group size up to 48 (multi-query).
  * The split of S_pad into chunks, and the engine's decode step calling
    the wrapper once per layer.

The CUDA kernel runs on the card (``chip_smoke.py``'s kernels phase,
``python3 chip_phases.py paged-decode``), held against the same plain
version.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as jattention
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.kernels import common
from repro_torch.kernels.paged_decode import ops, ref
from repro_torch.models import attention

HD = 16
#: (Hq, Hkv): 1, 2, 9 and 48 query heads a KV head
GROUPS = [(4, 4), (4, 2), (18, 2), (48, 1)]


def _cfg(cls, hq: int, hkv: int):
    return cls(name="paged-test", family="dense", num_layers=1,
               d_model=hq * HD, num_heads=hq, num_kv_heads=hkv, d_ff=32,
               vocab_size=64, head_dim=HD, dtype="float32")


def _garbage_kv(rng, b: int, s: int, hkv: int, lens) -> tuple:
    """(k, v) (B, S, Hkv, D) float32 with NaN / Inf / 3e38 past each
    slot's length, as pool bits may decode."""
    k = rng.standard_normal((b, s, hkv, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, HD)).astype(np.float32)
    for i, n in enumerate(lens):
        k[i, n + 1:] = np.nan
        v[i, n + 1:] = np.inf
        if n + 2 < s:
            v[i, n + 2] = np.float32(3e38)
    return k, v


def _lens(rng, b: int, s: int) -> np.ndarray:
    fixed = [0, s - 1, s, s + 3]
    return np.concatenate([fixed, rng.integers(0, s, b - len(fixed))]
                          ).astype(np.int32)


def _blocks(t: torch.Tensor) -> torch.Tensor:
    return t.unflatten(1, (1, t.shape[1]))


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_plain_version_equals_the_reference_paged_attention(hq, hkv):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 6, 24, hq * HD
    jcfg, tcfg = _cfg(JConfig, hq, hkv), _cfg(TConfig, hq, hkv)
    w = {n: (rng.standard_normal(shape) / np.sqrt(d)).astype(np.float32)
         for n, shape in (("wq", (d, hq * HD)), ("wk", (d, hkv * HD)),
                          ("wv", (d, hkv * HD)))}
    w["wo"] = np.eye(d, dtype=np.float32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    lens = _lens(rng, b, s)
    k, v = _garbage_kv(rng, b, s, hkv, lens)
    want, (wk, wv) = jattention.apply_attn_decode_paged(
        {n: jnp.asarray(a) for n, a in w.items()}, jcfg, jnp.asarray(x),
        (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(lens))

    p = SimpleNamespace(**{n: torch.as_tensor(a) for n, a in w.items()})
    tx, tl = torch.as_tensor(x), torch.as_tensor(lens)
    tk, tv = torch.as_tensor(k), torch.as_tensor(v)
    q, k_new, v_new = attention._project_one(p, tcfg, tx, tl)
    got = ref.attend(q.reshape(b, hq, HD), k_new.reshape(b, hkv, HD),
                     v_new.reshape(b, hkv, HD), tl, _blocks(tk), _blocks(tv))
    assert got.dtype == torch.float32 and got.shape == (b, hq, HD)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.reshape(b, 1, d).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)

    y, (kn, vn) = attention.apply_attn_decode_paged(p, tcfg, tx, (tk, tv),
                                                    tl)
    assert torch.equal(y, got.reshape(b, 1, d) @ p.wo)
    np.testing.assert_allclose(kn.numpy(), np.asarray(wk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(vn.numpy(), np.asarray(wv), atol=1e-5,
                               rtol=1e-5)


def _slot_softmax(q, k_new, v_new, lens, k, v) -> np.ndarray:
    """Slot by slot in float64: the keys [0, len) of the view with the new
    token at len, or all S_pad once len has reached it."""
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    k = k.reshape(b, -1, hkv, d).double()
    v = v.reshape(b, -1, hkv, d).double()
    s = k.shape[1]
    out = np.zeros((b, hq, d))
    for i in range(b):
        n = int(lens[i])
        ks, vs = k[i, :min(n, s)], v[i, :min(n, s)]
        if n < s:
            ks = torch.cat([ks, k_new[i, None].double()])
            vs = torch.cat([vs, v_new[i, None].double()])
        for h in range(hq):
            kv_head = h // (hq // hkv)
            logits = ks[:, kv_head] @ q[i, h].double() / d ** 0.5
            out[i, h] = (torch.softmax(logits, 0) @ vs[:, kv_head]).numpy()
    return out


def _pages(rng, b: int, n_blk: int, bt: int, hkv: int, tail: int = 8):
    """Engine-like pages (B, n_blk, K block | V block | tail) and their K, V
    (B, n_blk, bt, Hkv, D) strided views."""
    pages = torch.as_tensor(rng.standard_normal(
        (b, n_blk, 2 * bt * hkv * HD + tail)).astype(np.float32))
    kv = pages[..., :2 * bt * hkv * HD].view(b, n_blk, 2, bt, hkv, HD)
    return kv[:, :, 0], kv[:, :, 1]


@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("layout", ["contiguous", "strided_pages"])
def test_edge_cases_through_the_wrapper(hq, hkv, layout):
    rng = np.random.default_rng(7 * hq + hkv)
    b, n_blk, bt = 7, 6, 4
    s = n_blk * bt
    lens = _lens(rng, b, s)
    if layout == "contiguous":
        k, v = (_blocks(torch.as_tensor(t)) for t in
                _garbage_kv(rng, b, s, hkv, lens))
    else:
        k, v = _pages(rng, b, n_blk, bt, hkv)
        assert not k.is_contiguous()
        past = (torch.arange(s)[None] > torch.as_tensor(lens)[:, None].long()
                ).view(b, n_blk, bt)[..., None, None]
        k.masked_fill_(past, float("nan"))
        v.masked_fill_(past, float("inf"))
    q = torch.as_tensor(rng.standard_normal((b, hq, HD)).astype(np.float32))
    k_new, v_new = (torch.as_tensor(rng.standard_normal(
        (b, hkv, HD)).astype(np.float32)) for _ in range(2))
    tl = torch.as_tensor(lens)
    common.LAUNCHES.clear()
    got = ops.attend(q, k_new, v_new, tl, k, v)
    assert not common.LAUNCHES
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref.attend(q, k_new, v_new, tl, k, v))
    assert torch.equal(got, ops.attend(q, k_new, v_new, tl, k.contiguous(),
                                       v.contiguous()))
    np.testing.assert_allclose(got.numpy(),
                               _slot_softmax(q, k_new, v_new, lens, k, v),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(ref, "attend", lambda *a: seen.append(a) or "plain")
    t = torch.zeros
    args = (t(2, 4, HD), t(2, 2, HD), t(2, 2, HD),
            torch.zeros(2, dtype=torch.int64), t(2, 1, 8, 2, HD),
            t(2, 1, 8, 2, HD))
    assert ops.attend(*args) == "plain" and len(seen) == 1


def _meta(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _card_args(b=32, hq=16, hkv=16, d=128, n_blk=1, bt=768, dtype=None):
    dt = dtype or torch.float32
    return [_meta(b, hq, d, dtype=dt), _meta(b, hkv, d, dtype=dt),
            _meta(b, hkv, d, dtype=dt), _meta(b, dtype=torch.int32),
            _meta(b, n_blk, bt, hkv, d, dtype=dt),
            _meta(b, n_blk, bt, hkv, d, dtype=dt)]


def test_non_cpu_tensors_never_fall_back():
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attend(*_card_args())


def test_shapes_that_form_no_decode_step_raise_on_every_device():
    t = torch.zeros
    lens = torch.zeros(2, dtype=torch.int32)
    good = (t(2, 4, HD), t(2, 2, HD), t(2, 2, HD), lens, t(2, 1, 8, 2, HD),
            t(2, 1, 8, 2, HD))
    for i, bad in ((0, t(2, 3, HD)), (2, t(2, 1, HD)), (3, t(3)),
                   (4, t(2, 1, 8, 2, 8)), (5, t(2, 1, 9, 2, HD)),
                   (4, t(2, 8, 2, HD))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            ops.attend(*args)


@pytest.fixture
def card(monkeypatch):
    """The card path on meta tensors: no device check, 132 SMs, the real
    ``common.launch`` into a recording stand-in for the library."""
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(ops, "_on_one_card", lambda tensors: None)
    monkeypatch.setattr(ops, "_sms", lambda device: 132)
    monkeypatch.setattr(common, "library", lambda: Library())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(common, "LAUNCHES", common.collections.Counter())
    return calls


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.bfloat16), TypeError),
    (dict(d=112), ValueError),
    (dict(d=32), ValueError),
    (dict(d=256), ValueError),
    (dict(d=8), ValueError),
    (dict(bt=0), ValueError),
])
def test_card_path_refuses_what_the_kernel_does_not_take(card, change,
                                                        error):
    with pytest.raises(error):
        ops.attend(*_card_args(**change))
    assert not card


def test_card_path_refuses_dtypes_and_strides(card):
    args = _card_args()
    args[3] = _meta(32, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        ops.attend(*args)
    args = _card_args()
    args[0] = _meta(16, 32, 128).transpose(0, 1)         # q not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ops.attend(*args)
    args = _card_args()
    args[5] = _meta(32, 1, 768, 16, 132)[..., :128]       # V's own strides
    with pytest.raises(ValueError, match="strides"):
        ops.attend(*args)
    args = _card_args()
    odd = _meta(32, 1, 768 * 16 * 128 + 2)[..., :768 * 16 * 128]
    args[4] = args[5] = odd.view(32, 1, 768, 16, 128)     # batch stride % 4
    with pytest.raises(ValueError, match="multiples of 4"):
        ops.attend(*args)
    assert not card


def test_card_path_passes_the_view_and_counts_one_launch(card):
    b, n_blk, bt, hkv, tail = 32, 192, 4, 16, 8
    pw = 2 * bt * hkv * 128 + tail
    kv = _meta(b, 16, n_blk, pw)[:, 3, :, :pw - tail].view(
        b, n_blk, 2, bt, hkv, 128)                     # layer 3 of 16
    args = _card_args()
    args[4], args[5] = kv[:, :, 0], kv[:, :, 1]
    out = ops.attend(*args)
    assert out.shape == (32, 16, 128) and out.dtype == torch.float32
    [(name, c_args)] = card
    assert name == "paged_decode"
    assert len(c_args) == len(common.ENTRIES["paged_decode"])
    assert all(isinstance(p, int) for p in c_args[:9])      # pointers
    ints = c_args[9:20]
    assert ints == (b, hkv, 1, 128, n_blk * bt, bt, 16 * n_blk * pw, pw,
                    hkv * 128) + ops.split(b, hkv, n_blk * bt, 128, 132)
    assert c_args[20] == pytest.approx(np.log2(np.e) / np.sqrt(128))
    assert c_args[21] == 7
    assert common.LAUNCHES == {"paged_decode": 1}


@pytest.mark.parametrize("hq,hkv", [(16, 16), (36, 4), (32, 2), (34, 2),
                                     (48, 1)])
def test_card_path_takes_any_group(card, hq, hkv):
    """1, 9, 16, 17 and 48 (granite-34b's multi-query) query heads a KV
    head: one launch with g passed through; the kernel puts groups of more
    than 16 heads on more blocks."""
    out = ops.attend(*_card_args(hq=hq, hkv=hkv))
    assert out.shape == (32, hq, 128)
    [(name, c_args)] = card
    assert name == "paged_decode" and c_args[9:12] == (32, hkv, hq // hkv)
    assert common.LAUNCHES == {"paged_decode": 1}


def test_card_path_returns_no_query_head_without_a_launch(card):
    out = ops.attend(*_card_args(hq=0))
    assert out.shape == (32, 0, 128) and not card


def test_card_path_returns_an_empty_batch_without_a_launch(card):
    out = ops.attend(*_card_args(b=0))
    assert out.shape == (0, 16, 128) and not card


@pytest.mark.parametrize("b,hkv,s,d", [
    (32, 16, 768, 128),      # olmoe-1b-7b chat
    (16, 4, 3840, 128),      # starcoder2-7b code
    (4, 8, 128, 128),        # chip_smoke's qwen3-0.6b serve
    (4, 4, 64, 16),          # a smoke config
    (1, 1, 5, 64),
])
def test_split_covers_s_pad_in_whole_block_steps(b, hkv, s, d):
    chunk, n = ops.split(b, hkv, s, d, 132)
    assert chunk % (ops.TILE_KEYS // d) == 0
    assert (n - 1) * chunk < s <= n * chunk
    assert n == 1 or b * hkv * n <= 2 * ops.BLOCKS_PER_SM * 132
    if (b, hkv, s) == (32, 16, 768):
        assert (chunk, n) == (192, 4)
    if (b, hkv, s) == (16, 4, 3840):
        assert (chunk, n) == (128, 30)


def test_engine_decode_step_attends_once_per_layer(monkeypatch):
    from repro_torch.serve import Engine, ServeRequest
    cfg = TConfig(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")
    eng = Engine(cfg, max_batch=2, max_len=24, num_rows=64, row_words=64,
                 device="cpu")
    calls = []
    real = ops.attend
    monkeypatch.setattr(attention.paged_decode, "attend",
                        lambda *a: calls.append(a[4].shape) or real(*a))
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(f"r{i}", rng.integers(0, 256, 5).astype(np.int32),
                         4) for i in range(3)]
    eng.serve(reqs)
    assert eng.steps > 0 and len(calls) == eng.n_layers * eng.steps
    assert all(shape[1] == 1 for shape in calls)
