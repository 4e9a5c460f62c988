"""The flash-attention gradient at the registry's smoke head dims (Dh 8
and 16) and under a query offset, on the CPU, against the JAX package.

  * ``FlashAttention.apply`` on CPU tensors (the forward's saved
    statistics, then the backward kernel's algorithm, plainly) at Dh 8 and
    16, and under an int or a per-row (B,) query offset with more keys than
    queries (Tk > Tq), causal, windowed and softcapped, against ``jax.vjp``
    of the reference's ``repro.core.attention.dense_attention`` at rtol
    1e-4, and against ``attention_bwd_ref`` (the formulas from q, k, v
    alone); vanilla, clipped (a share of the entries strictly inside the
    clip asserted) and gated;
  * the row statistics under an offset against the log-sum-exp of the
    same scores through ``jax.numpy``;
  * the edges: keys no query sees get dk = dv = 0 exactly, queries that see
    no key dq = 0 and a finite dgate, as the reference's gradient;
  * bf16 inputs at Dh 8 and 16 against torch autograd through
    ``mha_flash_ref``;
  * the launch arguments: ``_launch_saved`` and ``_launch_bwd`` hand the
    offset (an int, or a pointer to the per-row int32 offsets), the head
    dim and the route to the libraries, stood in (this machine has no
    card).

The kernels themselves run only on the card; ``chip_smoke.py`` phase 6a
holds them against ``attention_bwd_ref`` there."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_flash_backward import dense_vjp

tfa = importlib.import_module("repro_torch.kernels.flash_attention")

ALPHA = 4.0
# FlashAttention vs jax.vjp of dense_attention: both f32, sums in other
# orders; q scaled in its dtype before the product on both sides
RTOL, ATOL = 1e-4, 2e-5
# FlashAttention vs attention_bwd_ref: the same formulas in f32, other
# orders of the sums (test_torch_flash_backward.py's FN_ATOL)
FN_ATOL = 1e-5
# bf16 against torch autograd through the plain forward, relative to each
# gradient's largest entry (test_torch_flash_backward_routes.py's BF16_TOL)
BF16_TOL = 2e-2
VARIANTS = ("vanilla", "clipped", "gated")
# (name, Dh, Tq, Tk, query offset, forward settings): the smoke configs'
# head dims; an int offset past the first keys (Tk = Tq + off: queries at
# the sequence's end, as a chunk of a longer prompt); per-row offsets of
# a slot pool (row 0 at the start, row 1 further on), with a window and a
# softcap; GQA throughout (Hq 4 over Hkv 2)
CASES = [
    ("dh8", 8, 24, 24, 0, dict(causal=True)),
    ("dh16", 16, 24, 24, 0, dict(causal=True)),
    ("dh16 noncausal", 16, 20, 20, 0, dict(causal=False)),
    ("int offset", 32, 16, 26, 10, dict(causal=True)),
    ("int offset window", 16, 16, 26, 10, dict(causal=True, window=7)),
    ("row offsets", 32, 16, 30, np.array([0, 9], np.int32), dict(causal=True)),
    ("row offsets window softcap", 8, 16, 30, np.array([3, 14], np.int32),
     dict(causal=True, window=6, softcap=5.0)),
]


def _inputs(variant, dh, tq, tk, settings, b=2, hq=4, hkv=2, seed=0, spread=2.0):
    """q, k ~ N(0, spread^2), v, dout ~ N(0, 1), gate sigmoid(N(0, 1)),
    f32 numpy arrays; and the forward's settings (clipped: gamma = -alpha
    / Tk, as the reference resolves it)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    gate = None
    if variant == "gated":
        gate = (1 / (1 + np.exp(-f(b, tq, hq)))).astype(np.float32)
    x = dict(q=f(b, tq, hq, dh) * spread, k=f(b, tk, hkv, dh) * spread, v=f(b, tk, hkv, dh),
             gate=gate, dout=f(b, tq, hq, dh))
    kw = dict(gamma=-ALPHA / tk if variant == "clipped" else 0.0, zeta=1.0, window=None,
              softcap=None)
    kw.update(settings)
    return x, kw


def _t(x, dtype=torch.float32, grad=False):
    return None if x is None else torch.from_numpy(x).to(dtype).requires_grad_(grad)


def _off(off):
    return torch.from_numpy(off) if isinstance(off, np.ndarray) else off


def _function_grads(x, kw, off, dtype=torch.float32):
    """FlashAttention.apply's output and (dq, dk, dv, dgate) on CPU tensors."""
    ins = [_t(x[n], torch.float32 if n == "gate" else dtype, grad=True)
           for n in ("q", "k", "v", "gate")]
    out = tfa.FlashAttention.apply(*ins, kw["causal"], kw["window"], kw["softcap"],
                                   kw["gamma"], kw["zeta"], _off(off))
    live = [t for t in ins if t is not None]
    got = list(torch.autograd.grad(out, live, _t(x["dout"], dtype)))
    return out, ins, got + [None] * (4 - len(got))


def _unclipped(x, kw, off):
    s, mask, _ = tfa._scores(_t(x["q"]), _t(x["k"]), kw["causal"], kw["window"],
                             kw["softcap"], _off(off))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    xx = (kw["zeta"] - kw["gamma"]) * p + kw["gamma"]
    return bool(((xx > 0) & (xx < 1) & mask).any())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_jax_dense_attention(case, variant):
    _, dh, tq, tk, off, settings = case
    x, kw = _inputs(variant, dh, tq, tk, settings, seed=dh + tk)
    if variant == "clipped":
        assert _unclipped(x, kw, off)            # non-vacuous: some entries pass a gradient
    out, ins, got = _function_grads(x, kw, off)
    assert torch.equal(out, tfa.mha_flash_ref(*(t.detach() if t is not None else None
                                                for t in ins), q_offset=_off(off), **kw))
    plain = tfa.attention_bwd_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate", "dout")),
                                  q_offset=_off(off), **kw)
    want = dense_vjp(x, kw, off)
    for name, a, b, c in zip(("dq", "dk", "dv", "dgate"), got, plain, want):
        if c is None:
            assert a is None and b is None
            continue
        assert np.abs(c).max() > 0.1, name
        torch.testing.assert_close(a, b, rtol=0, atol=FN_ATOL, msg=name)
        np.testing.assert_allclose(a.numpy(), c, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES[3:], ids=[c[0] for c in CASES[3:]])
def test_stats_with_offset_match_jax_logsumexp(case):
    """m + log Z of each row under the offset is the log-sum-exp of its
    visible scores, as the reference's mask places the queries."""
    _, dh, tq, tk, off, settings = case
    x, kw = _inputs("vanilla", dh, tq, tk, settings, seed=3)
    b, _, hq, _ = x["q"].shape
    g = hq // x["k"].shape[2]
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(x["q"]) * dh ** -0.5,
                   jnp.repeat(jnp.asarray(x["k"]), g, axis=2))
    if kw["softcap"] is not None:
        s = kw["softcap"] * jnp.tanh(s / kw["softcap"])
    o = jnp.asarray(off, jnp.int32)
    q_pos = (o[..., None] + jnp.arange(tq))[..., :, None]
    k_pos = jnp.arange(tk)
    mask = (k_pos <= q_pos) & ((k_pos > q_pos - kw["window"]) if kw["window"] else True)
    mask = mask[:, None] if mask.ndim == 3 else mask
    want_lse = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1))
    stats = tfa.attention_stats_ref(_t(x["q"]), _t(x["k"]), causal=True, window=kw["window"],
                                    softcap=kw["softcap"], q_offset=_off(off))
    m, z = stats[0].numpy(), stats[1].numpy()
    assert (z >= 1.0).all()                      # every row sees a key here
    np.testing.assert_allclose(m + np.log(z), want_lse, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_unseen_keys_and_blind_queries(variant):
    """Per-row offsets (-6, 30) over 8 queries and 16 keys, causal, window
    4: row 0's first six queries sit before every key and row 1's all past
    the window's reach, so they see no key; keys past a row's last query's
    reach are seen by none. Their gradients: dq = 0 and dgate = dO . u = 0
    (u = 0) for blind queries, dk = dv = 0 for unseen keys, exactly, all
    finite, as jax.vjp of the reference gives; the saved statistics of a
    blind row are (NEG_INF, 1e-30)."""
    off = np.array([-6, 30], np.int32)
    x, kw = _inputs(variant, 16, 8, 16, dict(causal=True, window=4), seed=11)
    _, _, got = _function_grads(x, kw, off)
    for g in got:
        assert g is None or torch.isfinite(g).all()
    dq, dk, dv, dgate = got
    assert torch.count_nonzero(dq[0, :6]) == 0 and torch.count_nonzero(dq[1]) == 0
    assert torch.count_nonzero(dq[0, 6:]) > 0
    # row 0's queries reach keys 0..1, row 1's none: keys 2.. unseen in
    # row 0, every key in row 1
    assert torch.count_nonzero(dk[0, 2:]) == 0 and torch.count_nonzero(dv[0, 2:]) == 0
    assert torch.count_nonzero(dk[1]) == 0 and torch.count_nonzero(dv[1]) == 0
    if dgate is not None:
        assert torch.count_nonzero(dgate[0, :6]) == 0 and torch.count_nonzero(dgate[1]) == 0
    stats = tfa.attention_stats_ref(_t(x["q"]), _t(x["k"]), causal=True, window=4,
                                    q_offset=_off(off))
    assert (stats[0, 1] == tfa.NEG_INF).all() and (stats[1, 1] == np.float32(1e-30)).all()
    want = dense_vjp(x, kw, off)
    for name, a, c in zip(("dq", "dk", "dv", "dgate"), got, want):
        if c is not None:
            np.testing.assert_allclose(a.numpy(), c, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dh", (8, 16))
def test_function_bf16_matches_autograd_of_plain(dh, variant):
    """FlashAttention.apply on bf16 CPU tensors at the smoke configs' head
    dims, with a per-row offset: the forward is mha_flash_ref's, the
    gradients those of torch autograd through it, to bf16 rounding."""
    assert tfa.bwd_route(torch.bfloat16, dh) == "bf16"
    off = np.array([2, 7], np.int32)
    x, kw = _inputs(variant, dh, 16, 24, dict(causal=True), seed=dh, spread=1.5)
    out, ins, got = _function_grads(x, kw, off, torch.bfloat16)
    ref_out = tfa.mha_flash_ref(*ins, q_offset=_off(off), **kw)
    live = [t for t in ins if t is not None]
    want = torch.autograd.grad(ref_out, live, _t(x["dout"], torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref_out)
    for name, a, b in zip(("dq", "dk", "dv", "dgate"), got, want):
        assert a.dtype == b.dtype, name
        scale = b.float().abs().max().item()
        assert scale > 0.05, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=BF16_TOL * scale,
                                   msg=name)


class _Lib:
    """A stood-in kernel library recording each launch's arguments."""

    def __init__(self):
        self.calls = []

    def flash_attention_launch(self, *args):
        self.calls.append(args)
        return 0

    flash_attention_bwd_launch = flash_attention_launch


@pytest.fixture
def stood_in(monkeypatch):
    """The libraries, the device guard and the stream stood in."""
    lib = _Lib()

    class Stream:
        cuda_stream = 0

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tfa, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(tfa, "_bwd_kernel_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    return lib


@pytest.mark.parametrize("per_row", (False, True), ids=("int", "per-row"))
@pytest.mark.parametrize("dtype,dh,route", [(torch.float32, 8, 0), (torch.float32, 16, 0),
                                            (torch.bfloat16, 8, 1), (torch.bfloat16, 16, 1),
                                            (torch.float32, 80, 2), (torch.float32, 128, 2),
                                            (torch.float32, 256, 2)])
def test_launch_arguments_carry_offset_head_dim_and_route(stood_in, dtype, dh, route, per_row):
    """The forward with statistics (``_launch_saved``) and the backward
    (``_launch_bwd``) hand the libraries the head dim, the query offset (an
    int, or the per-row int32 (B,) offsets' pointer with the int 0) and,
    to the backward, the route ``bwd_route`` names (0 3xTF32, 1 bf16, 2
    CUDA cores) before the dtype; the f32 CUDA-core route gets no gated-dO
    scratch and one plane of row scratch."""
    b, t, hq, hkv = 2, 8, 4, 2
    off = torch.tensor([3, 5], dtype=torch.int32) if per_row else 3
    q = torch.zeros(b, t, hq, dh, dtype=dtype)
    kv = torch.zeros(b, t + 4, hkv, dh, dtype=dtype)
    gate = torch.ones(b, t, hq)
    out, u, stats = tfa._launch_saved(q, kv, kv, gate, True, None, None, 0.0, 1.0, off)
    fwd = stood_in.calls[-1]
    assert fwd[11] == dh and fwd[27] == (0 if per_row else 3)
    assert fwd[4] == (off.data_ptr() if per_row else None)
    assert fwd[35] == stats.data_ptr() and fwd[36] == u.data_ptr()
    dq, dk, dv, dgate = tfa._launch_bwd(q, kv, kv, gate, u, q, stats, True, None, None, 0.0,
                                        1.0, q_offset=off)
    bwd = stood_in.calls[-1]
    assert tfa.bwd_route(dtype, dh) == ("3xtf32", "bf16", "cuda-core")[route]
    assert bwd[20] == dh and bwd[16:19] == (t, t + 4, hq)
    assert bwd[-5] == (0 if per_row else 3)
    assert bwd[-4] == (off.data_ptr() if per_row else None)
    assert bwd[-3] == route and bwd[-2] == tfa._DTYPE_CODE[dtype]
    assert (bwd[8] is None) == (route != 0)      # gate dO scratch: the 3xTF32 route only
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape and dgate.shape == gate.shape


def test_bwd_ref_flip_moves_only_its_row():
    """``attention_bwd_ref(flip=)`` takes one entry's clip indicator the
    other way (the reference ``chip_smoke.py`` decides entries within f32
    rounding of a clip edge with): only that query row's D moves, so dq
    changes in that row alone and dv (P~ is continuous at the edge) not at
    all; an all-False flip is no flip."""
    x, kw = _inputs("clipped", 16, 24, 24, dict(causal=True), seed=5)
    args = [_t(x[n]) for n in ("q", "k", "v", "gate", "dout")]
    base = tfa.attention_bwd_ref(*args, **kw)
    s, mask, _ = tfa._scores(args[0], args[1], True)
    flip = torch.zeros_like(mask.expand_as(s))
    assert torch.equal(tfa.attention_bwd_ref(*args, **kw, flip=flip)[0], base[0])
    flip[1, 0, 1, 20, 7] = True                  # batch 1, KV head 0, query head 1, query 20
    dq, dk, dv, _ = tfa.attention_bwd_ref(*args, **kw, flip=flip)
    moved = (dq != base[0]).any(-1)
    assert moved[1, 20, 1] and int(moved.sum()) == 1
    assert torch.equal(dv, base[2]) and not torch.equal(dk, base[1])
