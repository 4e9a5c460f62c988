"""The gradient of the port's flash attention against the JAX package's,
on the CPU, in float32.

  * ``attention_bwd_ref`` (the formulas the backward kernel
    ``csrc/flash_attention_bwd.cu`` computes, and its plain version) against
    ``jax.vjp`` of the reference oracle ``repro.kernels.ref.attention_ref``
    (K/V repeated per query head for GQA, so the vjp sums dk and dv over a
    KV head's query heads): vanilla, clipped (alpha 4, gamma = -4/T, with
    scores wide enough that a share of the probabilities stays unclipped,
    asserted), gated, clipped + gated; causal and not; Hq = Hkv and GQA;
  * ``attention_stats_ref`` (the row statistics the forward kernel saves
    for the backward) against the log-sum-exp of the same scores through
    ``jax.numpy``;
  * ``attention_bwd_saved_ref`` (the backward kernel's algorithm: p from
    the saved (m, Z), D from the ungated output u, or clipped from S and
    dP~) against ``jax.vjp`` as above, also with gates that underflow, and
    against ``attention_bwd_ref``;
  * ``FlashAttention.apply`` on CPU tensors (plain forward with the saved
    statistics, then ``attention_bwd_saved_ref``) against torch autograd
    through ``mha_flash_ref``, with a non-contiguous dout;
  * what the backward once refused under a gradient (f32 at Dh 80, 128
    and 256, a query offset), each now a gradient: ``FlashAttention.apply``
    on CPU tensors against ``attention_bwd_ref`` and against ``jax.vjp`` of
    the reference's ``repro.core.attention.dense_attention``; and that an
    all-clipped case has exactly zero gradients (the vacuous case the
    clipped checks guard against). The routes the backward takes beyond f32
    Dh 32/64 (bf16, Dh 80/96/128/256, softcap, window) are tested in
    ``test_torch_flash_backward_routes.py``, Dh 8 and 16 and the query
    offset in ``test_torch_flash_offsets.py``.

The kernel itself runs only on the card; ``chip_smoke.py`` phase 6 holds it
against ``attention_bwd_ref`` there."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import AttentionConfig, dense_attention
from repro.core.softmax import ClippedSoftmaxConfig
from repro.kernels.ref import attention_ref as jref
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

tfa = importlib.import_module("repro_torch.kernels.flash_attention")

ALPHA = 4.0
# attention_bwd_ref vs jax.vjp of the reference: both f32, sums in other
# orders, and q scaled before the product (the port, as its forward) or
# the scores after it (the reference oracle), an ulp of each score; the
# gradients are O(1)
RTOL, ATOL = 1e-4, 2e-5
# FlashAttention.apply against torch autograd through mha_flash_ref: the
# same formulas in f32, other orders of the sums
FN_ATOL = 1e-5
VARIANTS = ("vanilla", "clipped", "gated", "clipped_gated")
HEADS = ((4, 4), (4, 2))


def _inputs(variant, causal, hq, hkv, b=2, t=48, dh=32, seed=0, spread=2.0):
    """q, k ~ N(0, spread^2) (scores of RMS ~spread^2, rows peaked enough
    that some clipped probabilities stay inside (0, 1)), v, dout ~ N(0,
    1), gate sigmoid(N(0, 1)) ("gated_small": half the rows' gates from
    pre-activations around -80, subnormal or exactly 0 in f32); and the
    forward's settings."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    gate = None
    if "gated" in variant:
        pre = f(b, t, hq)
        if variant == "gated_small":
            pre = np.where(rng.random((b, t, hq)) < 0.5, pre, pre * 20 - 80)
        with np.errstate(over="ignore"):
            gate = (1 / (1 + np.exp(-pre))).astype(np.float32)
    x = dict(q=f(b, t, hq, dh) * spread, k=f(b, t, hkv, dh) * spread, v=f(b, t, hkv, dh),
             gate=gate, dout=f(b, t, hq, dh))
    kw = dict(causal=causal, gamma=-ALPHA / t if "clipped" in variant else 0.0, zeta=1.0)
    return x, kw


def _t(x, grad=False):
    return None if x is None else torch.from_numpy(x).requires_grad_(grad)


def _jax_vjp(x, kw):
    """(dq, dk, dv, dgate) of the reference oracle in model layout."""
    b, t, hq, dh = x["q"].shape
    g = hq // x["k"].shape[2]

    def fwd(q, k, v, gate):
        k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        flat = lambda a: a.transpose(0, 2, 1, 3).reshape(b * hq, t, dh)  # noqa: E731
        gf = None if gate is None else gate.transpose(0, 2, 1).reshape(b * hq, t)
        out = jref(flat(q), flat(k), flat(v), gf, **kw)
        return out.reshape(b, hq, t, dh).transpose(0, 2, 1, 3)

    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    gate = None if x["gate"] is None else jnp.asarray(x["gate"])
    _, vjp = jax.vjp(fwd, *args, gate)
    return [None if r is None else np.asarray(r) for r in vjp(jnp.asarray(x["dout"]))]


def _unclipped_share(x, kw):
    b, t, hq, dh = x["q"].shape
    g = hq // x["k"].shape[2]
    q = torch.from_numpy(x["q"]) * dh ** -0.5
    k = torch.from_numpy(x["k"]).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = torch.ones(t, t, dtype=torch.bool)
    if kw["causal"]:
        mask = torch.tril(mask)
    p = torch.softmax(torch.where(mask, s, -1e30), -1)
    xx = (kw["zeta"] - kw["gamma"]) * p + kw["gamma"]
    return float(((xx > 0) & (xx < 1) & mask).float().sum() / (mask.sum() * b * hq))


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_bwd_ref_matches_jax_vjp(variant, causal, heads):
    x, kw = _inputs(variant, causal, *heads)
    if "clipped" in variant:
        share = _unclipped_share(x, kw)
        assert 0.01 < share < 0.99, share            # non-vacuous: some entries pass a gradient
    got = tfa.attention_bwd_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate", "dout")), **kw)
    want = _jax_vjp(x, kw)
    for name, a, b in zip(("dq", "dk", "dv", "dgate"), got, want):
        if b is None:
            assert a is None
            continue
        assert np.abs(b).max() > 0.1, name
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL, err_msg=name)


def _saved(x, kw):
    """What the forward keeps for the backward, plainly: the ungated output
    u and the row statistics."""
    q, k, v = (_t(x[n]) for n in ("q", "k", "v"))
    u = tfa.mha_flash_ref(q, k, v, None, **kw)
    return u, tfa.attention_stats_ref(q, k, causal=kw["causal"])


@pytest.mark.parametrize("spread", (0.05, 2.0))
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
def test_stats_ref_matches_jax_logsumexp(causal, heads, spread):
    """m + log Z of each row is the log-sum-exp of its visible scores; m is
    the largest of them (to an ulp of the scores: the two products sum in
    other orders)."""
    x, kw = _inputs("vanilla", causal, *heads, spread=spread)
    b, t, hq, dh = x["q"].shape
    g = hq // x["k"].shape[2]
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(x["q"]) * dh ** -0.5,
                   jnp.repeat(jnp.asarray(x["k"]), g, axis=2))
    mask = jnp.tril(jnp.ones((t, t), bool)) if causal else jnp.ones((t, t), bool)
    s = jnp.where(mask, s, -jnp.inf)
    want_lse = np.asarray(jax.nn.logsumexp(s, axis=-1))
    stats = tfa.attention_stats_ref(_t(x["q"]), _t(x["k"]), causal=causal)
    assert stats.shape == (2, b, hq, t)
    m, z = stats[0].numpy(), stats[1].numpy()
    np.testing.assert_allclose(m, np.asarray(s.max(-1)), rtol=1e-6, atol=1e-6)
    assert (z >= 1.0).all()                      # the largest entry adds exp(0)
    np.testing.assert_allclose(m + np.log(z), want_lse, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("variant", VARIANTS + ("gated_small",))
def test_bwd_saved_ref_matches_jax_vjp(variant, causal, heads):
    x, kw = _inputs(variant, causal, *heads, seed=2)
    if "clipped" in variant:
        share = _unclipped_share(x, kw)
        assert 0.01 < share < 0.99, share
    if variant == "gated_small":
        gate = x["gate"]
        assert (gate == 0).any() and ((gate > 0) & (gate < 1e-30)).any()
        # out / gate would not give u back there: 0 / 0 where the gate is 0
        out = tfa.mha_flash_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate")), **kw)
        assert torch.isnan(out / _t(gate)[..., None]).any()
    u, stats = _saved(x, kw)
    got = tfa.attention_bwd_saved_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate")), u,
                                      _t(x["dout"]), stats, **kw)
    want = _jax_vjp(x, kw)
    for name, a, b in zip(("dq", "dk", "dv", "dgate"), got, want):
        if b is None:
            assert a is None
            continue
        assert np.abs(b).max() > 0.1, name
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_bwd_saved_ref_matches_bwd_ref(variant, causal, heads):
    """The saved-statistics algorithm against the formulas from q, k, v
    alone, both in torch f32: they differ only where D and (m, Z) are
    taken from (u and the saved statistics, or the materialized p)."""
    x, kw = _inputs(variant, causal, *heads, seed=3)
    ins = [_t(x[n]) for n in ("q", "k", "v", "gate")]
    u, stats = _saved(x, kw)
    got = tfa.attention_bwd_saved_ref(*ins, u, _t(x["dout"]), stats, **kw)
    want = tfa.attention_bwd_ref(*ins, _t(x["dout"]), **kw)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=FN_ATOL)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_function_matches_autograd_of_plain(variant, causal, heads):
    x, kw = _inputs(variant, causal, *heads, seed=1)
    ins = [_t(x[n], grad=True) for n in ("q", "k", "v", "gate")]
    # dout as the transposed view of a (B, H, T, Dh) tensor: not contiguous
    dout = torch.from_numpy(np.ascontiguousarray(x["dout"].transpose(0, 2, 1, 3))
                            ).transpose(1, 2)
    assert not dout.is_contiguous()
    out = tfa.FlashAttention.apply(*ins, kw["causal"], None, None, kw["gamma"], kw["zeta"], 0)
    live = [t for t in ins if t is not None]
    got = torch.autograd.grad(out, live, dout)
    ref_out = tfa.mha_flash_ref(*ins, causal=causal, gamma=kw["gamma"], zeta=kw["zeta"])
    want = torch.autograd.grad(ref_out, live, dout)
    assert torch.equal(out, ref_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=FN_ATOL)


def dense_vjp(x, kw, q_offset=0):
    """(dq, dk, dv, dgate) of ``jax.vjp`` of the reference's
    ``dense_attention`` (the attention the reference trains through, which
    XLA differentiates) at the forward's settings ``kw`` and ``q_offset``
    (an int or a per-row (B,) array), f32 numpy arrays; dgate None without
    a gate."""
    hq, dh = x["q"].shape[2:]
    cfg = AttentionConfig(n_heads=hq, n_kv_heads=x["k"].shape[2], d_head=dh,
                          causal=kw["causal"], window=kw.get("window"),
                          logit_softcap=kw.get("softcap"),
                          softmax=ClippedSoftmaxConfig(gamma=kw["gamma"], zeta=kw["zeta"]))
    off = jnp.asarray(q_offset, jnp.int32)

    def fwd(q, k, v, gate):
        return dense_attention(q, k, v, cfg, q_offset=off, gate_pi=gate)

    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    gate = None if x["gate"] is None else jnp.asarray(x["gate"])
    _, vjp = jax.vjp(fwd, *args, gate)
    return [None if r is None else np.asarray(r) for r in vjp(jnp.asarray(x["dout"]))]


@pytest.mark.parametrize("bad", ("f32-dh80", "f32-dh128", "f32-dh256", "q_offset"))
def test_backward_refuses_what_the_kernel_lacks(bad):
    """What the backward kernel once refused under a gradient (f32 at Dh
    80, 128 and 256, where it had no route, and a query offset) now takes
    one: ``FlashAttention.apply`` on CPU tensors (the kernel's algorithm on
    the forward's saved statistics, plainly), clipped and gated, against
    ``attention_bwd_ref`` and against ``jax.vjp`` of the reference's
    ``dense_attention`` at rtol 1e-4. The offset case puts its 16 queries at
    positions 5..20 of 24 keys: the last three keys are seen by no query
    and their dk, dv are exactly zero."""
    dh = int(bad.split("dh")[1]) if "dh" in bad else 32
    off, tk = (5, 24) if bad == "q_offset" else (0, 16)
    x, kw = _inputs("clipped_gated", True, 4, 2, t=16, dh=dh, seed=dh)
    rng = np.random.default_rng(dh + 1)
    for n in ("k", "v"):
        x[n] = (rng.standard_normal((2, tk, 2, dh)) * (2.0 if n == "k" else 1.0)
                ).astype(np.float32)
    kw["gamma"] = -ALPHA / tk
    ins = [_t(x[n], grad=True) for n in ("q", "k", "v", "gate")]
    out = tfa.FlashAttention.apply(*ins, True, None, None, kw["gamma"], kw["zeta"], off)
    got = torch.autograd.grad(out, ins, _t(x["dout"]))
    plain = tfa.attention_bwd_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate", "dout")),
                                  **kw, q_offset=off)
    want = dense_vjp(x, kw, off)
    s, mask, _ = tfa._scores(_t(x["q"]), _t(x["k"]), True, q_offset=off)
    p = torch.softmax(s, dim=-1)
    xx = (kw["zeta"] - kw["gamma"]) * p + kw["gamma"]
    assert ((xx > 0) & (xx < 1) & mask).any()   # non-vacuous: some entries pass a gradient
    for name, a, b, c in zip(("dq", "dk", "dv", "dgate"), got, plain, want):
        assert np.abs(c).max() > 0.1, name
        torch.testing.assert_close(a, b, rtol=0, atol=FN_ATOL, msg=name)
        np.testing.assert_allclose(a.numpy(), c, rtol=RTOL, atol=ATOL, err_msg=name)
    if off:
        assert torch.count_nonzero(got[1][:, off + 16:]) == 0
        assert torch.count_nonzero(got[2][:, off + 16:]) == 0


def test_all_clipped_rows_give_zero_gradients():
    """Scores near zero at T 48, no causal mask, alpha 4: every
    probability (~1/48) lies below -gamma / (zeta - gamma), so every entry
    clips and the gradient is exactly zero. A clipped check on such inputs would pass
    for any kernel; the tests above assert a share of unclipped entries."""
    x, kw = _inputs("clipped", False, 4, 4, spread=0.05)
    assert _unclipped_share(x, kw) == 0.0
    dq, dk, dv, _ = tfa.attention_bwd_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate", "dout")),
                                          **kw)
    for g in (dq, dk, dv):
        assert torch.count_nonzero(g) == 0
