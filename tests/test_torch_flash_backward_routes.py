"""The flash-attention backward's routes beyond f32 at Dh 32/64 without
window or softcap, on the CPU: the logit softcap, the local window, bf16
inputs and Dh 80, 96, 128 and 256.

  * ``attention_bwd_ref``, ``attention_stats_ref`` and
    ``attention_bwd_saved_ref`` (the backward kernel's formulas, its saved
    statistics and its algorithm, the plain versions ``chip_smoke.py``
    holds the kernel against) with a softcap, a window and both, in f32,
    against ``jax.vjp`` (and the log-sum-exp) of the reference oracle
    ``repro.kernels.ref.attention_ref``: causal and not, Hq = Hkv and GQA,
    vanilla, clipped and gated, at rtol 1e-4 as
    ``test_torch_flash_backward.py``;
  * the same plain versions on bf16 inputs against the f32 ones on the
    same (bf16-valued) numbers, at the bf16 tolerance 2e-2: they compute
    in f32 and round q Dh^-0.5 and the results to bf16;
  * ``FlashAttention.apply`` on CPU tensors (bf16 at Dh 80, 96, 128 and
    256, with softcap, window or both) against torch autograd through
    ``mha_flash_ref``;
  * every clipped case above keeps a share of its visible entries
    strictly inside the clip (asserted), where the clip passes a gradient.

The kernel itself runs only on the card; ``chip_smoke.py`` phase 6a holds
its bf16 and f32 routes against ``attention_bwd_ref`` there."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jref
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

tfa = importlib.import_module("repro_torch.kernels.flash_attention")

ALPHA = 4.0
# the f32 plain versions vs jax.vjp of the oracle: sums in other orders and
# q scaled before the product (the port) or the scores after it (the
# oracle), an ulp of each score; the gradients are O(1)
RTOL, ATOL = 1e-4, 2e-5
# bf16 against f32 on the same numbers: q Dh^-0.5 and each gradient rounded
# to bf16 (2^-9 relative), relative to the gradient's largest entry
BF16_TOL = 2e-2
SOFTCAP = 5.0                     # scores of RMS ~4 (spread 2): the cap bends them
WINDOW = 13                       # at T 48: masks, and is no divisor of it
MODES = {"softcap": dict(softcap=SOFTCAP), "window": dict(window=WINDOW),
         "softcap_window": dict(softcap=SOFTCAP, window=WINDOW)}
VARIANTS = ("vanilla", "clipped", "gated")
HEADS = ((4, 4), (4, 2))


def _inputs(variant, causal, hq, hkv, mode, b=2, t=48, dh=32, seed=0, spread=2.0):
    """q, k ~ N(0, spread^2), v, dout ~ N(0, 1), gate sigmoid(N(0, 1)),
    f32 numpy arrays; and the forward's settings."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    gate = None
    if variant == "gated":
        gate = (1 / (1 + np.exp(-f(b, t, hq)))).astype(np.float32)
    x = dict(q=f(b, t, hq, dh) * spread, k=f(b, t, hkv, dh) * spread, v=f(b, t, hkv, dh),
             gate=gate, dout=f(b, t, hq, dh))
    kw = dict(causal=causal, gamma=-ALPHA / t if variant == "clipped" else 0.0, zeta=1.0,
              **MODES.get(mode, {}))
    return x, kw


def _as_bf16(x):
    """The inputs rounded to bf16 values, still f32 numpy arrays."""
    return {n: None if a is None else
            torch.from_numpy(a).bfloat16().float().numpy() for n, a in x.items()}


def _t(x, dtype=torch.float32, grad=False):
    return None if x is None else torch.from_numpy(x).to(dtype).requires_grad_(grad)


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


def _mask(t, causal, window):
    q_pos, k_pos = np.arange(t)[:, None], np.arange(t)[None, :]
    mask = np.ones((t, t), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _unclipped_share(x, kw):
    """Share of the visible (query, key) pairs whose clipped probability
    lies strictly inside (0, 1), with the case's softcap and window."""
    b, t, hq, dh = x["q"].shape
    g = hq // x["k"].shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", x["q"].astype(np.float64) * dh ** -0.5,
                  np.repeat(x["k"], g, axis=2).astype(np.float64))
    if kw.get("softcap") is not None:
        s = kw["softcap"] * np.tanh(s / kw["softcap"])
    mask = _mask(t, kw["causal"], kw.get("window"))
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True)) * mask
    p /= p.sum(-1, keepdims=True)
    xx = (kw["zeta"] - kw["gamma"]) * p + kw["gamma"]
    return float(((xx > 0) & (xx < 1) & mask).sum() / (mask.sum() * b * hq))


def _check_share(variant, x, kw):
    if variant == "clipped":
        share = _unclipped_share(x, kw)
        assert 0.01 < share < 0.99, share        # non-vacuous: some entries pass a gradient


def _saved(x, kw, dtype=torch.float32):
    """What the forward keeps for the backward, plainly: the ungated
    output u in f32 and the row statistics."""
    q, k, v = (_t(x[n], dtype) for n in ("q", "k", "v"))
    fw = {n: kw[n] for n in ("causal", "window", "softcap", "gamma", "zeta") if n in kw}
    u = tfa.mha_flash_ref(q, k, v, None, out_dtype=torch.float32, **fw)
    st = tfa.attention_stats_ref(q, k, causal=kw["causal"], window=kw.get("window"),
                                 softcap=kw.get("softcap"))
    return u, st


def _close_to_jax(got, want):
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
@pytest.mark.parametrize("mode", tuple(MODES))
def test_bwd_ref_matches_jax_vjp(mode, variant, causal, heads):
    x, kw = _inputs(variant, causal, *heads, mode)
    _check_share(variant, x, kw)
    got = tfa.attention_bwd_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate", "dout")), **kw)
    _close_to_jax(got, _jax_vjp(x, kw))


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", tuple(MODES))
def test_bwd_saved_ref_matches_jax_vjp(mode, variant, causal, heads):
    x, kw = _inputs(variant, causal, *heads, mode, seed=2)
    _check_share(variant, x, kw)
    u, stats = _saved(x, kw)
    got = tfa.attention_bwd_saved_ref(*(_t(x[n]) for n in ("q", "k", "v", "gate")), u,
                                      _t(x["dout"]), stats, **kw)
    _close_to_jax(got, _jax_vjp(x, kw))


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "noncausal"))
@pytest.mark.parametrize("mode", tuple(MODES))
def test_stats_ref_matches_jax_logsumexp(mode, causal):
    """m + log Z of each row is the log-sum-exp of its visible softcapped
    scores; m the largest of them."""
    x, kw = _inputs("vanilla", causal, 4, 2, mode, seed=4)
    b, t, hq, dh = x["q"].shape
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(x["q"]) * dh ** -0.5,
                   jnp.repeat(jnp.asarray(x["k"]), 2, axis=2))
    if kw.get("softcap") is not None:
        s = kw["softcap"] * jnp.tanh(s / kw["softcap"])
    s = jnp.where(_mask(t, causal, kw.get("window")), s, -jnp.inf)
    stats = tfa.attention_stats_ref(_t(x["q"]), _t(x["k"]), causal=causal,
                                    window=kw.get("window"), softcap=kw.get("softcap"))
    assert stats.shape == (2, b, hq, t)
    m, z = stats[0].numpy(), stats[1].numpy()
    np.testing.assert_allclose(m, np.asarray(s.max(-1)), rtol=1e-6, atol=1e-6)
    assert (z >= 1.0).all()
    np.testing.assert_allclose(m + np.log(z), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-6, atol=2e-6)


def _close_bf16(got, want):
    """Each bf16 gradient against the f32 one, relative to its largest
    entry."""
    for name, a, b in zip(("dq", "dk", "dv", "dgate"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == (torch.float32 if name == "dgate" else torch.bfloat16), name
        scale = b.abs().max().item()
        assert scale > 0.1, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=BF16_TOL * scale,
                                   msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ("plain", "softcap_window"))
@pytest.mark.parametrize("dh", (32, 80, 128, 256))
def test_bf16_plain_versions_match_f32(dh, mode, variant):
    """The plain versions on bf16 inputs: the statistics, the formulas and
    the saved-statistics algorithm against the f32 ones on the same
    numbers."""
    x, kw = _inputs(variant, True, 4, 2, mode, dh=dh, seed=5, spread=1.5)
    x = _as_bf16(x)
    _check_share(variant, x, kw)
    names = ("q", "k", "v", "gate", "dout")
    bf = [_t(x[n], torch.float32 if n == "gate" else torch.bfloat16) for n in names]
    f32 = [_t(x[n]) for n in names]
    # the f32 q whose product with Dh^-0.5 is (to an f32 ulp) the bf16
    # version's q Dh^-0.5, rounded to bf16: the same numbers enter the
    # scores, so no clipped entry crosses the clip's edge between the two
    f32[0] = (bf[0] * dh ** -0.5).float() / dh ** -0.5
    sk = dict(causal=True, window=kw.get("window"), softcap=kw.get("softcap"))
    st_b = tfa.attention_stats_ref(bf[0], bf[1], **sk)
    st_f = tfa.attention_stats_ref(f32[0], f32[1], **sk)
    assert st_b.dtype == torch.float32
    torch.testing.assert_close(st_b, st_f, rtol=BF16_TOL, atol=BF16_TOL)
    want = tfa.attention_bwd_ref(*f32, **kw)
    _close_bf16(tfa.attention_bwd_ref(*bf, **kw), want)
    u, stats = _saved(x, kw, torch.bfloat16)
    assert u.dtype == torch.float32
    _close_bf16(tfa.attention_bwd_saved_ref(*bf[:4], u, bf[4], stats, **kw), want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", tuple(MODES))
@pytest.mark.parametrize("dh", (80, 96, 128, 256))
def test_function_bf16_matches_autograd_of_plain(dh, mode, variant):
    """FlashAttention.apply on bf16 CPU tensors (the bf16 route's Dh and
    the softcap and window): the forward is mha_flash_ref's, the gradients
    those of torch autograd through it, to bf16 rounding (autograd rounds
    dq, dk, dv to bf16 at each cast back, and sums the GQA heads in bf16)."""
    assert tfa.bwd_route(torch.bfloat16, dh) == "bf16"
    x, kw = _inputs(variant, True, 4, 2, mode, dh=dh, seed=6, spread=1.5)
    _check_share(variant, _as_bf16(x), kw)
    ins = [_t(x[n], torch.float32 if n == "gate" else torch.bfloat16, grad=True)
           for n in ("q", "k", "v", "gate")]
    dout = _t(x["dout"], torch.bfloat16)
    out = tfa.FlashAttention.apply(*ins, True, kw.get("window"), kw.get("softcap"),
                                   kw["gamma"], kw["zeta"], 0)
    live = [t for t in ins if t is not None]
    got = torch.autograd.grad(out, live, dout)
    ref_out = tfa.mha_flash_ref(*ins, **kw)
    want = torch.autograd.grad(ref_out, live, dout)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref_out)
    for name, a, b in zip(("dq", "dk", "dv", "dgate"), got, want):
        assert a.dtype == b.dtype, name
        scale = b.float().abs().max().item()
        assert scale > 0.05, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=BF16_TOL * scale,
                                   msg=name)


def test_routes():
    """bwd_route names one route per (dtype, Dh) the forward takes (Dh 8,
    16, 32, 64, 80, 96, 128, 256): bf16 for bf16, 3xTF32 for f32 up to Dh
    64, CUDA cores for f32 above; None for a head dim the forward refuses
    (48)."""
    dhs = (8, 16, 32, 64, 80, 96, 128, 256)
    assert [tfa.bwd_route(torch.bfloat16, d) for d in dhs] == ["bf16"] * 8
    assert [tfa.bwd_route(torch.float32, d) for d in dhs] == \
        ["3xtf32"] * 4 + ["cuda-core"] * 4
    assert tfa.bwd_route(torch.float32, 48) is None and tfa.bwd_route(torch.bfloat16, 48) is None


@pytest.mark.parametrize("dtype,dh,planes", [(torch.bfloat16, 128, 3), (torch.bfloat16, 32, 3),
                                             (torch.float32, 64, 1)])
def test_bwd_row_scratch(dtype, dh, planes, monkeypatch):
    """The backward's row scratch, with the library, the device guard and
    the stream stood in (this machine has no card): on the bf16 route three
    (B, Hq, Tq) f32 planes, D, each row's c2 = m log2(e) + log2(Z) and its
    gate (the dq launch writes c2 and the gate for the dk/dv launch's
    producer), on the 3xTF32 route one (D); the launch is handed that
    buffer."""
    calls, made = [], []

    class Lib:
        def flash_attention_bwd_launch(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    empty = torch.empty

    def recorded(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(tfa, "_bwd_kernel_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    monkeypatch.setattr(torch, "empty", recorded)
    b, t, hq, hkv = 1, 8, 4, 2
    q = torch.zeros(b, t, hq, dh, dtype=dtype)
    kv = torch.zeros(b, t, hkv, dh, dtype=dtype)
    u, stats = torch.zeros(b, t, hq, dh), torch.ones(2, b, hq, t)
    tfa._launch_bwd(q, kv, kv, None, u, q, stats, True, None, None, 0.0, 1.0)
    args = calls[-1]
    assert args[-2] == tfa._DTYPE_CODE[dtype]
    dsum = [x for x in made if x.data_ptr() == args[7]]
    assert len(dsum) == 1 and dsum[0].dtype == torch.float32
    assert dsum[0].shape == ((planes,) if planes > 1 else ()) + (b, hq, t)
    assert dsum[0].is_contiguous()
