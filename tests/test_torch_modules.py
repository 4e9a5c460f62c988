"""The PyTorch port's modules against their JAX counterparts, at f32 on
smoke-sized shapes: softmax, gating, layers, MLP, attention, int8 KV
quantization and the paged model pieces.

Inputs come from numpy seeds and reach both packages as the same
numbers; reference params are converted with
``repro_torch.convert.from_jax_params``. Tolerance is atol 2e-5, the
reference's own for its paged kernel, except where the function is
bitwise: masks, ``kv_quant`` codes and scales, and the pools after a
masked write."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_14b import smoke as jsmoke
from repro_torch.configs.qwen3_14b import smoke as tsmoke
from repro_torch.convert import from_jax_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

# by path: the packages' __init__ files export functions named like modules
jbase = importlib.import_module("repro.configs.base")
jatt = importlib.import_module("repro.core.attention")
jgate = importlib.import_module("repro.core.gating")
jsm = importlib.import_module("repro.core.softmax")
jtr = importlib.import_module("repro.models.transformer")
jlay = importlib.import_module("repro.nn.layers")
jmlp = importlib.import_module("repro.nn.mlp")
jkv = importlib.import_module("repro.quant.kv_cache")
jdec = importlib.import_module("repro.serving.decode")
jspec = importlib.import_module("repro.serving.speculate")
tbase = importlib.import_module("repro_torch.configs.base")
tatt = importlib.import_module("repro_torch.core.attention")
tgate = importlib.import_module("repro_torch.core.gating")
tsm = importlib.import_module("repro_torch.core.softmax")
ttr = importlib.import_module("repro_torch.models.transformer")
tlay = importlib.import_module("repro_torch.nn.layers")
tmlp = importlib.import_module("repro_torch.nn.mlp")
tmod = importlib.import_module("repro_torch.nn.module")
tkv = importlib.import_module("repro_torch.quant.kv_cache")
tdec = importlib.import_module("repro_torch.serving.decode")
tspec = importlib.import_module("repro_torch.serving.speculate")

ATOL = 2e-5

# one XLA compile per shape instead of one per primitive and shape
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,))
_jax_dense = jax.jit(jatt.dense_attention, static_argnums=(3,))


def _np(x):
    return np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f" \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_t(tree):
    return tmod.tree_map(_t, _tree_np(tree))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# config dataclasses: same field names and defaults
# ---------------------------------------------------------------------------
def _norm_default(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _norm_default(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if hasattr(v, "dtype") and not isinstance(v, (int, float, str)):
        return np.dtype(v).name
    try:
        return np.dtype(v).name if isinstance(v, type) and \
            issubclass(v, np.generic) else v
    except TypeError:
        return v


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            d = _norm_default(f.default)
        elif f.default_factory is not dataclasses.MISSING:
            d = _norm_default(f.default_factory())
        else:
            d = "<required>"
        out.append((f.name, d))
    return out


@pytest.mark.parametrize("jcls,tcls", [
    (jtr.ModelConfig, ttr.ModelConfig),
    (jatt.AttentionConfig, tatt.AttentionConfig),
    (jsm.ClippedSoftmaxConfig, tsm.ClippedSoftmaxConfig),
    (jgate.GateConfig, tgate.GateConfig),
    (jdec.GenerateConfig, tdec.GenerateConfig),
    (jspec.SpecConfig, tspec.SpecConfig),
], ids=lambda c: c.__name__)
def test_config_fields_and_defaults_match(jcls, tcls):
    assert _fields(jcls) == _fields(tcls)


def test_qwen3_configs_and_apply_method_match():
    from repro.configs.qwen3_14b import full as jfull
    from repro_torch.configs.qwen3_14b import full as tfull
    for jc, tc in ((jfull(), tfull()), (jsmoke(), tsmoke())):
        for method, kw in (("vanilla", {}), ("clipped_softmax", {"alpha": 4.0}),
                           ("gated_attention", {"pi_init": 0.25})):
            a = jbase.apply_method(jc, method, **kw)
            b = tbase.apply_method(tc, method, **kw)
            assert _norm_default(a) == _norm_default(b)


# ---------------------------------------------------------------------------
# module 1: tree helpers
# ---------------------------------------------------------------------------
def test_tree_stack_and_slice_match_reference():
    from repro.nn.module import tree_slice, tree_stack
    trees = [{"a": _rand((3, 2), i), "b": [_rand((4,), 10 + i)]} for i in range(3)]
    js = tree_stack([jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    ts = tmod.tree_stack([tmod.tree_map(_t, t) for t in trees])
    _close(ts["a"], js["a"], atol=0)
    _close(tmod.tree_slice(ts, 1)["b"][0], tree_slice(js, 1)["b"][0], atol=0)


def test_split_keys_is_deterministic():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = [tmod.normal_init(k, (4,), 1.0, torch.float32) for k in tmod.split_keys(g1, 3)]
    b = [tmod.normal_init(k, (4,), 1.0, torch.float32) for k in tmod.split_keys(g2, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# module 2: softmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gamma,zeta", [(0.0, 1.0), (-0.03, 1.0), (-0.01, 1.03)])
def test_softmax_and_clipped_softmax(gamma, zeta):
    x = _rand((3, 5, 17), 1, 3.0)
    mask = np.random.default_rng(2).random((3, 5, 17)) > 0.3
    mask[0, 0] = False                                   # fully masked row
    for where in (None, mask):
        jw = None if where is None else jnp.asarray(where)
        tw = None if where is None else _t(where)
        _close(tsm.softmax(_t(x), where=tw), jsm.softmax(jnp.asarray(x), where=jw))
        _close(tsm.clipped_softmax(_t(x), gamma, zeta, where=tw),
               jsm.clipped_softmax(jnp.asarray(x), gamma, zeta, where=jw))
    p = np.random.default_rng(4).random((7, 9)).astype(np.float32)
    _close(tsm.stretch_and_clip(_t(p), gamma, zeta),
           jsm.stretch_and_clip(jnp.asarray(p), gamma, zeta))


def test_softcap_and_resolve_gamma():
    x = _rand((4, 8), 3, 40.0)
    _close(tsm.softcap(_t(x), 30.0), jsm.softcap(jnp.asarray(x), 30.0))
    assert tsm.softcap(_t(x), None) is not None
    for cfg in (dict(), dict(gamma=-0.05), dict(alpha=4.0), dict(alpha=2.5, zeta=1.1)):
        j, t = jsm.ClippedSoftmaxConfig(**cfg), tsm.ClippedSoftmaxConfig(**cfg)
        for n in (7, 64, 1024):
            assert j.resolve_gamma(n) == t.resolve_gamma(n)
        assert j.is_vanilla == t.is_vanilla


# ---------------------------------------------------------------------------
# module 3: gating
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["linear", "mlp", "all_heads_linear", "none"])
def test_gate_probs_all_kinds(kind):
    hq, dh, d = 4, 8, 32
    for cfg_kw in (dict(kind=kind), dict(kind=kind, output_scale=2.0, b_init=0.3)):
        jc, tc = jgate.GateConfig(**cfg_kw), tgate.GateConfig(**cfg_kw)
        jp = jgate.init_gate(jax.random.PRNGKey(1), jc, hq, dh, d)
        if not jc.enabled:
            assert jp == {} and tgate.init_gate(torch.Generator(), tc, hq, dh, d) == {}
            return
        tp = _tree_t(jp)
        xh, xm = _rand((2, 5, hq, dh), 6), _rand((2, 5, d), 7)
        _close(tgate.gate_logits(tp, tc, _t(xh), _t(xm)),
               jgate.gate_logits(jp, jc, jnp.asarray(xh), jnp.asarray(xm)))
        _close(tgate.gate_probs(tp, tc, _t(xh), _t(xm)),
               jgate.gate_probs(jp, jc, jnp.asarray(xh), jnp.asarray(xm)))
        g = tgate.init_gate(torch.Generator().manual_seed(0), tc, hq, dh, d)
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}


def test_gate_from_pi_init():
    for pi in (0.1, 0.25, 0.5, 0.9, 0.0, 1.0):
        assert _norm_default(jgate.GateConfig.from_pi_init(pi, "mlp")) == \
            _norm_default(tgate.GateConfig.from_pi_init(pi, "mlp"))


# ---------------------------------------------------------------------------
# module 4: layers
# ---------------------------------------------------------------------------
def test_linear_norms_embeddings():
    x = _rand((2, 3, 16), 8)
    jp = jlay.linear_init(jax.random.PRNGKey(2), 16, 24)
    jp = {"w": jp["w"], "b": jnp.asarray(_rand((24,), 9))}
    _close(tlay.linear_apply(_tree_t(jp), _t(x)), jlay.linear_apply(jp, jnp.asarray(x)))
    ln = {"scale": jnp.asarray(_rand((16,), 10)), "bias": jnp.asarray(_rand((16,), 11))}
    _close(tlay.layernorm_apply(_tree_t(ln), _t(x)),
           jlay.layernorm_apply(ln, jnp.asarray(x)))
    rms = {"scale": jnp.asarray(_rand((16,), 12))}
    for zc in (False, True):
        _close(tlay.rmsnorm_apply(_tree_t(rms), _t(x), zero_centered=zc),
               jlay.rmsnorm_apply(rms, jnp.asarray(x), zero_centered=zc))
        _close(tlay.norm_apply("rmsnorm", _tree_t(rms), _t(x), zero_centered=zc),
               jlay.norm_apply("rmsnorm", rms, jnp.asarray(x), zero_centered=zc))
    _close(tlay.norm_apply("layernorm", _tree_t(ln), _t(x)),
           jlay.norm_apply("layernorm", ln, jnp.asarray(x)))
    emb = {"table": jnp.asarray(_rand((40, 16), 13))}
    ids = np.random.default_rng(14).integers(0, 40, (2, 5))
    for scale in (None, 4.0):
        _close(tlay.embedding_apply(_tree_t(emb), _t(ids), scale=scale),
               jlay.embedding_apply(emb, jnp.asarray(ids), scale=scale))
    _close(tlay.embedding_attend(_tree_t(emb), _t(x)),
           jlay.embedding_attend(emb, jnp.asarray(x)))


def test_bf16_norm_accumulates_in_f32():
    x = _rand((2, 64), 15, 3.0)
    rms = {"scale": jnp.asarray(_rand((64,), 16))}
    j = jlay.rmsnorm_apply(rms, jnp.asarray(x, jnp.bfloat16))
    t = tlay.rmsnorm_apply(_tree_t(rms), _t(x).bfloat16())
    assert t.dtype == torch.bfloat16
    _close(t.float(), np.asarray(j, np.float32), atol=0)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    pos = np.array([3, 17]) if per_row else 5
    t = 6
    jpos = jtr._positions(jnp.asarray(pos, jnp.int32), t)
    tpos = ttr._positions(torch.as_tensor(pos), t, "cpu")
    _close(tpos, jpos, atol=0)
    jc, js = jlay.rope_angles(jpos, 16, 1_000_000.0)
    tc, ts = tlay.rope_angles(tpos, 16, 1_000_000.0)
    _close(tc, jc)
    _close(ts, js)
    x = _rand((2, t, 3, 16), 17)
    _close(tlay.apply_rope(_t(x), tc, ts), jlay.apply_rope(jnp.asarray(x), jc, js))


# ---------------------------------------------------------------------------
# module 5: mlp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gelu", "gelu_tanh", "relu", "swiglu", "geglu"])
def test_mlp_all_kinds(kind):
    jp = jmlp.mlp_init(jax.random.PRNGKey(3), 16, 40, kind)
    x = _rand((2, 4, 16), 18)
    _close(tmlp.mlp_apply(_tree_t(jp), _t(x), kind),
           jmlp.mlp_apply(jp, jnp.asarray(x), kind))
    tp = tmlp.mlp_init(torch.Generator().manual_seed(0), 16, 40, kind)
    assert tmod.tree_map(lambda a: tuple(a.shape), tp) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)


# ---------------------------------------------------------------------------
# module 6: attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, 4)])
def test_attention_mask_scalar_and_per_row(causal, window):
    for off in (0, 7, np.array([0, 5, 12], np.int32)):
        j = jatt.make_attention_mask(4, 20, causal, window, jnp.asarray(off))
        t = tatt.make_attention_mask(4, 20, causal, window, torch.as_tensor(off))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


SOFTMAXES = [dict(), dict(gamma=-0.03), dict(gamma=-0.01, zeta=1.03), dict(alpha=4.0)]


@pytest.mark.parametrize("sm", SOFTMAXES, ids=str)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_dense_attention(sm, hq, hkv):
    b, tq, tk, dh = 2, 3, 9, 8
    kw = dict(n_heads=hq, n_kv_heads=hkv, d_head=dh)
    jc = jatt.AttentionConfig(**kw, softmax=jsm.ClippedSoftmaxConfig(**sm),
                              logit_softcap=20.0)
    tc = tatt.AttentionConfig(**kw, softmax=tsm.ClippedSoftmaxConfig(**sm),
                              logit_softcap=20.0)
    q, k, v = _rand((b, tq, hq, dh), 19), _rand((b, tk, hkv, dh), 20), \
        _rand((b, tk, hkv, dh), 21)
    gate = np.random.default_rng(22).random((b, tq, hq)).astype(np.float32)
    off = np.array([4, 6], np.int32)
    _close(tatt.attention_logits(_t(q), _t(k), tc),
           jatt.attention_logits(jnp.asarray(q), jnp.asarray(k), jc))
    for g in (None, gate):
        j = _jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                       q_offset=jnp.asarray(off),
                       gate_pi=None if g is None else jnp.asarray(g))
        t = tatt.dense_attention(_t(q), _t(k), _t(v), tc, q_offset=_t(off),
                                 gate_pi=None if g is None else _t(g))
        _close(t, j)


def test_paged_gather_and_dispatcher_smoke():
    """One small gather case here; tests/test_torch_paged_attention.py
    sweeps the paged read."""
    b, w, bs, hq, hkv, dh = 2, 3, 4, 4, 2, 8
    rng = np.random.default_rng(23)
    q = _rand((b, 1, hq, dh), 24)
    kp, vp = _rand((7, bs, hkv, dh), 25), _rand((7, bs, hkv, dh), 26)
    table = np.array([[3, 0, -1], [5, 1, 6]], np.int32)
    pos = np.array([6, 11], np.int32)
    cfgs = [tatt.AttentionConfig(hq, hkv, dh), jatt.AttentionConfig(hq, hkv, dh)]
    j = jatt.paged_attention_gather(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(table), cfgs[1], jnp.asarray(pos))
    t = tatt.paged_attention_gather(_t(q), _t(kp), _t(vp), _t(table), cfgs[0], _t(pos))
    _close(t, j)
    _close(tatt.paged_attention(_t(q), _t(kp), _t(vp), _t(table), cfgs[0], _t(pos)), j)
    assert rng is not None


# ---------------------------------------------------------------------------
# module 8: int8 KV quantization (bitwise)
# ---------------------------------------------------------------------------
def test_kv_quant_bitwise():
    x = _rand((3, 5, 2, 8), 27, 2.0)
    x[0, 0] = 0.0                                   # all-zero token: eps floor
    x[1, 2, 0, :4] = np.array([0.5, 1.5, 2.5, -2.5]) * (x[1, 2].max() / 127 * 0 + 1)
    jq, js = jkv.kv_quant(jnp.asarray(x))
    tq_, ts = tkv.kv_quant(_t(x))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tkv.kv_dequant(tq_, ts).numpy(),
                                  np.asarray(jkv.kv_dequant(jq, js)))
    xb = _rand((4, 2, 8), 28)
    np.testing.assert_array_equal(tkv.kv_quant(_t(xb).bfloat16())[0].numpy(),
                                  np.asarray(jkv.kv_quant(jnp.asarray(xb, jnp.bfloat16))[0]))


def test_kv_quant_rounds_half_to_even():
    x = np.zeros((1, 1, 8), np.float32)
    x[0, 0, :] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 126.5]   # scale = 1
    jq, _ = jkv.kv_quant(jnp.asarray(x))
    tq_, _ = tkv.kv_quant(_t(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    assert tq_.numpy()[0, 0].tolist() == [127, 0, 2, 2, 0, -2, 4, 126]


# ---------------------------------------------------------------------------
# module 9: the paged model pieces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_params():
    jc = jsmoke()
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    return jc, jp, from_jax_params(_tree_np(jp), tsmoke(), device="cpu")


@pytest.mark.parametrize("kv_int8", [False, True])
def test_init_paged_cache_and_block_bytes_match(kv_int8):
    for scan in (False, True):
        jc = dataclasses.replace(jsmoke(), scan_layers=scan)
        tc = dataclasses.replace(tsmoke(), scan_layers=scan)
        j = jtr.init_paged_cache(jc, 3, 32, 10, 8, kv_int8=kv_int8)
        t = ttr.init_paged_cache(tc, 3, 32, 10, 8, kv_int8=kv_int8, device="cpu")
        assert tmod.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), t) \
            == jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), j)
        assert all(torch.equal(x, _t(y)) for (_, x), (_, y) in
                   zip(tmod.flatten_params(t), tmod.flatten_params(_tree_np(j))))
    for bs in (8, 16):
        assert ttr.paged_kv_block_bytes(tsmoke(), bs, kv_int8) == \
            jtr.paged_kv_block_bytes(jsmoke(), bs, kv_int8)


def _fill_cache(jc, tc, kv_int8, seed):
    """A paged cache holding random pool contents, the same in both."""
    jcache = jtr.init_paged_cache(jc, 3, 32, 12, 8, kv_int8=kv_int8)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape).astype(np.int8))
        if a.dtype == np.int32:
            return leaf
        return jnp.asarray(rng.random(a.shape).astype(a.dtype))
    jcache = jax.tree_util.tree_map(fill, jcache)
    return jcache, tmod.tree_map(_t, _tree_np(jcache))


def _jax_paged_write(cache, k, v, pos, active):
    """The reference's masked scatter, as ``_attn_block_apply`` spells it
    (models/transformer.py:335-368), on given k/v values."""
    b, t = k.shape[:2]
    nb, bs = cache["k"].shape[0], cache["k"].shape[1]
    table = cache["block_table"]
    tpos = jnp.broadcast_to(jtr._positions(pos, t), (b, t))
    phys = jnp.take_along_axis(table, tpos // bs, axis=1, mode="fill", fill_value=-1)
    phys = jnp.where(active, phys, -1)
    phys = jnp.where(phys < 0, nb, phys)
    out = dict(cache)
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            q, s = jkv.kv_quant(x)
            out[name] = cache[name].at[phys, tpos % bs].set(q, mode="drop")
            out[name + "_scale"] = cache[name + "_scale"].at[phys, tpos % bs].set(
                s, mode="drop")
    else:
        for name, x in (("k", k), ("v", v)):
            out[name] = cache[name].at[phys, tpos % bs].set(
                x.astype(cache[name].dtype), mode="drop")
    return out


WRITE_TABLE = np.array([[4, 7, -1, -1], [0, 2, 9, -1], [1, 3, 5, 8]], np.int32)
WRITE_POS = np.array([5, 12, 28], np.int32)        # row 2 runs off its table
WRITE_ACTIVE = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1],
                         [1, 1, 1, 1, 1, 1]], bool)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_masked_paged_write_is_bitwise(smoke_params, kv_int8):
    """The same k/v values through the port's write and the reference's
    scatter give bit-identical pools: padding tokens, writes past the
    table and -1 entries are dropped."""
    jc = smoke_params[0]
    jcache, tcache = _fill_cache(jc, tsmoke(), kv_int8, 29)
    jentry, tentry = jcache["layers"][0]["b0"], tcache["layers"][0]["b0"]
    jentry["block_table"] = jnp.asarray(WRITE_TABLE)
    tentry["block_table"] = _t(WRITE_TABLE)
    k, v = _rand((3, 6, 2, 8), 35, 3.0), _rand((3, 6, 2, 8), 36, 3.0)
    j = _jax_paged_write(jentry, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(WRITE_POS), jnp.asarray(WRITE_ACTIVE))
    tpos = torch.broadcast_to(ttr._positions(_t(WRITE_POS), 6, "cpu"), (3, 6))
    targets = ttr._paged_targets(tentry["block_table"], tpos, _t(WRITE_ACTIVE),
                                 12, 8)
    ttr._paged_write(tentry, _t(k), _t(v), targets)
    for name in j:
        np.testing.assert_array_equal(tentry[name].numpy(), np.asarray(j[name]),
                                      err_msg=name)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_paged_step_matches_reference(smoke_params, kv_int8):
    """A whole forward over a paged cache with per-row positions and a
    per-token active mask: logits agree, the pools change at exactly the
    reference's entries, and the written values agree (to the f32
    round-off of the K/V projections; int8 codes to one step)."""
    jc, jp, tp = smoke_params
    tc = tsmoke()
    jcache, tcache = _fill_cache(jc, tc, kv_int8, 29)
    before = tmod.tree_map(lambda x: x.clone(), tcache)
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        jl["b0"]["block_table"] = jnp.asarray(WRITE_TABLE)
        tl["b0"]["block_table"] = _t(WRITE_TABLE)
    tokens = np.random.default_rng(30).integers(0, 128, (3, 6))
    jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(tokens)}, cache=jcache,
                          pos=jnp.asarray(WRITE_POS), active=jnp.asarray(WRITE_ACTIVE))
    tl, taux = ttr.model_apply(tp, tc, {"tokens": _t(tokens)}, cache=tcache,
                               pos=_t(WRITE_POS), active=_t(WRITE_ACTIVE))
    _close(tl, jl, atol=1e-4)
    flat_j = tmod.flatten_params(_tree_np(jaux["cache"]))
    flat_b = tmod.flatten_params(before)
    for (pj, lj), (pt, lt), (_, lb) in zip(flat_j, tmod.flatten_params(taux["cache"]),
                                           flat_b):
        assert pj == pt
        lt, lb = lt.numpy(), lb.numpy()
        np.testing.assert_array_equal(lt != lb, lj != lb, err_msg=pj)
        atol = 1 if lt.dtype == np.int8 else ATOL
        np.testing.assert_allclose(lt.astype(np.float64), lj.astype(np.float64),
                                   atol=atol, rtol=1e-5, err_msg=pj)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_dead_rows_padding_and_unallocated_leave_pool_unchanged(smoke_params, kv_int8):
    jc, jp, tp = smoke_params
    tc = tsmoke()
    _, tcache = _fill_cache(jc, tc, kv_int8, 31)
    table = np.array([[4, -1, -1, -1], [-1, -1, -1, -1], [1, 3, -1, -1]], np.int32)
    for tl in tcache["layers"]:
        tl["b0"]["block_table"] = _t(table)
    before = tmod.tree_map(lambda x: x.clone(), tcache)
    tokens = np.random.default_rng(32).integers(0, 128, (3, 4))
    pos = np.array([8, 3, 16], np.int32)       # row 0 -> entry 1 (-1)
    active = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
    ttr.model_apply(tp, tc, {"tokens": _t(tokens)}, cache=tcache, pos=_t(pos),
                    active=_t(active))
    for (p, a), (_, b) in zip(tmod.flatten_params(before), tmod.flatten_params(tcache)):
        assert torch.equal(a, b), p


def test_copy_pool_blocks_matches(smoke_params):
    jc, _, _ = smoke_params
    for kv_int8 in (False, True):
        jcache, tcache = _fill_cache(jc, tsmoke(), kv_int8, 33)
        src, dst = np.array([1, 4, 2]), np.array([4, 6, 1])   # chained pair
        j = jtr.copy_pool_blocks(jcache, jnp.asarray(src), jnp.asarray(dst))
        t = ttr.copy_pool_blocks(tcache, _t(src), _t(dst))
        for (_, a), (_, b) in zip(tmod.flatten_params(t), tmod.flatten_params(_tree_np(j))):
            np.testing.assert_array_equal(a.numpy(), b)


def test_scanned_layout_matches_unrolled(smoke_params):
    """A scanned (stacked ``groups``) config converts and runs to the same
    logits as its unrolled twin."""
    jc, jp, tp = smoke_params
    jcs = dataclasses.replace(jc, scan_layers=True)
    tcs = dataclasses.replace(tsmoke(), scan_layers=True)
    jps = dict(jp)
    jps["groups"] = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jp["layers"])
    del jps["layers"]
    tps = from_jax_params(_tree_np(jps), tcs, device="cpu")
    tokens = _t(np.random.default_rng(34).integers(0, 128, (2, 5)))
    a, _ = ttr.model_apply(tp, tsmoke(), {"tokens": tokens})
    b, _ = ttr.model_apply(tps, tcs, {"tokens": tokens})
    _close(a, b, atol=1e-6)
    cache = ttr.init_paged_cache(tcs, 2, 16, 6, 4, device="cpu")
    cache["groups"]["b0"]["block_table"] = _t(np.array([[[0, 1, -1, -1], [2, 3, 4, -1]]] * 2, np.int32))
    ttr.model_apply(tps, tcs, {"tokens": tokens}, cache=cache, pos=_t(np.array([0, 3])))
    assert cache["groups"]["b0"]["k"][1, 3].abs().sum() > 0       # layer 1, block 3


def test_model_init_layouts():
    cfg = dataclasses.replace(tsmoke(), scan_layers=True)
    p = ttr.model_init(0, cfg, device="cpu")
    q = ttr.model_init(0, dataclasses.replace(cfg, scan_layers=False), device="cpu")
    assert p["groups"]["b0"]["q"]["w"].shape == (2, 64, 64)
    assert torch.equal(p["groups"]["b0"]["q"]["w"][1], q["layers"][1]["b0"]["q"]["w"])
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     jtr.model_init(jax.random.PRNGKey(0), jsmoke()))
    assert tmod.tree_map(lambda a: tuple(a.shape),
                         ttr.model_init(1, tsmoke(), device="cpu")) == jshapes
