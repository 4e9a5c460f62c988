"""The port's quantization stack against the JAX package's, on the CPU.

Inputs come from numpy seeds and reach both packages as the same
numbers. Bitwise (``np.testing.assert_array_equal``) wherever the
function is elementwise f32 arithmetic or exact integer work:
``scale_zero_point``, ``quantize``, ``dequantize``, ``fake_quant``, the
four range estimators, ``act_qparams``, ``quantize_weights_int8``, the
activation codes and the W8A8 product of ``int8_matmul`` (JAX's runs its
Pallas kernel in interpret mode, as the reference's own tests do). A
mean over a tensor is summed in another order by torch than by XLA, so
``quantization_error`` and the fp-oracle comparison state an f32
tolerance."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.qwen3_14b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.qwen3_14b import smoke as tsmoke
from repro_torch.convert import from_jax_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jq = importlib.import_module("repro.quant.quantizer")
jr = importlib.import_module("repro.quant.ranges")
jqc = importlib.import_module("repro.quant.qconfig")
jptq = importlib.import_module("repro.quant.ptq")
jw8 = importlib.import_module("repro.quant.int8_weights")
jim = importlib.import_module("repro.kernels.int8_matmul")
jref = importlib.import_module("repro.kernels.ref")
jtr = importlib.import_module("repro.models.transformer")
jmod = importlib.import_module("repro.nn.module")
tq = importlib.import_module("repro_torch.quant.quantizer")
tr = importlib.import_module("repro_torch.quant.ranges")
tqc = importlib.import_module("repro_torch.quant.qconfig")
tptq = importlib.import_module("repro_torch.quant.ptq")
tw8 = importlib.import_module("repro_torch.quant.int8_weights")
tim = importlib.import_module("repro_torch.kernels.int8_matmul")
tmod = importlib.import_module("repro_torch.nn.module")


def _rand(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift
            ).astype(np.float32)


def _eq(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def _bf16(x):
    """The same bf16 numbers for both packages."""
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


# ---------------------------------------------------------------------------
# quantizer (bitwise)
# ---------------------------------------------------------------------------
SPECS = [dict(bits=b, symmetric=s) for b in (4, 8) for s in (False, True)] + \
    [dict(bits=8, symmetric=True, per_channel_axis=1)]


@pytest.mark.parametrize("kw", SPECS, ids=str)
def test_quantizer_matches_reference_bitwise(kw):
    x = _rand((6, 20), 1, scale=2.0, shift=0.3)
    jspec, tspec = jq.QuantSpec(**kw), tq.QuantSpec(**kw)
    if kw.get("per_channel_axis") is not None:
        lo, hi = x.min(0), x.max(0)
    else:
        lo, hi = np.float32(-1.7), np.float32(2.9)
    js, jz = jq.scale_zero_point(lo, hi, jspec)
    ts, tz = tq.scale_zero_point(torch.from_numpy(np.asarray(lo)),
                                 torch.from_numpy(np.asarray(hi)), tspec)
    _eq(ts, js)
    _eq(tz, jz)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q = tq.quantize(xt, ts, tz, tspec)
    assert q.dtype == torch.int32
    _eq(q, jq.quantize(xj, js, jz, jspec))
    _eq(tq.dequantize(q, ts, tz, tspec), jq.dequantize(jnp.asarray(q.numpy()), js, jz, jspec))
    _eq(tq.fake_quant(xt, ts, tz, tspec), jq.fake_quant(xj, js, jz, jspec))
    xb, xbj = _bf16(x)
    fb = tq.fake_quant(xb, ts, tz, tspec)
    assert fb.dtype == torch.bfloat16
    _eq(fb.float(), np.asarray(jq.fake_quant(xbj, js, jz, jspec), np.float32))
    # a mean over the tensor: summation order differs, f32 rounding only
    np.testing.assert_allclose(float(tq.quantization_error(xt, ts, tz, tspec)),
                               float(jq.quantization_error(xj, js, jz, jspec)),
                               rtol=1e-5)


def test_fake_quant_straight_through_gradient():
    """Identity gradient inside the range, zero where the value clipped."""
    spec = tq.QuantSpec(bits=8)
    s, z = tq.scale_zero_point(torch.tensor(-1.0), torch.tensor(1.0), spec)
    x = torch.tensor([-3.0, -0.5, 0.2, 0.7, 3.0], requires_grad=True)
    tq.fake_quant(x, s, z, spec).sum().backward()
    _eq(x.grad, np.array([0, 1, 1, 1, 0], np.float32))


# ---------------------------------------------------------------------------
# range estimators (equal (lo, hi) on the same batches)
# ---------------------------------------------------------------------------
ESTIMATORS = {
    "minmax": {},
    "running_minmax": dict(momentum=0.9),
    # a reservoir smaller than a batch exercises the seeded subsample
    "percentile": dict(percentile=99.0, reservoir=500),
    "mse": dict(n_candidates=40),
}


@pytest.mark.parametrize("kind", list(ESTIMATORS))
def test_estimators_match_reference(kind):
    spec_kw = dict(bits=8, symmetric=False)
    n = (1 << 18) + 100 if kind == "mse" else 2000    # mse subsamples past 2^18
    batches = [_rand((n,), 20 + i, scale=1.0 + i, shift=0.2 * i) for i in range(3)]
    je = jr.make_estimator(kind, jq.QuantSpec(**spec_kw), **ESTIMATORS[kind])
    te = tr.make_estimator(kind, tq.QuantSpec(**spec_kw), **ESTIMATORS[kind])
    for b in batches:
        je.update(jnp.asarray(b))
        te.update(torch.from_numpy(b))
    (jlo, jhi), (tlo, thi) = je.finalize(), te.finalize()
    _eq(tlo, jlo)
    _eq(thi, jhi)
    assert tlo.dtype == torch.float32


def test_make_estimator_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown range estimator"):
        tr.make_estimator("bogus", tq.QuantSpec())


# ---------------------------------------------------------------------------
# QConfig / QuantContext / PTQ calibration
# ---------------------------------------------------------------------------
def test_qconfig_fields_and_defaults_equal_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jqc.QConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tqc.QConfig)}
    assert jf == tf
    c = tqc.QConfig()
    assert c.name == "W8A8" and c.skipped("lm_head") and not c.skipped("layer_attn0/q")
    assert c.weight_spec(2) == tq.QuantSpec(bits=8, symmetric=True)
    assert c.act_spec() == tq.QuantSpec(bits=8, symmetric=False)


def _toy_apply(params, x, ctx):
    """Two sites per linear and a skipped head, for either package: enough
    to exercise every QuantContext path."""
    h = ctx.act("in.out", x)
    h = ctx.act("hid.in", h) @ ctx.weight("hid", params["w1"])
    h = ctx.act("hid.out", h)
    return ctx.act("lm_head.in", h) @ ctx.weight("lm_head", params["w2"])


@pytest.mark.parametrize("qkw", [{}, dict(act_estimator="percentile",
                                          act_estimator_kwargs=(("percentile", 99.0),))],
                         ids=["running_minmax", "percentile"])
def test_quant_context_collect_finalize_apply_int8(qkw):
    w = {"w1": _rand((8, 12), 30, 0.3), "w2": _rand((12, 5), 31, 0.3)}
    xs = [_rand((4, 8), 40 + i, 1.0 + 0.5 * i) for i in range(3)]
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jctx = jptq.calibrate(_toy_apply, jw, [jnp.asarray(x) for x in xs],
                          jqc.QConfig(**qkw), num_batches=2)
    tctx = tptq.calibrate(_toy_apply, tw, [torch.from_numpy(x) for x in xs],
                          tqc.QConfig(**qkw), num_batches=2)
    assert tctx.mode == "apply" == jctx.mode
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    assert not any(k.startswith("lm_head") for k in tctx.ranges)   # skipped
    for k, (lo, hi) in jctx.ranges.items():
        if k == "hid.out":      # after a matmul: torch and XLA sum in another order
            np.testing.assert_allclose(tctx.ranges[k], (lo, hi), rtol=1e-6)
        else:
            _eq(tctx.ranges[k][0], lo)
            _eq(tctx.ranges[k][1], hi)
    x = xs[2] * 3.0                                   # outside the ranges
    japp = jptq.make_quantized_apply(_toy_apply, jctx, jit=False)
    tapp = tptq.make_quantized_apply(_toy_apply, tctx)
    np.testing.assert_allclose(tapp(tw, torch.from_numpy(x)).numpy(),
                               np.asarray(japp(jw, jnp.asarray(x))), atol=1e-5, rtol=0)
    # a context loaded with the reference's ranges: the same fake-quant sites
    lctx = tqc.QuantContext(tqc.QConfig(**qkw))
    lctx.load_ranges({k: (torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)))
                      for k, (lo, hi) in jctx.ranges.items()})
    _eq(lctx.act("hid.out", torch.from_numpy(x)), jctx.act("hid.out", jnp.asarray(x)))
    _eq(lctx.act("unseen.out", torch.from_numpy(x)), x)
    jctx.use_int8_runtime()
    lctx.use_int8_runtime()
    assert lctx.mode == "int8"
    for name in ("in.out", "hid.in", "hid.out", "lm_head.in", "hid#w", "nope"):
        assert lctx.act_qparams(name) == jctx.act_qparams(name)
    s, z = lctx.act_qparams("hid.in")
    assert isinstance(s, float) and isinstance(z, float)
    _eq(lctx.act("hid.in", torch.from_numpy(x)), x)                 # identity
    tctx.use_int8_runtime()
    assert tctx.act_qparams("hid.in") == jctx.act_qparams("hid.in")
    assert tqc.NO_QUANT.mode == "off" and tqc.NO_QUANT.act_qparams("x") is None


def test_quant_context_rejects_bad_mode_and_early_int8():
    with pytest.raises(ValueError, match="mode"):
        tqc.QuantContext(tqc.QConfig(), "bogus")
    with pytest.raises(RuntimeError, match="calibration"):
        tqc.QuantContext(tqc.QConfig(), "collect").use_int8_runtime()


# ---------------------------------------------------------------------------
# int8 weights and the W8A8 product (bitwise)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_int8_bitwise(dtype):
    w = _rand((40, 24), 50, 0.05)
    if dtype == "bfloat16":
        tw, jw = _bf16(w)
    else:
        tw, jw = torch.from_numpy(w), jnp.asarray(w)
    tqw, ts = tim.quantize_weights_int8(tw)
    jqw, js = jim.quantize_weights_int8(jw)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32 and ts.ndim == 0
    _eq(tqw, jqw)
    _eq(ts, js)


# (M, K, N): ragged against every tile size of the kernel, and the
# reference's own 256-blocking
MATMUL_SHAPES = [(5, 64, 16), (37, 96, 80), (20, 512, 48)]


def _jax_codes(x32, s, z):
    """The reference's activation codes (int8_matmul.py, the expression
    before its Pallas call)."""
    return jnp.clip(jnp.clip(jnp.round(x32 / s) + z, 0, 255) - z, -127, 127
                    ).astype(jnp.int8)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_int8_matmul_plain_version_matches_reference(shape, dtype, static):
    m, k, n = shape
    x = _rand((m, k), 60 + m, 1.3, 0.4)
    w = _rand((k, n), 61 + n, 0.05)
    if dtype == "bfloat16":
        tx, jx = _bf16(x)
    else:
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    jqw, js = jim.quantize_weights_int8(jnp.asarray(w))
    tqw, ts = torch.from_numpy(np.array(jqw)), torch.from_numpy(np.array(js))
    kw = dict(x_scale=0.0213, x_zero=117.0) if static else {}
    launches = tim.launches
    out = tim.int8_matmul(tx, tqw, ts, **kw)
    assert tim.launches == launches                 # CPU tensors: the plain version
    assert out.dtype == torch.float32 and out.shape == (m, n)
    _eq(out, jim.int8_matmul(jx, jqw, js, **kw))
    s, z = tim.activation_qparams(tx, kw.get("x_scale"), kw.get("x_zero"))
    codes = tim.quantize_activations(tx, s, z)
    x32 = jnp.asarray(jx, jnp.float32)
    if static:
        js_x, jz_x = jnp.float32(kw["x_scale"]), jnp.float32(kw["x_zero"])
    else:
        x_min = jnp.minimum(jnp.min(x32), 0.0)
        x_max = jnp.maximum(jnp.max(x32), 0.0)
        js_x = jnp.maximum((x_max - x_min) / 255.0, 1e-8)
        jz_x = jnp.clip(jnp.round(-x_min / js_x), 0, 255)
    _eq(s, js_x)
    _eq(z, jz_x)
    _eq(codes, _jax_codes(x32, js_x, jz_x))
    if not static:   # the reference's fp oracle: dequantize, then an f32 matmul
        np.testing.assert_allclose(out.numpy(), np.asarray(jref.int8_matmul_ref(jx, jqw, js)),
                                   atol=1e-5, rtol=1e-5)


def test_int8_matmul_on_cpu_never_builds(monkeypatch):
    build = importlib.import_module("repro_torch.kernels.build")

    def refuse(name):
        raise AssertionError(f"built {name} for CPU tensors")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(tim, "load", refuse)
    x = torch.from_numpy(_rand((3, 32), 70))
    wq, ws = tim.quantize_weights_int8(torch.from_numpy(_rand((32, 16), 71)))
    assert tim.int8_matmul(x, wq, ws).shape == (3, 16)


def test_linear_int8_and_cache_match_reference():
    jc = japply(jsmoke(), "vanilla")
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tsmoke(), device="cpu")
    jcache, tcache = jw8.build_int8_cache(jp), tw8.build_int8_cache(tp)
    assert sorted(jcache) == sorted(tcache)
    assert not any("lm_head" in p for p in tcache)
    assert tw8.int8_cache_bytes(tcache) == jw8.int8_cache_bytes(jcache)
    path = next(p for p in tcache if p.endswith("/mlp/up/w"))
    x = _rand((2, 3, 64), 72)
    _eq(tw8.linear_int8(tcache, path, torch.from_numpy(x)),
        jw8.linear_int8(jcache, path, jnp.asarray(x)))


@pytest.mark.parametrize("scan", [False, True], ids=["layers", "groups"])
def test_attach_int8_weights_leaves_equal_reference(scan):
    """Same leaf set and equal leaves, the attention gate's unused pair
    included; a stacked (G, K, N) weight gets per-layer (G,) scales."""
    jc = dataclasses.replace(japply(jsmoke(), "gated_attention"), scan_layers=scan)
    tc = dataclasses.replace(tapply(tsmoke(), "gated_attention"), scan_layers=scan)
    jp = jtr.model_init(jax.random.PRNGKey(3), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    ja = dict(jmod.flatten_params(jw8.attach_int8_weights(jp)))
    ta = dict(tmod.flatten_params(tw8.attach_int8_weights(tp)))
    assert sorted(ta) == sorted(ja)
    assert any(p.endswith("gate/w_q8") and "/mlp/" not in p for p in ta)
    assert not any("lm_head" in p and "q8" in p for p in ta)
    for p, leaf in ta.items():
        assert leaf.dtype == {"w_q8": torch.int8, "w_scale": torch.float32}.get(
            p.rsplit("/", 1)[-1], leaf.dtype)
        _eq(leaf.float() if leaf.dtype == torch.bfloat16 else leaf,
            np.asarray(ja[p], np.float32) if leaf.dtype == torch.bfloat16 else ja[p])
    scales = [v for p, v in ta.items() if p.endswith("w_scale")]
    assert all(s.shape == ((jc.n_groups,) if scan else ()) for s in scales)
