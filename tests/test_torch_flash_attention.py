"""The port's dense attention against the JAX package's, on the CPU.

  * ``repro_torch.kernels.flash_attention.attention_ref`` (the CUDA
    kernel's plain version, which ``flash_attention`` runs on CPU tensors)
    against the reference's Pallas ``flash_attention`` in interpret mode
    and its oracle ``ref.attention_ref``, at the reference's own shapes and
    tolerance (atol 3e-5, f32): vanilla, clipped, gated, window, softcap,
    ``q_offset``;
  * ``mha_flash`` (GQA, model layout) against the reference's ``mha_flash``;
  * the ``attention`` dispatcher against the reference's on both of its
    CPU routes (dense, and chunked above tq*tk = 2048^2, here at a tiny
    width with T = 2100), at atol 2e-5, taking the same route;
  * the head dims 80 (hubert-xlarge) and 96 (phi-3-vision): the plain
    version against the Pallas kernel in interpret mode at a ragged T,
    causal and not, vanilla, clipped, gated, softcap and window (f32 at
    3e-5, bf16 against the oracle at 2e-2), and, without a card, the
    route each dtype takes and the arguments ``_launch`` hands the kernel
    (and the same at Dh 256, whose bf16 route is the tensor cores' too).

The kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``attention_ref`` there."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ops import mha_flash as jmha
from repro.kernels.ref import attention_ref as jref
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jatt = importlib.import_module("repro.core.attention")
jsm = importlib.import_module("repro.core.softmax")
tatt = importlib.import_module("repro_torch.core.attention")
tsm = importlib.import_module("repro_torch.core.softmax")
tfa = importlib.import_module("repro_torch.kernels.flash_attention")

ATOL = 3e-5
VARIANTS = {
    "vanilla": dict(), "clipped": dict(gamma=-0.03), "stretched": dict(gamma=-0.01, zeta=1.03),
    "noncausal": dict(causal=False), "window": dict(window=40),
    "softcap": dict(softcap=30.0, gamma=-0.02), "q_offset": dict(q_offset=5),
}


def _inputs(shape, seed=0, gate=False):
    bh, tq, tk, dh = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, tq, dh)).astype(np.float32)
    k = rng.standard_normal((bh, tk, dh)).astype(np.float32)
    v = rng.standard_normal((bh, tk, dh)).astype(np.float32)
    g = (1 / (1 + np.exp(-rng.standard_normal((bh, tq))))).astype(np.float32) if gate else None
    return q, k, v, g


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (3, 96, 160, 32)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_ref_vs_reference_kernel(shape, variant):
    kw = VARIANTS[variant]
    q, k, v, _ = _inputs(shape)
    got = tfa.attention_ref(_t(q), _t(k), _t(v), None, **kw).numpy()
    kern = np.asarray(jflash(_j(q), _j(k), _j(v), None, block_q=64, block_kv=64, **kw))
    oracle = np.asarray(jref(_j(q), _j(k), _j(v), None, **kw))
    np.testing.assert_allclose(got, kern, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)
    # the wrapper runs the plain version on CPU tensors
    np.testing.assert_array_equal(tfa.flash_attention(_t(q), _t(k), _t(v), **kw).numpy(), got)


@pytest.mark.parametrize("gamma", [0.0, -0.05])
def test_gated_vs_reference_kernel(gamma):
    q, k, v, g = _inputs((2, 64, 64, 32), seed=1, gate=True)
    got = tfa.attention_ref(_t(q), _t(k), _t(v), _t(g), gamma=gamma).numpy()
    kern = np.asarray(jflash(_j(q), _j(k), _j(v), _j(g), gamma=gamma, block_q=32, block_kv=32))
    np.testing.assert_allclose(got, kern, atol=ATOL)


def test_bf16_vs_reference_oracle():
    q = np.random.default_rng(2).standard_normal((2, 64, 64)).astype(np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    got = tfa.attention_ref(tq, tq, tq, None, gamma=-0.02)
    want = jref(jq, jq, jq, None, gamma=-0.02)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("variant", ["vanilla", "clipped", "window", "q_offset"])
def test_mha_flash_gqa_vs_reference(variant):
    kw = VARIANTS[variant]
    b, t, h, hkv, d = 2, 64, 8, 2, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    g = (1 / (1 + np.exp(-rng.standard_normal((b, t, h))))).astype(np.float32)
    got = tfa.mha_flash(_t(q), _t(k), _t(v), _t(g), **kw).numpy()
    want = np.asarray(jmha(_j(q), _j(k), _j(v), _j(g), block_q=32, block_kv=32, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a per-row offset tensor equal to the scalar gives the same result
    if "q_offset" in kw:
        off = torch.full((b,), kw["q_offset"], dtype=torch.int32)
        got2 = tfa.mha_flash(_t(q), _t(k), _t(v), _t(g), **{**kw, "q_offset": off})
        np.testing.assert_array_equal(got2.numpy(), got)


def _cfgs(softmax_kw, window=None, softcap=None, h=4, hkv=2, d=8, chunk=512):
    jc = jatt.AttentionConfig(n_heads=h, n_kv_heads=hkv, d_head=d, window=window,
                              logit_softcap=softcap, chunk_size=chunk,
                              softmax=jsm.ClippedSoftmaxConfig(**softmax_kw))
    tc = tatt.AttentionConfig(n_heads=h, n_kv_heads=hkv, d_head=d, window=window,
                              logit_softcap=softcap, chunk_size=chunk,
                              softmax=tsm.ClippedSoftmaxConfig(**softmax_kw))
    return jc, tc


ROUTES = [  # (name, t, softmax kw, window, softcap, gated)
    ("dense-vanilla", 64, {}, None, None, False),
    ("dense-clipped-alpha", 64, {"alpha": 4.0}, None, None, False),
    ("dense-gated-window", 64, {}, 16, None, True),
    ("chunked-vanilla", 2100, {}, None, None, False),
    ("chunked-clipped-alpha", 2100, {"alpha": 4.0}, None, None, False),
    ("chunked-gated-softcap", 2100, {"gamma": -0.01, "zeta": 1.02}, None, 20.0, True),
    ("chunked-window", 2100, {}, 300, None, False),
]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_attention_dispatcher_vs_reference(route, monkeypatch):
    name, t, sm_kw, window, softcap, gated = route
    jc, tc = _cfgs(sm_kw, window, softcap)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, t, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, t, 2, 8)).astype(np.float32)
    g = (1 / (1 + np.exp(-rng.standard_normal((1, t, 4))))).astype(np.float32) \
        if gated else None
    taken = []
    for fn in ("dense_attention", "chunked_attention"):
        real = getattr(tatt, fn)
        monkeypatch.setattr(tatt, fn, lambda *a, _r=real, _n=fn, **kw: (taken.append(_n),
                                                                         _r(*a, **kw))[1])
    got = tatt.attention(_t(q), _t(k), _t(v), tc, gate_pi=_t(g)).numpy()
    want = np.asarray(jax.jit(jatt.attention, static_argnums=(3,))(
        _j(q), _j(k), _j(v), jc, 0, _j(g)))
    assert taken == [name.split("-")[0] + "_attention"]
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_attention_routes_cuda_tensors_to_the_kernel(monkeypatch):
    """The device decides: a CUDA tensor goes to ``mha_flash`` with gamma
    resolved from the KV length (checked here with a stand-in tensor whose
    ``is_cuda`` is true, since this machine has no card)."""
    seen = {}

    def fake_mha(q, k, v, gate_pi, **kw):
        seen.update(kw)
        return q

    monkeypatch.setattr(tfa, "mha_flash", fake_mha)

    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    _, tc = _cfgs({"alpha": 4.0})
    q = torch.zeros(1, 10, 4, 8).as_subclass(Cuda)
    kv = torch.zeros(1, 10, 2, 8)
    tatt.attention(q, kv, kv, tc)
    assert seen["gamma"] == pytest.approx(-0.4) and seen["zeta"] == 1.0
    tatt.attention(q, kv, kv, dataclasses.replace(tc, softmax=tsm.ClippedSoftmaxConfig()))
    assert (seen["gamma"], seen["zeta"]) == (0.0, 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sm_kw", [{}, {"alpha": 4.0}], ids=["vanilla", "clipped"])
def test_scale_q_plain_version_matches_dense_attention(dtype, sm_kw):
    """The kernel's plain version scales q as the dense path does: q *
    Dh^-0.5 in q's dtype, then f32 scores. Against the port's
    ``dense_attention``: f32 at 3e-5, bf16 at 2e-2 (the dense path also
    rounds P to bf16 before P.V)."""
    _, tc = _cfgs(sm_kw, h=8, hkv=2, d=32)
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((2, 48, 8, 32)).astype(np.float32) * 2).to(dt)
    k = torch.from_numpy(rng.standard_normal((2, 48, 2, 32)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((2, 48, 2, 32)).astype(np.float32)).to(dt)
    sm = tc.softmax
    gamma, zeta = (0.0, 1.0) if sm.is_vanilla else (sm.resolve_gamma(48), sm.zeta)
    got = tfa.mha_flash(q, k, v, gamma=gamma, zeta=zeta)
    want = tatt.dense_attention(q, k, v, tc)
    assert got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=ATOL if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# head dims 80 and 96
# ---------------------------------------------------------------------------
NEW_DH = (80, 96)
NEW_DH_VARIANTS = {
    "vanilla": dict(), "noncausal": dict(causal=False),
    "clipped": dict(gamma=-0.03), "clipped-noncausal": dict(gamma=-0.03, causal=False),
    "gated": dict(), "clipped-gated": dict(gamma=-0.02, zeta=1.01),
    "softcap": dict(softcap=50.0), "window": dict(window=40, softcap=30.0),
}


@pytest.mark.parametrize("dh", NEW_DH)
@pytest.mark.parametrize("variant", list(NEW_DH_VARIANTS))
def test_new_head_dims_vs_reference_kernel(dh, variant):
    """T 100, a length no block of 32 divides."""
    kw = NEW_DH_VARIANTS[variant]
    q, k, v, g = _inputs((2, 100, 100, dh), seed=6, gate="gated" in variant)
    got = tfa.attention_ref(_t(q), _t(k), _t(v), _t(g), **kw).numpy()
    kern = np.asarray(jflash(_j(q), _j(k), _j(v), _j(g), block_q=32, block_kv=32, **kw))
    oracle = np.asarray(jref(_j(q), _j(k), _j(v), _j(g), **kw))
    np.testing.assert_allclose(got, kern, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)


@pytest.mark.parametrize("dh", NEW_DH)
@pytest.mark.parametrize("variant", ["vanilla", "clipped-noncausal"])
def test_new_head_dims_bf16_vs_reference_oracle(dh, variant):
    kw = NEW_DH_VARIANTS[variant]
    q, k, v, _ = _inputs((2, 100, 100, dh), seed=7)
    got = tfa.attention_ref(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                            None, **kw)
    want = jref(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), None, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("dh", NEW_DH)
def test_new_head_dims_mha_flash_gqa_vs_reference(dh):
    b, t, h, hkv = 2, 70, 4, 2
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    got = tfa.mha_flash(_t(q), _t(k), _t(v), None, gamma=-0.02).numpy()
    want = np.asarray(jmha(_j(q), _j(k), _j(v), None, gamma=-0.02, block_q=32, block_kv=32))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture
def fake_launch(monkeypatch):
    """``_launch`` with the library, the device guard and the stream stood
    in (this machine has no card): returns the argument tuples the kernel
    was handed."""
    calls = []

    class Lib:
        def flash_attention_launch(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tfa, "_kernel_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    return calls


@pytest.mark.parametrize("dh", (*NEW_DH, 256))
@pytest.mark.parametrize("dtype,want_route", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_new_head_dims_route_and_launch_arguments(dh, dtype, want_route, fake_launch):
    """bf16 at Dh 80 / 96 takes the tensor-core route (the Dh-128 body over
    zero-filled boxes), and so does bf16 at Dh 256 (a CTA a half of the
    columns); f32 takes the CUDA-core one; the kernel is handed the true
    head dim and q's scale Dh^-0.5."""
    assert dh in tfa._HEAD_DIMS
    assert tfa.route(dtype, dh) == ("tensor-core" if want_route else "cuda-core")
    q = torch.zeros(2, 8, 4, dh, dtype=dtype)
    kv = torch.zeros(2, 8, 2, dh, dtype=dtype)
    launches = tfa.launches
    out = tfa._launch(q, kv, kv, None, 0, True, None, 50.0, 0.0, 1.0)
    assert out.shape == q.shape and tfa.launches == launches + 1
    args = fake_launch[-1]
    assert args[11] == dh                                   # Dh
    assert args[6:11] == (2, 8, 8, 4, 2)                    # B, Tq, Tk, Hq, Hkv
    assert args[12:15] == (8 * 4 * dh, 4 * dh, dh)          # q's strides
    assert args[-2] == want_route and args[-3] == tfa._DTYPE_CODE[dtype]
    assert args[34] == pytest.approx(dh ** -0.5)            # scale
    # a view whose rows are not 16-byte aligned is refused, not copied
    wide = torch.zeros(2, 8, 4, dh + 8 // q.element_size(), dtype=dtype)[..., :dh]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        tfa._launch(wide, wide, wide, None, 0, True, None, None, 0.0, 1.0)
