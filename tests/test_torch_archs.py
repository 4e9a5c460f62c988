"""The port's architecture registry and its dense configs against the JAX
package, on the CPU, in float32.

  * the registry (``repro_torch.configs``): ``list_archs`` is the
    reference's; every ``full()`` and ``smoke()`` field by field (a MoE
    config's ``MoEConfig`` and an xLSTM config's ``XLSTMConfig`` too), ``family``,
    ``skip_shapes``, ``source`` and ``SHAPES``; ``input_specs`` and
    ``cache_specs`` (meta-device tensors) against the reference's
    ``ShapeDtypeStruct`` trees, shape and dtype, at every shape an arch
    runs;
  * every ported arch's ``smoke()`` (tokens, embeds and mixed inputs,
    sandwich norms, local/global patterns, Griffin, MoE, xLSTM) under vanilla,
    clipped and gated attention: cache-free logits against
    ``repro.models.model_apply`` (atol 1e-4) and one train step's loss
    (rtol 1e-6) and gradients (relative L2 1e-2 per tensor) against
    ``jax.value_and_grad`` of the reference's loss (the Griffin config's
    through the RG-LRU's reverse scan against XLA's gradient of the
    reference's associative scan); the MoE archs' loss terms (``moe_aux``, ``moe_lb``/``moe_z``) among them (their
    dispatch mode with drops: ``tests/test_torch_moe.py``, through
    ``_check_logits`` / ``_check_train_step``);
  * ``convert.from_jax_params`` on the new leaves (``frontend_proj``,
    ``post_ln1``/``post_ln2``, an embeds config's ``lm_head``, the MoE
    router, expert stacks and shared experts, the xLSTM blocks' leaves in a
    scanned stack);
  * decode-cache consistency (a dense cache fed token by token against
    the cache-free forward), as ``tests/test_archs.py`` checks the
    reference;
  * in ``tests/test_torch_archs_serving.py``: ``ContinuousBatcher(paged=True)``
    greedy tokens on gemma2's and phi-3-vision's ``smoke()`` bitwise the
    reference batcher's;
  * in ``tests/test_torch_archs_vit.py``: ViT-S/16 at its full width (B 2,
    T 197): logits, ``evaluate`` (FP perplexity and outlier statistics,
    rtol 1e-5) and the W8A8 fake-quant perplexity (rtol 1e-3) over embeds
    batches.

The train step's test is in ``tests/test_torch_archs_train.py``. The three
split files hold one family of cases each, so that ``--dist loadfile``
spreads them over workers; their helpers stay here."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import paper_models as jpm
from repro_torch.configs import base as tbase
from repro_torch.configs import paper_models as tpm
from repro_torch.convert import from_jax_params
from repro_torch.nn.module import flatten_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jtr = importlib.import_module("repro.models.transformer")
ttr = importlib.import_module("repro_torch.models.transformer")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
jstep = importlib.import_module("repro.train.step")
tstep = importlib.import_module("repro_torch.train.step")
jloop = importlib.import_module("repro.train.loop")
tloop = importlib.import_module("repro_torch.train.loop")
jloss = importlib.import_module("repro.train.losses")
tloss = importlib.import_module("repro_torch.train.losses")
jptq = importlib.import_module("repro.quant.ptq")
tptq = importlib.import_module("repro_torch.quant.ptq")
jqc = importlib.import_module("repro.quant.qconfig")
tqc = importlib.import_module("repro_torch.quant.qconfig")

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
PORTED = sorted(jbase.list_archs())
METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
ATOL = 1e-4            # logits (tests/test_torch_paper_models.py)
LOSS_RTOL = 1e-6       # a train step's loss (tests/test_torch_train.py)
GRAD_REL = 1e-2        # a train step's gradients, per tensor (same file)
RTOL = 1e-5            # perplexity and outlier summaries
PTQ_RTOL = 1e-3        # W8A8 perplexity (codes at a rounding edge flip)
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,), static_argnames=("collect_acts",))
_MODELS: dict = {}


def _models(arch, method, maker="smoke", moe=None, **replace):
    """(jax cfg, jax params, port cfg, port params), built once each;
    ``moe`` replaces fields of the MoE config in both packages."""
    key = (arch, method, maker, tuple(sorted((moe or {}).items())),
           tuple(sorted(replace.items())))
    if key not in _MODELS:
        name, kw = METHODS[method]
        if arch == "vit-s16":
            jc0, tc0 = jpm.vit_s16(), tpm.vit_s16()
        else:
            jc0 = getattr(jbase.get_arch(arch), maker)()
            tc0 = getattr(tbase.get_arch(arch), maker)()
        jc = dataclasses.replace(jbase.apply_method(jc0, name, **kw), **replace)
        tc = dataclasses.replace(tbase.apply_method(tc0, name, **kw), **replace)
        if moe:
            jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
            tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, jp, tc, tp)
    return _MODELS[key]


def _batch(cfg, b=2, t=16, seed=0, labels=True):
    """Numpy inputs of ``cfg``'s input kind (and labels)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    elif cfg.input_kind == "embeds":
        out["embeds"] = rng.standard_normal((b, t, cfg.frontend_dim)).astype(np.float32)
    else:
        n = cfg.n_prefix_embeds
        out["embeds"] = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, t - n)).astype(np.int32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _leaves(tree):
    """Leaves in ``jax.tree_util``'s order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _dtype_name(x):
    return str(x).replace("torch.", "")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_list_archs_is_the_reference_minus_the_unported():
    """Named when xLSTM was unported; now nothing is, and ``list_archs()``
    is the reference's."""
    assert tbase.list_archs() == PORTED == sorted(jbase.list_archs())
    assert set(MOE_ARCHS) | {"xlstm-1.3b"} <= set(PORTED)
    assert tbase.get_arch("xlstm-1.3b").family == "ssm"
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_arch("no-such-arch")


def test_shapes_and_skip_reasons_equal_reference():
    assert tbase.SHAPES == {k: tbase.ShapeSpec(*dataclasses.astuple(v))
                            for k, v in jbase.SHAPES.items()}
    for name in ("SKIP_LONG", "SKIP_DECODE_ENC", "SKIP_LONG_ENC"):
        assert getattr(tbase, name) == getattr(jbase, name)


def _fields_equal(t, j):
    skip = {"softmax_cfg", "gate_cfg", "moe", "rglru", "xlstm", "param_dtype",
            "compute_dtype"}
    for f in dataclasses.fields(t):
        if f.name not in skip:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in ("param_dtype", "compute_dtype"):
        assert _dtype_name(getattr(t, f)) == jnp.dtype(getattr(j, f)).name
    if j.xlstm is None:
        assert t.xlstm is None
    else:
        assert type(t.xlstm).__name__ == "XLSTMConfig"
        assert dataclasses.asdict(t.xlstm) == dataclasses.asdict(j.xlstm)
        assert (t.xlstm.d_inner, t.xlstm.dh_inner, t.xlstm.dh_model) == \
            (j.xlstm.d_inner, j.xlstm.dh_inner, j.xlstm.dh_model)
    if j.moe is None:
        assert t.moe is None
    else:
        assert type(t.moe).__name__ == "MoEConfig"
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert t.moe.shared_ff == j.moe.shared_ff
    if j.rglru is not None:
        assert dataclasses.asdict(t.rglru) == dataclasses.asdict(j.rglru)


@pytest.mark.parametrize("arch", PORTED)
def test_arch_spec_equals_reference(arch):
    js, ts = jbase.get_arch(arch), tbase.get_arch(arch)
    assert (ts.arch_id, ts.family, ts.skip_shapes, ts.source) == \
        (js.arch_id, js.family, js.skip_shapes, js.source)
    for shape in tbase.SHAPES:
        assert ts.skipped(shape) == js.skipped(shape)
    _fields_equal(ts.full(), js.full())
    _fields_equal(ts.smoke(), js.smoke())
    ttr.check_supported(ts.full())
    ttr.check_supported(ts.smoke())


@pytest.mark.parametrize("arch", PORTED)
def test_input_and_cache_specs_equal_reference(arch):
    """Shapes and dtypes of every cell the arch runs; nothing allocated
    (meta tensors)."""
    js, ts = jbase.get_arch(arch), tbase.get_arch(arch)
    jc, tc = js.full(), ts.full()
    for name, shape in tbase.SHAPES.items():
        if ts.skipped(name):
            continue
        want = jbase.input_specs(jc, jbase.SHAPES[name])
        got = tbase.input_specs(tc, shape)
        assert list(got) == list(want), name
        for k, x in got.items():
            assert x.device.type == "meta"
            assert (tuple(x.shape), _dtype_name(x.dtype)) == \
                (tuple(want[k].shape), jnp.dtype(want[k].dtype).name), (name, k)
        jcache = jbase.cache_specs(jc, jbase.SHAPES[name])
        tcache = tbase.cache_specs(tc, shape)
        jl = jax.tree_util.tree_leaves_with_path(jcache)
        tl = list(_leaves(tcache))
        assert len(tl) == len(jl), name
        for (path, j), t in zip(jl, tl):
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                (tuple(j.shape), jnp.dtype(j.dtype).name), (name, jax.tree_util.keystr(path))


def test_to_bf16_equals_reference():
    for arch in ("hubert-xlarge", "gemma2-27b"):
        t = tbase.to_bf16(tbase.get_arch(arch).smoke())
        j = jbase.to_bf16(jbase.get_arch(arch).smoke())
        _fields_equal(t, j)


def test_check_supported_refuses_only_moe_and_xlstm():
    """Named when MoE and xLSTM were refused; now every registered arch's
    ``full()`` is accepted, and what is refused is a config the model cannot
    build: an unknown block kind, or a recurrent kind without its
    sub-config."""
    for arch in tbase.list_archs():
        ttr.check_supported(tbase.get_arch(arch).full())
    ttr.check_supported(tpm.vit_s16())
    cfg = tbase.get_arch("qwen3-14b").smoke()
    with pytest.raises(ValueError, match="unknown block kinds"):
        ttr.check_supported(dataclasses.replace(cfg, pattern=("attn", "rwkv")))
    with pytest.raises(ValueError, match="cfg.xlstm"):
        ttr.check_supported(dataclasses.replace(cfg, pattern=("attn", "mlstm")))
    with pytest.raises(ValueError, match="cfg.rglru"):
        ttr.check_supported(dataclasses.replace(cfg, pattern=("griffin",)))


# ---------------------------------------------------------------------------
# convert: the new leaves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,replace,new_leaves", [
    ("gemma2-27b", {}, ("['layers'][0]['b0']['post_ln1']['scale']",
                        "['layers'][1]['b1']['post_ln2']['scale']")),
    ("hubert-xlarge", {}, ("['frontend_proj']['w']", "['frontend_proj']['b']",
                           "['lm_head']['w']")),
    ("hubert-xlarge", {"tie_embeddings": True}, ("['frontend_proj']['w']", "['lm_head']['w']")),
    ("phi-3-vision-4.2b", {}, ("['embed']['table']", "['lm_head']['w']")),
    ("granite-moe-1b-a400m", {}, ("['layers'][0]['b0']['moe']['router']['w']",
                                  "['layers'][1]['b0']['moe']['w_gate']",
                                  "['layers'][1]['b0']['moe']['w_down']")),
    ("qwen2-moe-a2.7b", {"scan_layers": True},
     ("['groups']['b0']['moe']['router']['w']", "['groups']['b0']['moe']['w_up']",
      "['groups']['b0']['moe']['shared']['gate']['w']")),
    ("xlstm-1.3b", {"scan_layers": True, "n_layers": 5},
     ("['groups']['b0']['blk']['ifgate']['b']", "['groups']['b0']['blk']['norm']['scale']",
      "['groups']['b3']['blk']['rz']", "['groups']['b3']['blk']['ro']",
      "['tail']['t0']['blk']['up']['w']", "['tail']['t0']['ln']['bias']")),
], ids=["sandwich-norms", "embeds", "embeds-tied", "mixed", "moe", "moe-shared-scanned",
        "xlstm-scanned"])
def test_from_jax_params_carries_the_new_leaves(arch, replace, new_leaves):
    """Every leaf, path, dtype and value; an embeds config has no token
    table and always an untied head, as in the reference; ``model_init``
    makes the same tree."""
    jc, jp, tc, tp = _models(arch, "gated", **replace)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = list(_leaves(tp))
    assert len(tl) == len(jl)
    paths = [jax.tree_util.keystr(p) for p, _ in jl]
    assert set(new_leaves) <= set(paths)
    assert (tc.input_kind == "embeds") == ("['embed']['table']" not in paths)
    for (path, j), t in zip(jl, tl):
        assert _dtype_name(t.dtype) == str(j.dtype), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))
    own = ttr.model_init(0, tc, device="cpu")
    assert [(p, tuple(x.shape)) for p, x in flatten_params(own)] == \
        [(p, tuple(x.shape)) for p, x in flatten_params(tp)]


# ---------------------------------------------------------------------------
# every ported arch's smoke(): logits and one train step
# ---------------------------------------------------------------------------
def _check_logits(jc, jp, tc, tp, batch):
    jl, jaux = _jax_apply(jp, jc, _jb(batch), collect_acts=True)
    tl, taux = ttr.model_apply(tp, tc, _tb(batch), collect_acts=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(taux["attn_outputs"]) == len(jaux["attn_outputs"]) == tc.n_layers
    for a, b in zip(taux["attn_outputs"], jaux["attn_outputs"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux["moe_aux"][k]), float(jaux["moe_aux"][k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert (float(taux["moe_aux"]["load_balance"]) > 0) == (tc.moe is not None)
    return tl


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("arch", PORTED)
def test_smoke_logits_match_reference(arch, method):
    jc, jp, tc, tp = _models(arch, method)
    batch = _batch(tc, labels=False)
    tl = _check_logits(jc, jp, tc, tp, batch)
    assert tuple(tl.shape) == (2, 16, tc.padded_vocab)


def _check_train_step(jc, jp, tc, tp, batch):
    kind = "clm" if tc.causal else "frames"
    jt = jstep.TrainTask(cfg=jc, loss_kind=kind)
    tt = tstep.TrainTask(cfg=tc, loss_kind=kind)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jstep._loss_and_metrics(p, jt, _jb(batch)), has_aux=True)(jp)
    tl, tm, tg = tstep._grads(tp, tt, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert sorted(tm) == sorted(jm)
    assert ("moe_lb" in tm) == (tc.moe is not None)
    for k in ("loss", "moe_lb", "moe_z"):
        if k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL)
    want = dict(flatten_params(jax.tree_util.tree_map(np.asarray, jg)))
    for path, g in flatten_params(tg):
        w = want[path]
        if path.endswith("/k/b"):
            # zero in exact arithmetic: rounding noise on both sides
            assert np.abs(g.numpy() - w).max() < 1e-6, path
            continue
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_REL, (path, err)


# ---------------------------------------------------------------------------
# decode-cache consistency (the port's copy of tests/test_archs.py's)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-67b", "gemma2-27b", "recurrentgemma-9b",
                                  "qwen3-14b", *MOE_ARCHS, "xlstm-1.3b"])
def test_decode_cache_consistency(arch):
    cfg = dataclasses.replace(tbase.get_arch(arch).smoke(), max_seq_len=32)
    params = ttr.model_init(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full, _ = ttr.model_apply(params, cfg, {"tokens": toks})
        cache = ttr.init_cache(cfg, 2, 12, device="cpu")
        outs = []
        for t in range(12):
            lg, aux = ttr.model_apply(params, cfg, {"tokens": toks[:, t:t + 1]},
                                      cache=cache, pos=t)
            cache = aux["cache"]
            outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, dim=1).numpy(), atol=5e-3)
