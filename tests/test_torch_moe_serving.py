"""The MoE archs served by the port's batcher against the JAX package's, on
the CPU, in float32.

``repro_torch.serving.ContinuousBatcher(paged=True, device="cpu")`` and
the reference's get the same converted ``smoke()`` weights of
granite-moe-1b-a400m and qwen2-moe-a2.7b and the same requests (batch 2,
a token budget of 32, so the 40-token prompt prefills in chunks beside
decoding rows whose padded tails are dead tokens). Greedy tokens must be equal, fp and
W8A8 (``qconfig=QConfig()``: each engine calibrates on its own threefry
tokens; qwen2-moe's shared experts run through the int8 product), in the
smoke configs' dense MoE mode and in dispatch mode at a capacity that
drops claims (counted through ``dropped_claims``).

Dispatch mode couples the tokens of a tick: whether a claim drops depends
on every other live token of its group, so a different chunking or a
prefix-cache hit changes the function. The serving invariants (chunk-size
invariance, prefix-cache warm == cold) are asserted in dense mode only."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro_torch.configs import base as tbase
from repro_torch.convert import from_jax_params

jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
jqc = importlib.import_module("repro.quant.qconfig")
ttr = importlib.import_module("repro_torch.models.transformer")
tlay = importlib.import_module("repro_torch.nn.layers")
tmoe = importlib.import_module("repro_torch.nn.moe")
tserve = importlib.import_module("repro_torch.serving")
tqc = importlib.import_module("repro_torch.quant.qconfig")

ENGINE = dict(batch_size=2, max_len=64, paged=True, block_size=16, token_budget=32)
DROPS = dict(exec_mode="dispatch", capacity_factor=0.5, group_size=16)
GRANITE, QWEN2 = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
_MODELS: dict = {}


def _models(arch, mode):
    """(jax cfg, jax params, port cfg, port params) of ``arch``'s smoke(),
    its MoE in ``mode`` ("dense", the smoke default, or "dispatch" at
    ``DROPS``)."""
    if (arch, mode) not in _MODELS:
        jc, tc = jbase.get_arch(arch).smoke(), tbase.get_arch(arch).smoke()
        if mode == "dispatch":
            jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **DROPS))
            tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **DROPS))
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[(arch, mode)] = (jc, jp, tc, tp)
    return _MODELS[(arch, mode)]


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (5, 40, 11)]


def _run(batcher_cls, req_cls, params, cfg, prompts, max_new=6, **kw):
    b = batcher_cls(params, cfg, **{**ENGINE, **kw})
    for u, p in enumerate(prompts):
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=max_new))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


def _port(tp, tc, prompts, **kw):
    out, b = _run(tserve.ContinuousBatcher, tserve.Request, tp, tc, prompts,
                  device="cpu", debug_audit=True, **kw)
    b.audit()
    assert b.allocator.available == b.num_blocks and (b.tables == -1).all()
    return out, b


@pytest.mark.parametrize("arch,mode,w8a8", [
    (GRANITE, "dense", False), (GRANITE, "dispatch", False), (GRANITE, "dense", True),
    (QWEN2, "dense", False), (QWEN2, "dispatch", False), (QWEN2, "dense", True),
    (QWEN2, "dispatch", True)])
def test_moe_paged_batcher_tokens_equal_reference(arch, mode, w8a8, monkeypatch):
    jc, jp, tc, tp = _models(arch, mode)
    drops, int8_sites = [], []
    moe_apply, int8_apply = ttr.moe_apply, tlay._linear_int8_apply

    def count_drops(p, x, cfg, ctx=tmoe.NO_QUANT, name="moe", active=None):
        drops.append(tmoe.dropped_claims(p, x, cfg, ctx, name, active))
        return moe_apply(p, x, cfg, ctx, name, active)

    def spy(p, x, ctx, name):
        int8_sites.append(name)
        return int8_apply(p, x, ctx, name)
    monkeypatch.setattr(ttr, "moe_apply", count_drops)
    monkeypatch.setattr(tlay, "_linear_int8_apply", spy)
    jkw, tkw = (dict(qconfig=jqc.QConfig()), dict(qconfig=tqc.QConfig())) if w8a8 else ({}, {})
    ref, _ = _run(jserve.ContinuousBatcher, jserve.Request, jp, jc, _prompts(), **jkw)
    b = tserve.ContinuousBatcher(tp, tc, **ENGINE, device="cpu", debug_audit=True, **tkw)
    drops.clear(), int8_sites.clear()            # the W8A8 engine's calibration
    for u, prompt in enumerate(_prompts()):
        b.submit(tserve.Request(uid=u, prompt=prompt, max_new_tokens=6))
    b.run()
    b.audit()
    assert b.allocator.available == b.num_blocks and (b.tables == -1).all()
    out = {r.uid: r.output.tolist() for r in b.done}
    assert out == ref
    assert len(out) == 3 and all(len(v) == 6 for v in out.values())
    assert len(drops) == b.forward_calls * tc.n_layers
    assert (sum(drops) > 0) == (mode == "dispatch")
    shared = {n for n in int8_sites if "/moe/shared/" in n}
    if w8a8 and tc.moe.n_shared_experts:
        assert shared == {f"layer_attn0/moe/shared/{w}" for w in ("gate", "up", "down")}
        layer = b.params["layers"][0]["b0"]["moe"]
        assert "w_q8" in layer["shared"]["down"] and "w_q8" not in layer["router"]
        assert layer["router"]["w"].dtype == torch.float32
    else:
        assert not shared
    assert bool(int8_sites) == w8a8


@pytest.mark.parametrize("arch", [GRANITE, QWEN2])
def test_moe_dense_mode_serving_invariants(arch):
    """In dense MoE mode a token's output depends on no other token: the
    tokens are the same at token budgets 4 and 64, and a prefix-cache warm
    admission equals a cold one."""
    _, _, tc, tp = _models(arch, "dense")
    tight, _ = _port(tp, tc, _prompts(), token_budget=4)
    wide, _ = _port(tp, tc, _prompts(), token_budget=64)
    assert tight == wide
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 120, size=19).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 120, size=n).astype(np.int32)])
               for n in (3, 6)]
    outs = []
    for prefix_cache in (False, True):
        b = tserve.ContinuousBatcher(tp, tc, **ENGINE, prefix_cache=prefix_cache,
                                     device="cpu", debug_audit=True)
        for u, p in enumerate(prompts):        # one after the other: a warm hit
            b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=5))
            b.run()
        outs.append({r.uid: r.output.tolist() for r in b.done})
        b.audit()
    assert outs[0] == outs[1]
    assert b.shared_admissions > 0
