"""The port's Mixture-of-Experts layer (``repro_torch.nn.moe``) against the
JAX package's (``repro.nn.moe``), on the CPU, in float32 at atol 2e-5.

Each check converts the reference's ``moe_init`` weights (numpy in
between) and feeds both packages the same numpy inputs from a seed. The
cases of ``tests/test_models_nn.py::TestMoE`` held against the reference
itself: dense == dispatch at slack capacity, dispatch at capacity 0.25
(claims dropped), shared experts and the aux losses, the uniform router's
load-balance loss, the dead-row mask, and the gradient of every leaf
against ``jax.grad``. Added: a token count ``group_size`` does not divide
(the pad path), all-zero router rows (every probability ties: the
reference's top-k takes the lowest indices in index order, and the slot
order decides which claims drop), the router kept in f32 in a bf16 model
(through ``model_init``, ``to_bf16`` and ``attach_int8_weights``), and
``dropped_claims`` / ``dispatch_ref`` (a host loop replaying the claims)
against the dispatch. Whole models: both MoE archs' smoke() in dispatch
mode at capacity 0.5 in groups of 16 (claims drop in every layer):
logits (atol 1e-4) and one train step (loss rtol 1e-6, metrics, per-tensor
gradients at relative L2 1e-2) against the reference, with the helpers of
``tests/test_torch_archs.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jm
from repro_torch.configs import base as tbase
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import model_init
from repro_torch.nn import moe as tm
from repro_torch.nn.module import flatten_params, tree_map
from repro_torch.quant.int8_weights import attach_int8_weights
from repro_torch.quant.qconfig import NO_QUANT
from test_torch_archs import MOE_ARCHS, _batch, _check_logits, _check_train_step, _models
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL = 2e-5
BF16_ATOL = 2e-2
# whole models' dispatch at a capacity that drops claims (smoke configs run dense)
MOE_DROPS = dict(exec_mode="dispatch", capacity_factor=0.5, group_size=16)


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
                    if np.asarray(x).dtype.name == "bfloat16"
                    else torch.from_numpy(np.array(x)), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(d_model=32, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) of one MoE layer."""
    jc, tc = jm.MoEConfig(**kw), tm.MoEConfig(**kw)
    jp = jm.moe_init(jax.random.PRNGKey(seed), d_model, jc)
    return jc, jp, tc, _t(jp)


def _both(jc, jp, tc, tp, x, active=None):
    jy, jaux = jm.moe_apply(jp, jnp.asarray(x), jc,
                            active=None if active is None else jnp.asarray(active))
    ty, taux = tm.moe_apply(tp, torch.from_numpy(x), tc,
                            active=None if active is None else torch.from_numpy(active))
    return (np.asarray(jy), jaux), (ty.numpy(), taux)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=0)


def _aux_close(taux, jaux):
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6, atol=ATOL)


# ---------------------------------------------------------------------------
# the reference's TestMoE, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["dense", "dispatch"])
def test_dispatch_matches_dense_with_slack_capacity(mode):
    kw = dict(n_experts=8, top_k=2, d_ff=16, capacity_factor=8.0, group_size=64)
    jc, jp, tc, tp = _cfgs(exec_mode=mode, **kw)
    x = _x((2, 50, 32), 0)
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    _close(ty, jy)
    _aux_close(taux, jaux)
    dense, _ = tm.moe_apply(tp, torch.from_numpy(x), dataclasses.replace(tc, exec_mode="dense"))
    _close(ty, dense.numpy(), 1e-5)
    assert tm.dropped_claims(tp, torch.from_numpy(x), tc) == 0


def test_tight_capacity_drops_and_matches_reference():
    jc, jp, tc, tp = _cfgs(n_experts=8, top_k=2, d_ff=16, capacity_factor=0.25,
                           group_size=64, exec_mode="dispatch")
    x = _x((2, 64, 32), 1)
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    assert np.isfinite(ty).all()
    _close(ty, jy)
    _aux_close(taux, jaux)
    drops = tm.dropped_claims(tp, torch.from_numpy(x), tc)
    assert drops > 0
    ref, ref_drops = tm.dispatch_ref(tp, torch.from_numpy(x), tc)
    assert ref_drops == drops
    _close(ty, ref.numpy(), 1e-5)
    # claims replayed token-major keep other pairs: the yardstick tells
    token_major, _ = tm.dispatch_ref(tp, torch.from_numpy(x), tc, order="token")
    assert np.abs(token_major.numpy() - ty).max() > 1e-3


@pytest.mark.parametrize("mode", ["dense", "dispatch"])
def test_shared_experts_and_aux_losses(mode):
    jc, jp, tc, tp = _cfgs(n_experts=4, top_k=2, d_ff=16, n_shared_experts=2,
                           shared_d_ff=24, capacity_factor=4.0, group_size=32,
                           exec_mode=mode)
    assert tc.shared_ff == jc.shared_ff == 24
    assert sorted(tp["shared"]) == ["down", "gate", "up"]
    x = _x((1, 32, 32), 2)
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    assert ty.shape == (1, 32, 32)
    _close(ty, jy)
    _aux_close(taux, jaux)
    assert float(taux["load_balance"]) > 0


def test_load_balance_loss_minimal_when_uniform():
    """A zero router: every probability ties, so the reference routes every
    token to expert 0 (top-1, lowest index) and the load balance is 1."""
    jc, jp, tc, tp = _cfgs(d_model=16, n_experts=4, top_k=1, d_ff=8, exec_mode="dense")
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    x = _x((1, 256, 16), 3)
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    _close(ty, jy)
    _aux_close(taux, jaux)
    assert float(taux["load_balance"]) == pytest.approx(1.0, abs=0.15)


def test_inactive_rows_do_not_claim_capacity():
    """top_k == n_experts: claims per expert == live tokens, so with cap =
    one row's tokens the live row fits only if the dead row is masked."""
    kw = dict(n_experts=4, top_k=4, d_ff=32, capacity_factor=0.5, group_size=4096)
    jc, jp, tc, tp = _cfgs(d_model=16, exec_mode="dispatch", **kw)
    x = _x((2, 32, 16), 4)
    active = np.array([True, False])
    (jy, _), (ty, _) = _both(jc, jp, tc, tp, x, active)
    _close(ty, jy)
    dense, _ = tm.moe_apply(tp, torch.from_numpy(x), dataclasses.replace(tc, exec_mode="dense"))
    _close(ty[0], dense[0].numpy(), 1e-5)
    assert tm.dropped_claims(tp, torch.from_numpy(x), tc, active=torch.from_numpy(active)) == 0
    # capacity is contended: with both rows live the first row's claims drop
    (jb, _), (tb, _) = _both(jc, jp, tc, tp, x)
    _close(tb, jb)
    assert np.abs(tb[0] - dense[0].numpy()).max() > 1e-4
    assert tm.dropped_claims(tp, torch.from_numpy(x), tc) > 0


def test_per_token_mask_equals_removing_the_dead_tokens():
    """A (B, T) mask (a chunked tick's padding tails): the live tokens'
    outputs equal those of the live tokens alone at the same capacity (the
    capacity factor scaled by 48 / 27, since ``cap`` follows the group's
    size, dead tokens included), with claims dropped; unmasked, the dead
    tokens displace live claims and the outputs move."""
    jc, jp, tc, tp = _cfgs(n_experts=4, top_k=2, d_ff=16, capacity_factor=0.3,
                           group_size=4096, exec_mode="dispatch")
    x = _x((2, 24, 32), 5)
    active = np.zeros((2, 24), dtype=bool)
    active[0, :20], active[1, :7] = True, True
    (jy, _), (ty, _) = _both(jc, jp, tc, tp, x, active)
    _close(ty, jy)
    live = torch.from_numpy(x[active][None])
    tc_alone = dataclasses.replace(tc, capacity_factor=0.3 * 48 / 27)
    assert tm.dispatch_capacity(tc_alone, 27)[2] == tm.dispatch_capacity(tc, 48)[2] == 8
    alone, _ = tm.moe_apply(tp, live, tc_alone)
    _close(ty[active], alone[0].numpy(), 1e-5)
    drops = tm.dropped_claims(tp, torch.from_numpy(x), tc, active=torch.from_numpy(active))
    assert drops == tm.dropped_claims(tp, live, tc_alone) > 0
    unmasked, _ = tm.moe_apply(tp, torch.from_numpy(x), tc)
    assert np.abs(unmasked.numpy()[active] - ty[active]).max() > 1e-4


@pytest.mark.parametrize("seed", range(5))
def test_grad_matches_reference(seed):
    kw = dict(n_experts=4, top_k=2, d_ff=8, capacity_factor=2.0, group_size=32,
              exec_mode="dispatch")
    jc, jp, tc, tp = _cfgs(d_model=16, seed=seed, **kw)
    x = _x((1, 32, 16), 10 + seed)
    jg = jax.grad(lambda pp: jm.moe_apply(pp, jnp.asarray(x), jc)[0].sum())(jp)
    live = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    leaves = [t for _, t in flatten_params(live)]
    tm.moe_apply(live, torch.from_numpy(x), tc)[0].sum().backward()
    want = dict(flatten_params(_t(jg)))
    gn = 0.0
    for (path, _), t in zip(flatten_params(live), leaves):
        _close(t.grad.numpy(), want[path].numpy(), 1e-4)
        gn += float(t.grad.abs().sum())
    assert np.isfinite(gn) and gn > 0


# ---------------------------------------------------------------------------
# added: the pad path, ties, the router's dtype
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_token_count_not_a_multiple_of_group_size(cf):
    """40 tokens in groups of 16: three groups, the last padded by 8."""
    jc, jp, tc, tp = _cfgs(n_experts=4, top_k=2, d_ff=16, n_shared_experts=1,
                           capacity_factor=cf, group_size=16, exec_mode="dispatch")
    assert tm.dispatch_capacity(tc, 40) == (16, 3, 8 if cf < 1 else 32)
    x = _x((1, 40, 32), 6)
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    assert ty.shape == (1, 40, 32)
    _close(ty, jy)
    _aux_close(taux, jaux)
    drops = tm.dropped_claims(tp, torch.from_numpy(x), tc)
    assert (drops > 0) == (cf < 1)
    ref, ref_drops = tm.dispatch_ref(tp, torch.from_numpy(x), tc)
    assert ref_drops == drops
    shared = ty - tm.moe_apply(tp, torch.from_numpy(x),
                               dataclasses.replace(tc, n_shared_experts=0))[0].numpy()
    _close(ty - shared, ref.numpy(), 1e-5)


@pytest.mark.parametrize("e,k", [(32, 8), (60, 4)])
def test_zero_rows_tie_toward_the_lowest_index(e, k):
    """All-zero inputs make every router logit 0: the reference picks
    experts 0..k-1 in that order (``torch.topk`` would not), and at a
    capacity that drops, the slot order decides which claims go."""
    jc, jp, tc, tp = _cfgs(n_experts=e, top_k=k, d_ff=8, capacity_factor=0.25,
                           group_size=64, exec_mode="dispatch")
    x = _x((2, 40, 32), 7)
    x[0, ::3] = 0.0
    _, ti, _ = tm._router(tp, torch.from_numpy(x).reshape(-1, 32), tc)
    zero_rows = ti.reshape(2, 40, k)[0, ::3]
    assert (zero_rows == torch.arange(k)).all()
    _, ji, _ = jm._router(jp, jnp.asarray(x).reshape(-1, 32), jc, None, "moe")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    (jy, jaux), (ty, taux) = _both(jc, jp, tc, tp, x)
    assert tm.dropped_claims(tp, torch.from_numpy(x), tc) > 0
    _close(ty, jy)
    _aux_close(taux, jaux)


def test_router_stays_f32_in_a_bf16_model():
    """``moe_init`` in bf16, ``model_init`` of a bf16 config (``to_bf16``)
    and ``attach_int8_weights`` keep the router f32; the layer's output in
    bf16 agrees with the reference's at the bf16 tolerance and routes the
    same experts."""
    kw = dict(n_experts=6, top_k=2, d_ff=16, n_shared_experts=2, shared_d_ff=24,
              capacity_factor=2.0, group_size=64, exec_mode="dispatch")
    jc, tc = jm.MoEConfig(**kw), tm.MoEConfig(**kw)
    jp = jm.moe_init(jax.random.PRNGKey(0), 32, jc, dtype=jnp.bfloat16)
    tp = tree_map(lambda a: a.to(torch.bfloat16) if a.ndim == 3 or a.ndim == 2 and a.shape[1] != 6
                  else a, _t(jp))
    assert jp["router"]["w"].dtype == jnp.float32 and jp["w_up"].dtype == jnp.bfloat16
    assert tp["router"]["w"].dtype == torch.float32 and tp["w_up"].dtype == torch.bfloat16
    own = tm.moe_init(torch.Generator().manual_seed(0), 32, tc, dtype=torch.bfloat16)
    assert {p: str(v.dtype) for p, v in flatten_params(own)} == \
        {p: str(v.dtype) for p, v in flatten_params(tp)}
    x = _x((2, 16, 32), 8)
    jy, _ = jm.moe_apply(jp, jnp.asarray(x, dtype=jnp.bfloat16), jc)
    ty, _ = tm.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert ty.dtype == torch.bfloat16
    _close(ty.float().numpy(), np.asarray(jy, dtype=np.float32), BF16_ATOL)
    _, ti, _ = tm._router(tp, torch.from_numpy(x).to(torch.bfloat16).reshape(-1, 32), tc)
    _, ji, _ = jm._router(jp, jnp.asarray(x, dtype=jnp.bfloat16).reshape(-1, 32), jc, None,
                          "moe")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b"):
        cfg = tbase.to_bf16(tbase.get_arch(arch).smoke())
        params = attach_int8_weights(model_init(0, cfg, device="cpu"))
        dts = {p: v.dtype for p, v in flatten_params(params)}
        routers = [p for p in dts if p.endswith("moe/router/w")]
        assert len(routers) == cfg.n_layers
        assert all(dts[p] == torch.float32 for p in routers)
        assert all(dts[p] == torch.bfloat16 for p in dts if p.endswith(("w_gate", "w_down")))
        assert not any("router" in p and "w_q8" in p for p in dts)


def test_forced_routing_equals_own_routing_and_moves_tokens():
    """``_router(top_i=...)``: its own top-k choice forced gives the same
    outputs; another expert choice routes the tokens there."""
    _, _, tc, tp = _cfgs(n_experts=8, top_k=2, d_ff=16, exec_mode="dispatch",
                         capacity_factor=8.0, group_size=64)
    x2d = torch.from_numpy(_x((40, 32), 12))
    top_p, top_i, aux = tm._router(tp, x2d, tc)
    fp, fi, faux = tm._router(tp, x2d, tc, top_i=top_i)
    assert torch.equal(fi, top_i) and torch.equal(fp, top_p)
    assert all(torch.equal(aux[k], faux[k]) for k in aux)
    other = (top_i + 1) % 8
    op, oi, _ = tm._router(tp, x2d, tc, top_i=other)
    assert torch.equal(oi, other) and torch.allclose(op.sum(-1), torch.ones(40))
    moved = tm._moe_dispatch(tp, x2d, op, oi, tc)
    assert (moved - tm._moe_dispatch(tp, x2d, top_p, top_i, tc)).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# whole models in dispatch mode with drops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("check", ["logits", "train-step"])
@pytest.mark.parametrize("method", ["vanilla", "gated"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_with_drops_matches_reference(arch, method, check, monkeypatch):
    """Dispatch mode at capacity 0.5 in groups of 16 over 2 x 32 tokens:
    claims drop in every layer, in both packages alike."""
    jc, jp, tc, tp = _models(arch, method, moe=MOE_DROPS)
    drops, real = [], ttr.moe_apply

    def count(p, x, cfg, ctx=NO_QUANT, name="moe", active=None):
        drops.append(tm.dropped_claims(p, x, cfg, ctx, name, active))
        return real(p, x, cfg, ctx, name, active)
    monkeypatch.setattr(ttr, "moe_apply", count)
    batch = _batch(tc, t=32, labels=check == "train-step")
    if check == "logits":
        _check_logits(jc, jp, tc, tp, batch)
    else:
        _check_train_step(jc, jp, tc, tp, batch)
    assert len(drops) == tc.n_layers and all(d > 0 for d in drops), drops
