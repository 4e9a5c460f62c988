"""The port's xLSTM modules (``repro_torch.nn.xlstm``) against the JAX
package's ``repro.nn.xlstm``, on the CPU, in float32.

Every check feeds both packages the same numpy inputs from a seed (block
weights from the reference's inits, converted), at atol 2e-5:

  * ``mlstm_chunkwise`` against the port's own recurrent oracle
    (``mlstm_recurrent_ref``), at T a chunk does not divide (the padded
    steps' sentinels: logf = 0, logi = -1e30), with a state split at T 10
    of 20, and from a given state; both against the reference's;
  * ``slstm_scan``, fresh and from a state, and split in two;
  * ``headwise_rmsnorm``; ``xlstm_init_state`` (shapes, dtypes, values);
  * the mLSTM and sLSTM blocks: the whole sequence against token by token
    (the mLSTM's recurrent form at T 1 with a state) and against chunks
    with the state carried, in both packages, and against the reference
    with a state in and out."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.nn.module import tree_map

jx = importlib.import_module("repro.nn.xlstm")
tx = importlib.import_module("repro_torch.nn.xlstm")

ATOL = 2e-5
CFG = dict(d_model=32, n_heads=4, chunk_size=8)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, atol=ATOL):
    got_l, want_l = jax.tree_util.tree_leaves(tree_map(_np, got)), \
        jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=atol, rtol=0)


def _cell_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    logi = rng.standard_normal((b, t, h)).astype(np.float32)
    logf = np.log(1.0 / (1.0 + np.exp(-(rng.standard_normal((b, t, h)) + 2.0)))).astype(
        np.float32)
    return q, k, v, logi, logf


def _split(xs, a, b):
    return [x[:, a:b] for x in xs]


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,chunk", [(20, 8), (16, 4), (7, 64)])
def test_mlstm_chunkwise_matches_recurrent_oracle_and_reference(t, chunk):
    ins = _cell_inputs(2, t, 4, 8, seed=t + chunk)
    got_h, got_s = tx.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=chunk)
    ref_h, ref_s = tx.mlstm_recurrent_ref(*map(torch.from_numpy, ins))
    _close(got_h, _np(ref_h))
    # the oracle's m starts at -inf, the chunkwise one at -1e30: after the
    # first input both are finite and equal
    _close(got_s, tuple(_np(x) for x in ref_s))
    jh, js = jx.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=chunk)
    _close(got_h, jh)
    _close(got_s, js)
    jh, js = jx.mlstm_recurrent_ref(*map(jnp.asarray, ins))
    _close(ref_h, jh)
    _close(ref_s, js)


def test_mlstm_state_split_at_10_of_20():
    ins = _cell_inputs(2, 20, 4, 8, seed=3)
    whole_h, whole_s = tx.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=8)
    h1, s1 = tx.mlstm_chunkwise(*map(torch.from_numpy, _split(ins, 0, 10)), chunk=8)
    h2, s2 = tx.mlstm_chunkwise(*map(torch.from_numpy, _split(ins, 10, 20)), chunk=8, state=s1)
    _close(torch.cat([h1, h2], dim=1), _np(whole_h))
    _close(s2, tuple(_np(x) for x in whole_s))
    # the recurrent form continues the chunkwise state, and the reference agrees
    r2, rs2 = tx.mlstm_recurrent_ref(*map(torch.from_numpy, _split(ins, 10, 20)), state=s1)
    _close(r2, _np(h2))
    _close(rs2, tuple(_np(x) for x in s2))
    jh1, js1 = jx.mlstm_chunkwise(*map(jnp.asarray, _split(ins, 0, 10)), chunk=8)
    jh2, js2 = jx.mlstm_chunkwise(*map(jnp.asarray, _split(ins, 10, 20)), chunk=8, state=js1)
    _close(h2, jh2)
    _close(s2, js2)


# ---------------------------------------------------------------------------
# sLSTM cell and the head-wise norm
# ---------------------------------------------------------------------------
def _slstm_inputs(b, t, d, h, seed):
    rng = np.random.default_rng(seed)
    zifo = [rng.standard_normal((b, t, d)).astype(np.float32) for _ in range(4)]
    dh = d // h
    r = {n: (0.3 * rng.standard_normal((h, dh, dh))).astype(np.float32)
         for n in ("rz", "ri", "rf", "ro")}
    return zifo, r


def test_slstm_scan_matches_reference_fresh_from_a_state_and_split():
    zifo, r = _slstm_inputs(2, 12, 32, 4, seed=5)
    th, ts = tx.slstm_scan(*map(torch.from_numpy, zifo), _t(r), 4)
    jh, js = jx.slstm_scan(*map(jnp.asarray, zifo), jax.tree_util.tree_map(jnp.asarray, r), 4)
    _close(th, jh)
    _close(ts, js)
    # split at 5: the state carries over
    h1, s1 = tx.slstm_scan(*(torch.from_numpy(x[:, :5]) for x in zifo), _t(r), 4)
    h2, s2 = tx.slstm_scan(*(torch.from_numpy(x[:, 5:]) for x in zifo), _t(r), 4, s1)
    _close(torch.cat([h1, h2], dim=1), _np(th))
    _close(s2, tuple(_np(x) for x in ts))
    jh2, js2 = jx.slstm_scan(*(jnp.asarray(x[:, 5:]) for x in zifo),
                             jax.tree_util.tree_map(jnp.asarray, r), 4,
                             tuple(jnp.asarray(_np(x)) for x in s1))
    _close(h2, jh2)
    _close(s2, js2)


def test_headwise_rmsnorm_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    p = {"scale": rng.standard_normal((4, 8)).astype(np.float32)}
    _close(tx.headwise_rmsnorm(_t(p), torch.from_numpy(x)),
           jx.headwise_rmsnorm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_state_equals_reference(kind):
    tcfg, jcfg = tx.XLSTMConfig(**CFG), jx.XLSTMConfig(**CFG)
    got = tx.xlstm_init_state(3, kind, tcfg, torch.bfloat16)
    want = jx.xlstm_init_state(3, kind, jcfg, jnp.bfloat16)
    assert isinstance(got["cell"], tuple) and len(got["cell"]) == len(want["cell"])
    gl = jax.tree_util.tree_leaves(tree_map(lambda x: x.float().numpy(), got))
    dtypes = jax.tree_util.tree_leaves(tree_map(lambda x: str(x.dtype), got))
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) == len(dtypes)
    for g, w, dt in zip(gl, wl, dtypes):
        assert g.shape == w.shape
        assert dt.replace("torch.", "") == jnp.dtype(w.dtype).name
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
_BLOCKS = {"mlstm": (jx.mlstm_block_init, jx.mlstm_block_apply, tx.mlstm_block_apply),
           "slstm": (jx.slstm_block_init, jx.slstm_block_apply, tx.slstm_block_apply)}


def _block(kind, seed=0):
    jinit, japply, tapply = _BLOCKS[kind]
    jcfg, tcfg = jx.XLSTMConfig(**CFG), tx.XLSTMConfig(**CFG)
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    tp = _t(jax.tree_util.tree_map(np.asarray, jp))
    # the port's own init makes the same tree
    own = (tx.mlstm_block_init if kind == "mlstm" else tx.slstm_block_init)(
        torch.Generator().manual_seed(0), tcfg)
    assert jax.tree_util.tree_structure(tree_map(_np, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp))
    for a, b in zip(jax.tree_util.tree_leaves(tree_map(_np, own)),
                    jax.tree_util.tree_leaves(jp)):
        assert a.shape == b.shape
    return jp, tp, jcfg, tcfg, japply, tapply


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_full_matches_token_by_token_chunks_and_reference(kind):
    jp, tp, jcfg, tcfg, japply, tapply = _block(kind)
    x = np.random.default_rng(11).standard_normal((2, 20, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    full_y, full_s = tapply(tp, xt, tcfg)
    jy, js = japply(jp, jnp.asarray(x), jcfg)
    _close(full_y, jy)
    _close(full_s, js)
    # token by token from a fresh state (the mLSTM's recurrent form at T 1)
    state = tx.xlstm_init_state(2, kind, tcfg)
    ys = []
    for s in range(20):
        y, state = tapply(tp, xt[:, s:s + 1], tcfg, state)
        ys.append(y)
    _close(torch.cat(ys, dim=1), _np(full_y))
    _close(state, tree_map(_np, full_s))
    # chunks 10 / 7 / 3 with the state carried, against the reference's
    state = jstate = None
    for a, b in ((0, 10), (10, 17), (17, 20)):
        y, state = tapply(tp, xt[:, a:b], tcfg, state)
        jyc, jstate = japply(jp, jnp.asarray(x[:, a:b]), jcfg, jstate)
        _close(y, jyc)
        _close(y, _np(full_y)[:, a:b])
    _close(state, jstate)
