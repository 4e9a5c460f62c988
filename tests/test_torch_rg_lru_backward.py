"""The gradient of the port's RG-LRU recurrence against the JAX package's,
on the CPU, in float32.

  * ``rglru_bwd_ref`` (the reverse scan the CUDA kernel's second entry
    point computes, and its plain version) and ``RGLRU`` (the autograd
    Function ``rglru`` sends inputs that need a gradient through) on CPU
    tensors against ``jax.vjp`` of the reference oracle
    ``repro.kernels.ref.rglru_ref``, with cotangents on h and on h_last,
    with and without h0, at atol 1e-6: both round every step's product and
    sum once, in the same order (the readings are 0 or an ulp);
  * both bitwise against torch autograd through the port's plain forward
    ``rglru_ref``: the reverse loop takes the roundings autograd takes;
  * the gradients through two calls with the state carried (T 9, then T 7
    from h_last) bitwise those of one call over T 16;
  * ``repro_torch.nn.recurrent.rglru_scan`` (the gates, then the
    recurrence through ``rglru``) against ``jax.vjp`` of
    ``repro.nn.recurrent.rglru_scan`` (the gates, then an associative
    scan), with respect to x, h0 and every parameter, at rtol 1e-4 / atol
    1e-5: the associative scan sums in another order (the forwards differ
    by ~1e-7), and the gates' products carry that into the gradients.

The kernel itself runs only on the card; ``chip_smoke.py`` phase 3f holds
it bitwise against ``rglru_bwd_ref`` there, and phase 6d trains
recurrentgemma-9b through it."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_ref as jref
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

trl = importlib.import_module("repro_torch.kernels.rg_lru")
jrec = importlib.import_module("repro.nn.recurrent")
trec = importlib.import_module("repro_torch.nn.recurrent")

ATOL = 1e-6
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5
SHAPES = [(2, 64, 16), (3, 33, 70), (1, 1, 16)]


def _inputs(shape, seed):
    """a in (0, 1) (as the RG-LRU's gates give it), b and h0 ~ N(0, 1),
    the cotangents dh (B, T, D) and dh_last (B, D) ~ N(0, 1); f32 numpy."""
    rng = np.random.default_rng(seed)
    b, _, d = shape
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = (1.0 / (1.0 + np.exp(-2.0 * f(*shape)))).astype(np.float32)
    return dict(a=a, b=f(*shape), h0=f(b, d), dh=f(*shape), dl=f(b, d))


def _jax_vjp(x, with_h0):
    """(da, db, dh0 or None) of the reference oracle for the cotangents
    (dh, dh_last)."""
    args = [jnp.asarray(x["a"]), jnp.asarray(x["b"])]
    if with_h0:
        args.append(jnp.asarray(x["h0"]))
    _, vjp = jax.vjp(lambda *xs: jref(*xs), *args)
    grads = vjp((jnp.asarray(x["dh"]), jnp.asarray(x["dl"])))
    return [np.asarray(g) for g in grads] + ([] if with_h0 else [None])


def _leaves(x, with_h0):
    a, b = (torch.from_numpy(x[n]).requires_grad_() for n in ("a", "b"))
    h0 = torch.from_numpy(x["h0"]).requires_grad_() if with_h0 else None
    return a, b, h0


def _autograd(fn, x, with_h0, last=True):
    """(da, db, dh0) of ``fn`` (rglru or rglru_ref) by torch autograd; the
    cotangent on h_last only with ``last``."""
    a, b, h0 = _leaves(x, with_h0)
    h, h_last = fn(a, b, h0)
    outs, cots = [h], [torch.from_numpy(x["dh"])]
    if last:
        outs.append(h_last)
        cots.append(torch.from_numpy(x["dl"]))
    live = [t for t in (a, b, h0) if t is not None]
    got = list(torch.autograd.grad(outs, live, cots))
    return got + ([] if with_h0 else [None])


def _bwd_ref(x, with_h0, last=True):
    a, b = torch.from_numpy(x["a"]), torch.from_numpy(x["b"])
    h0 = torch.from_numpy(x["h0"]) if with_h0 else None
    h, _ = trl.rglru_ref(a, b, h0)
    return trl.rglru_bwd_ref(a, h, torch.from_numpy(x["dh"]),
                             torch.from_numpy(x["dl"]) if last else None, h0)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_and_function_match_jax_vjp(shape, with_h0):
    x = _inputs(shape, seed=sum(shape))
    want = _jax_vjp(x, with_h0)
    launches = trl.bwd_launches
    for got in (_bwd_ref(x, with_h0), _autograd(trl.rglru, x, with_h0)):
        assert len(got) == 3
        for name, g, w in zip(("da", "db", "dh0"), got, want):
            if w is None:
                assert g is None, name
                continue
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)
    assert trl.bwd_launches == launches            # CPU tensors: the plain version


@pytest.mark.parametrize("last", [True, False], ids=["h_last-used", "h_last-unused"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reverse_scan_bitwise_torch_autograd(shape, with_h0, last):
    """The plain reverse loop and ``RGLRU`` give the bits torch autograd
    gives through ``rglru_ref`` (an unused h_last: a zero cotangent)."""
    x = _inputs(shape, seed=7 + sum(shape))
    want = _autograd(trl.rglru_ref, x, with_h0, last)
    for got in (_bwd_ref(x, with_h0, last), _autograd(trl.rglru, x, with_h0, last)):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w)


def test_carried_state_gradients_equal_one_call():
    """T 9, then T 7 from the first call's h_last, has the gradients of T
    16 in one call, bitwise (the second call's dh0 is the first's
    dh_last), and against jax.vjp of the reference over T 16."""
    x = _inputs((2, 16, 8), seed=3)
    a, b, h0 = _leaves(x, True)
    dh, dl = torch.from_numpy(x["dh"]), torch.from_numpy(x["dl"])
    whole = torch.autograd.grad(trl.rglru(a, b, h0), (a, b, h0), (dh, dl))
    h1, l1 = trl.rglru(a[:, :9], b[:, :9], h0)
    h2, l2 = trl.rglru(a[:, 9:], b[:, 9:], l1)
    chain = torch.autograd.grad((torch.cat([h1, h2], 1), l2), (a, b, h0), (dh, dl))
    for g, w in zip(chain, whole):
        assert torch.equal(g, w)
    for g, w in zip(whole, _jax_vjp(x, True)):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def _scan_params(width, seed):
    """The reference's RG-LRU parameters with random biases (init leaves
    them 0), as numpy arrays in the reference's tree."""
    p = jrec.rglru_init(jax.random.PRNGKey(seed), jrec.RGLRUConfig(width=width))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, p)
    for k in ("w_a", "w_x"):
        p[k]["b"] = (0.5 * rng.standard_normal(width)).astype(np.float32)
    return p


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("shape", [(2, 24, 16), (1, 40, 32)])
def test_rglru_scan_matches_jax_vjp(shape, with_h0):
    """The Griffin block's recurrence with its gates, the port's sequential
    scan against the reference's associative scan: the gradients of y and
    h_last with respect to x, h0 and the parameters."""
    bsz, t, d = shape
    p = _scan_params(d, seed=t)
    x = _inputs(shape, seed=11 + t)
    xs, h0 = x["b"], x["h0"]

    def jfn(p, xs, h0):
        return jrec.rglru_scan(p, xs, h0 if with_h0 else None)

    _, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(xs),
                     jnp.asarray(h0))
    jp, jx, jh0 = vjp((jnp.asarray(x["dh"]), jnp.asarray(x["dl"])))

    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)).requires_grad_(), p)
    tx = torch.from_numpy(xs).requires_grad_()
    th0 = torch.from_numpy(h0).requires_grad_() if with_h0 else None
    y, h_last = trec.rglru_scan(tp, tx, th0)
    leaves, tdef = jax.tree_util.tree_flatten(tp)
    live = leaves + [tx] + ([th0] if with_h0 else [])
    got = torch.autograd.grad((y, h_last), live,
                              (torch.from_numpy(x["dh"]), torch.from_numpy(x["dl"])))
    want = jax.tree_util.tree_leaves(jp) + [jx] + ([jh0] if with_h0 else [])
    assert len(got) == len(want) == len(leaves) + 1 + with_h0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g.numpy(), w, rtol=SCAN_RTOL, atol=SCAN_ATOL)
