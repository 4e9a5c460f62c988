"""The port's RG-LRU recurrence against the JAX package's, on the CPU.

``repro_torch.kernels.rg_lru.rglru_ref`` (the CUDA kernel's plain
version) and the wrapper ``rglru`` on CPU tensors (which runs that plain
version) against the reference's oracle ``kernels/ref.py : rglru_ref``
and its Pallas kernel ``rglru_pallas`` in interpret mode, as
``tests/test_kernels.py`` runs it: shapes (2, 64, 64), (3, 33, 70) and
(1, 1, 16), with and without ``h0``, and a state carried across two
calls. atol 1e-6: the plain versions round every step as the Pallas
body does (one product, one sum). The kernel runs only on the card;
``chip_smoke.py`` holds it bitwise against this plain version there."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_ref as jref
from repro.kernels.rg_lru import rglru_pallas

trl = importlib.import_module("repro_torch.kernels.rg_lru")
ATOL = 1e-6


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, _, d = shape
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    bb = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 33, 70), (1, 1, 16)])
def test_plain_version_and_wrapper_match_reference(shape, with_h0):
    a, b, h0 = _inputs(shape, seed=sum(shape))
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    want_h, want_last = jref(jnp.asarray(a), jnp.asarray(b), jh0)
    pal_h, pal_last = rglru_pallas(jnp.asarray(a), jnp.asarray(b), jh0, interpret=True)
    launches = trl.launches
    for fn in (trl.rglru_ref, trl.rglru):
        h, last = fn(torch.from_numpy(a), torch.from_numpy(b), th0)
        assert h.dtype == last.dtype == torch.float32
        assert h.shape == shape and last.shape == (shape[0], shape[2])
        for ref_h, ref_last in ((want_h, want_last), (pal_h, pal_last)):
            np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL, rtol=0)
            np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), atol=ATOL, rtol=0)
    assert trl.launches == launches            # CPU tensors: the plain version


def test_state_carry_matches_one_call():
    """T = 9 then T = 7 with h_last carried equals T = 16 in one call, in
    the port bitwise and against the reference's Pallas chunks."""
    a, b, _ = _inputs((2, 16, 8), seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    h_full, last_full = trl.rglru(ta, tb)
    h1, l1 = trl.rglru(ta[:, :9], tb[:, :9])
    h2, l2 = trl.rglru(ta[:, 9:], tb[:, 9:], l1)
    assert torch.equal(torch.cat([h1, h2], dim=1), h_full) and torch.equal(l2, last_full)
    j1, jl1 = rglru_pallas(jnp.asarray(a[:, :9]), jnp.asarray(b[:, :9]), interpret=True)
    j2, _ = rglru_pallas(jnp.asarray(a[:, 9:]), jnp.asarray(b[:, 9:]), h0=jl1,
                         interpret=True)
    np.testing.assert_allclose(h_full.numpy(), np.concatenate([j1, j2], axis=1),
                               atol=ATOL, rtol=0)


def test_wrapper_refuses_inputs_that_need_a_gradient():
    """No backward kernel yet: CPU tensors and CUDA tensors alike (the
    latter checked with a stand-in whose ``is_cuda`` is true, since this
    machine has no card) are refused before anything runs."""
    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    a, b, _ = _inputs((1, 4, 8), seed=0)
    for wrap in (lambda x: x, lambda x: x.as_subclass(Cuda)):
        ta = wrap(torch.from_numpy(a).requires_grad_())
        with pytest.raises(RuntimeError, match="no backward"):
            trl.rglru(ta, torch.from_numpy(b))
    with torch.no_grad():
        h, _ = trl.rglru(torch.from_numpy(a).requires_grad_(), torch.from_numpy(b))
    assert h.shape == (1, 4, 8)
