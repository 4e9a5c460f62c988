"""The port's RG-LRU recurrence against the JAX package's, on the CPU.

``repro_torch.kernels.rg_lru.rglru_ref`` (the CUDA kernel's plain
version) and the wrapper ``rglru`` on CPU tensors (which runs that plain
version) against the reference's oracle ``kernels/ref.py : rglru_ref``
and its Pallas kernel ``rglru_pallas`` in interpret mode, as
``tests/test_kernels.py`` runs it: shapes (2, 64, 64), (3, 33, 70) and
(1, 1, 16), and at D 16 the shapes the card's checks add (the
evaluation's T 2048, the smallest serving chunk (8, 32), a T 1000 that
no ring tile divides), with and without ``h0``, and a state carried
across two calls. atol 1e-6: the plain versions round every step as the
Pallas body does (one product, one sum). The kernel runs only on the
card; ``chip_smoke.py`` holds it bitwise against this plain version
there. ``plan``, the kernel's static launch plan, is pure Python and is
tested here: its routes, one wave of a 132-SM card, the launch limits,
and its ring constants against the CUDA source's."""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_ref as jref
from repro.kernels.rg_lru import rglru_pallas
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

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
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 33, 70), (1, 1, 16), (1, 2048, 16),
                                   (8, 32, 16), (1, 1000, 16)])
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


def test_wrapper_refuses_inputs_that_need_a_gradient(monkeypatch):
    """What the wrapper does with inputs that need a gradient (it refuses
    none of them): CPU tensors go through ``RGLRU``'s plain versions
    (whose gradients ``test_torch_rg_lru_backward.py`` holds) and launch
    nothing; CUDA tensors (a stand-in whose ``is_cuda`` is true, with the
    library, the SM count, the device guard and the stream stood in, since
    this machine has no card) launch the scan kernel in the forward and the
    reverse-scan kernel in the backward, once each, and run nothing
    plainly; under ``torch.no_grad()`` no graph is recorded."""
    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    a, b, h0 = _inputs((1, 4, 8), seed=0)
    ta, tb, th0 = (torch.from_numpy(x).requires_grad_() for x in (a, b, h0))
    launches, bwd = trl.launches, trl.bwd_launches
    h, last = trl.rglru(ta, tb, th0)
    assert h.grad_fn is not None and last.grad_fn is not None
    grads = torch.autograd.grad((h.sum() + last.sum()), (ta, tb, th0))
    assert all(g is not None and g.shape == x.shape for g, x in zip(grads, (ta, tb, th0)))
    assert (trl.launches, trl.bwd_launches) == (launches, bwd)
    with torch.no_grad():
        h, _ = trl.rglru(ta, tb)
    assert h.shape == (1, 4, 8) and h.grad_fn is None

    calls = []

    class Lib:
        def rglru_launch(self, *args):
            calls.append(("forward", args))
            return 0

        def rglru_bwd_launch(self, *args):
            calls.append(("reverse", args))
            return 0

    class Stream:
        cuda_stream = 0

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trl, "_kernel_lib", lambda: Lib())
    monkeypatch.setattr(trl, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(trl, "rglru_ref", None)           # no plain forward on the card
    monkeypatch.setattr(trl, "rglru_bwd_ref", None)       # nor a plain reverse scan
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    ca, cb = (torch.from_numpy(x).as_subclass(Cuda).requires_grad_() for x in (a, b))
    h, last = trl.rglru(ca, cb)
    torch.autograd.grad((h.sum() + last.sum()), (ca, cb))
    assert [kind for kind, _ in calls] == ["forward", "reverse"]
    assert calls[0][1][5:8] == (1, 4, 8) and calls[1][1][8:11] == (1, 4, 8)  # B, T, D
    assert calls[1][1][4] is None and calls[1][1][7] is None        # no h0, no dh0
    assert (trl.launches, trl.bwd_launches) == (launches + 1, bwd + 1)


SMS = 132                       # an H100 SXM's SMs


@pytest.mark.parametrize("d,aligned,route", [
    (4096, True, 1), (4100, True, 1), (16, True, 1), (4096, False, 0), (777, True, 0),
    (70, True, 0), (18, False, 0)])
def test_plan_takes_the_tma_route_only_for_d_a_multiple_of_4_and_aligned(d, aligned, route):
    """Route 1's tensor maps need a row stride of a multiple of 16 bytes
    and 16-byte aligned bases; everything else takes route 0, and T or B
    never change the route."""
    for b, t in ((1, 2048), (8, 32), (3, 33), (65535, 1)):
        assert trl.plan(b, t, d, SMS, aligned=aligned).route == route


@pytest.mark.parametrize("b,t,d", [
    (1, 4096, 4096), (1, 2048, 4096), (8, 256, 4096), (8, 32, 4096), (1, 1000, 4096),
    (8, 1, 4096), (2, 300, 4100), (16, 1, 4096), (1, 10, 16), (3, 33, 777),
    (65535, 1, 4096), (65535, 3, 777), (65535, 2, 1 << 16)])
def test_plan_covers_a_wave_within_the_launch_limits(b, t, d):
    """Every channel of every row has a CTA; the grid, the CTA's threads
    and its shared memory stay within a launch's limits (B up to 65535,
    grid.x < 2^31); route 1's boxes within TMA's 256 elements a side and
    its ring within a CTA's shared memory; its grid covers one wave of
    the card whenever one-warp strips can, with the widest such strip."""
    p = trl.plan(b, t, d, SMS)
    assert p.ctas == b * -(-d // p.channels)
    assert 1 <= p.ctas <= 2 ** 31 - 1
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.smem <= 232448
    if p.route == 0:
        assert (p.channels, p.threads, p.smem) == (128, 128, 0)
        return
    assert p.warps in (1, 2, 4, 8) and p.channels == 32 * p.warps <= 256
    assert p.tile_t * p.warps == 64 and p.threads == p.channels + 32
    assert p.smem == trl.TMA_SMEM_BYTES
    if b * -(-d // 32) >= SMS:
        assert p.ctas >= SMS
        if p.warps < 8:                 # twice the warps would not cover a wave
            assert b * -(-d // (64 * p.warps)) < SMS
    else:
        assert p.warps == 1


def test_ring_constants_match_the_kernel():
    """The wrapper's ring depth and shared-memory size are the CUDA
    source's: three 16 KB slots, 16 KB of h tiles, six barriers and the
    alignment slack, within a CTA's 227 KB."""
    src = (Path(trl.__file__).parent.parent / "csrc" / "rg_lru.cu").read_text()
    assert re.search(r"constexpr int STAGES = (\d+);", src).group(1) == str(trl.TMA_STAGES)
    assert trl.TMA_STAGES == 3
    assert trl.TMA_SMEM_BYTES == 3 * 16384 + 16384 + 6 * 8 + 128 <= 227 * 1024


def test_plan_of_the_card_shapes():
    """The plans the card's checks print: a long row in one-warp strips
    (128 CTAs), a serving sub-step in four-warp strips (256 CTAs, two an
    SM), a ragged D on route 0."""
    assert trl.plan(1, 4096, 4096, SMS)[:5] == (1, 1, 32, 64, 128)
    assert trl.plan(8, 256, 4096, SMS)[:5] == (1, 4, 128, 16, 256)
    assert trl.plan(3, 33, 777, SMS)[:5] == (0, 4, 128, 16, 21)
