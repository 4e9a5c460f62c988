"""The port's fake-quant against the JAX package's, on the CPU, bitwise.

``repro_torch.kernels.fake_quant.fake_quant_ref`` (the CUDA kernel's
plain version, which ``fake_quant`` runs on CPU tensors) in the TPU
kernel's form against the reference's Pallas ``fake_quant_pallas`` in
interpret mode and its oracle ``ref.fake_quant_ref``; in the model-site
(straight-through) form against the reference's
``quant.quantizer.fake_quant``. Sizes 1000 / 4096 / 777 (ragged against
the Pallas block and the kernel's 16-byte vectors), 4 and 8 bits, and
inputs built to land exactly half-way between two codes after
``x / s + z``, where only round-half-to-even gives the reference's code.
The kernel itself runs only on the card; ``chip_smoke.py`` holds it
bitwise against this plain version there."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fake_quant import fake_quant_pallas
from repro.kernels.ref import fake_quant_ref as jref
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jqz = importlib.import_module("repro.quant.quantizer")
tqz = importlib.import_module("repro_torch.quant.quantizer")
tfq = importlib.import_module("repro_torch.kernels.fake_quant")


def _x(n, bits, s, z, ties, seed=0):
    """Normal values spread over the grid (and past it, so codes clip);
    with ``ties`` a third of them sit exactly half-way between codes
    (s is a power of two, so x / s is exact)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    if ties:
        k = rng.integers(-2, 2 ** bits + 2, size=n // 3)
        x[: n // 3] = ((k + 0.5 - z) * s).astype(np.float32)
    return x


CASES = [(n, bits, ties) for n in (1000, 4096, 777) for bits in (4, 8) for ties in (False, True)]


@pytest.mark.parametrize("n,bits,ties", CASES)
def test_pallas_form_bitwise(n, bits, ties):
    s, z = (0.25, 2.0 ** (bits - 1)) if ties else (0.05, 2.0 ** (bits - 1))
    x = _x(n, bits, s, z, ties)
    got = tfq.fake_quant_ref(torch.from_numpy(x), s, z, bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(fake_quant_pallas(jnp.asarray(x), s, z, bits)))
    np.testing.assert_array_equal(got, np.asarray(jref(jnp.asarray(x), s, z, bits)))
    np.testing.assert_array_equal(tfq.fake_quant(torch.from_numpy(x), s, z, bits).numpy(), got)
    if ties:   # half to even actually decided some codes
        q = x[: n // 3] / s + z
        assert np.all(q == np.floor(q) + 0.5)


@pytest.mark.parametrize("n,bits,ties", CASES)
def test_site_form_bitwise(n, bits, ties):
    """The straight-through form of every 'apply'-mode site, asymmetric
    (activation) and symmetric (weight) specs."""
    for symmetric in (False, True):
        s, z = (0.125, 3.0) if ties else (0.0371, 5.0)
        if symmetric:
            z = 2.0 ** (bits - 1)
        x = _x(n, bits, s, z, ties, seed=1)
        jspec = jqz.QuantSpec(bits=bits, symmetric=symmetric)
        tspec = tqz.QuantSpec(bits=bits, symmetric=symmetric)
        want = np.asarray(jqz.fake_quant(jnp.asarray(x), jnp.float32(s), jnp.float32(z), jspec))
        got = tqz.fake_quant(torch.from_numpy(x), s, z, tspec).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tfq.fake_quant(torch.from_numpy(x), s, z, bits, ste=True).numpy(), got)


def test_site_form_bf16_and_per_channel():
    """bf16 tensors round once, at the end; per-channel (s, z) along the
    last axis, as ``QConfig(per_channel_weights=True)`` gives them."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 48)) * 2).astype(np.float32)
    s = (np.abs(rng.standard_normal(48)) * 0.02 + 0.01).astype(np.float32)
    z = np.full(48, 128.0, np.float32)
    spec_j = jqz.QuantSpec(bits=8, symmetric=True, per_channel_axis=1)
    spec_t = tqz.QuantSpec(bits=8, symmetric=True, per_channel_axis=1)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(tdt)
        want = jqz.fake_quant(jnp.asarray(x).astype(jdt), jnp.asarray(s), jnp.asarray(z), spec_j)
        got = tqz.fake_quant(xt, torch.from_numpy(s), torch.from_numpy(z), spec_t)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_straight_through_gradient_on_cpu():
    """On CPU tensors the site form keeps the reference's STE gradient:
    one inside the range, zero where x was clipped."""
    x = torch.tensor([-100.0, -0.3, 0.0, 0.7, 100.0], requires_grad=True)
    spec = tqz.QuantSpec(bits=8, symmetric=False)
    tqz.fake_quant(x, 0.01, 100.0, spec).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])


@pytest.mark.parametrize("ste", [False, True], ids=["pallas-form", "site-form"])
def test_nan_and_inf_carried_like_the_reference(ste):
    """NaN stays NaN in both forms (the code clamp carries it, as
    ``jnp.clip`` and ``torch.clamp`` do), and an infinity clips to the
    end of the grid."""
    bits, s, z = 8, 0.05, 128.0
    x = _x(64, bits, s, z, ties=False, seed=3)
    x[[0, 9, 17]] = [np.nan, np.inf, -np.inf]
    got = tfq.fake_quant_ref(torch.from_numpy(x), s, z, bits, ste=ste).numpy()
    if ste:
        spec = jqz.QuantSpec(bits=bits, symmetric=False)
        want = np.asarray(jqz.fake_quant(jnp.asarray(x), jnp.float32(s), jnp.float32(z), spec))
    else:
        want = np.asarray(fake_quant_pallas(jnp.asarray(x), s, z, bits))
        np.testing.assert_array_equal(got, np.asarray(jref(jnp.asarray(x), s, z, bits)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]) and np.isfinite(got[1:]).all()
    assert got[9] == np.float32(s) * (2 ** bits - 1 - z) and got[17] == np.float32(s) * -z
