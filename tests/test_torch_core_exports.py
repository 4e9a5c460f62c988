"""The port's ``repro_torch.core`` against the JAX package's ``repro.core``:
the same exported names, and the two functions it gained last,
``gate_param_count`` (the gate's parameter overhead, paper Table 4) and
``clipped_softmax_from_config`` (the softmax a ``ClippedSoftmaxConfig``
selects, gamma resolved from the sequence length), against the reference's
on the same inputs."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_exports_match_reference():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert callable(getattr(tcore, name)), name


@pytest.mark.parametrize("heads,d_head,d_model", [(12, 64, 768), (16, 80, 1280), (4, 8, 32)])
@pytest.mark.parametrize("kind,kw", [("linear", {}), ("mlp", {"n_hid": 4}), ("mlp", {"n_hid": 16}),
                                     ("all_heads_linear", {}), ("none", {})])
def test_gate_param_count_matches_reference(kind, kw, heads, d_head, d_model):
    got = tcore.gate_param_count(tcore.GateConfig(kind, **kw), heads, d_head, d_model)
    want = jcore.gate_param_count(jcore.GateConfig(kind, **kw), heads, d_head, d_model)
    assert got == want and isinstance(got, int)


def test_gate_param_count_table4():
    """BERT-base's gates (paper Table 4, as tests/test_softmax_core.py pins
    them for the reference): linear 12 (64 + 1) = 780, MLP with 4 hidden
    12 (4 66 + 1), all-heads linear 12 769; an unknown kind raises."""
    assert tcore.gate_param_count(tcore.GateConfig("linear"), 12, 64, 768) == 780
    assert tcore.gate_param_count(tcore.GateConfig("mlp", n_hid=4), 12, 64, 768) \
        == 12 * (4 * 66 + 1)
    assert tcore.gate_param_count(tcore.GateConfig("all_heads_linear"), 12, 64, 768) \
        == 12 * 769
    with pytest.raises(ValueError):
        tcore.gate_param_count(tcore.GateConfig("conv"), 12, 64, 768)


@pytest.mark.parametrize("masked", (False, True), ids=("dense", "masked"))
@pytest.mark.parametrize("seq_len", (None, 64))
@pytest.mark.parametrize("cfg", [dict(), dict(gamma=-0.03), dict(alpha=4.0),
                                 dict(gamma=-0.01, zeta=1.02)],
                         ids=("vanilla", "gamma", "alpha", "gamma-zeta"))
def test_clipped_softmax_from_config_matches_reference(cfg, seq_len, masked):
    """Logits of RMS 3 over 24 keys (peaked rows: some probabilities stay
    inside the clip), a causal mask where ``masked``; the port's and the
    reference's results agree to f32 rounding."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 3, 24, 24)) * 3).astype(np.float32)
    where = np.tril(np.ones((24, 24), bool)) if masked else None
    got = tcore.clipped_softmax_from_config(
        torch.from_numpy(logits), tcore.ClippedSoftmaxConfig(**cfg), dim=-1,
        where=None if where is None else torch.from_numpy(where), seq_len=seq_len)
    want = np.asarray(jcore.clipped_softmax_from_config(
        logits, jcore.ClippedSoftmaxConfig(**cfg), axis=-1, where=where, seq_len=seq_len))
    inside = (want > 0) & (want < 1)
    assert inside.any()
    if cfg:
        assert (want == 0).any()                 # the clip bites
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
