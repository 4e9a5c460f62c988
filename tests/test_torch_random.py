"""The port's threefry (``repro_torch.random``) against ``jax.random``, and
the samplers and calibration tokens built on it, on the CPU.

Keys, ``fold_in``, ``split``, random bits, uniforms and ``randint`` are
bitwise. Gumbel noise ``-log(-log(u))`` is held at rtol 1e-6 with an
atol of 2.4e-7 (two ulps of 1.0): torch's and XLA's f32 ``log`` differ by
an ulp on some inputs, and where the outer log's argument is near 1 the
inner log's ulp is all of the noise's value, so a pure relative bound
cannot hold there. Sampled tokens (``sample_rows``, ``sample_rows_all``
and a whole sampled batcher run) must equal the reference's on the
tested cases."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.qwen3_14b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.qwen3_14b import smoke as tsmoke
from repro_torch.convert import from_jax_params

trand = importlib.import_module("repro_torch.random")
jdec = importlib.import_module("repro.serving.decode")
tdec = importlib.import_module("repro_torch.serving.decode")
tsched = importlib.import_module("repro_torch.serving.scheduler")
jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")

TINY = float(np.finfo(np.float32).tiny)


def _u64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -12345])
def test_prng_key_bitwise(seed):
    np.testing.assert_array_equal(trand.PRNGKey(seed).numpy(),
                                  _u64(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed,data", [(0, 0), (7, 123), (3, 2 ** 31 - 1), (99, 4096)])
def test_fold_in_and_split_bitwise(seed, data):
    jk, tk = jax.random.PRNGKey(seed), trand.PRNGKey(seed)
    np.testing.assert_array_equal(trand.fold_in(tk, data).numpy(),
                                  _u64(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(trand.split(tk, 5).numpy(), _u64(jax.random.split(jk, 5)))
    # a batch of keys folds each row with its own datum
    seeds = [seed, seed + 1, seed + 2]
    datas = [data, data + 1, 7]
    want = np.stack([_u64(jax.random.fold_in(jax.random.PRNGKey(s), d))
                     for s, d in zip(seeds, datas)])
    np.testing.assert_array_equal(
        trand.fold_in(trand.PRNGKey(torch.tensor(seeds)), torch.tensor(datas)).numpy(), want)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (1, 1000), (2, 3, 4)])
def test_random_bits_and_uniform_bitwise(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 11)
    tk = trand.fold_in(trand.PRNGKey(5), 11)
    np.testing.assert_array_equal(trand.random_bits(tk, shape).numpy(),
                                  _u64(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(trand.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        trand.uniform(tk, shape, TINY, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=TINY, maxval=1.0)))


@pytest.mark.parametrize("lo,hi", [(0, 151936), (0, 128), (3, 70000), (-7, 9), (5, 5),
                                   (0, 1), (0, 2 ** 16)])
def test_randint_bitwise(lo, hi):
    for i in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(0), i)
        tk = trand.fold_in(trand.PRNGKey(0), i)
        got = trand.randint(tk, (2, 33), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.random.randint(jk, (2, 33), lo, hi)))


def test_gumbel_noise_within_an_ulp_of_reference():
    jk = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.gumbel(jk, (1, 200_000)))
    got = trand.gumbel(trand.PRNGKey(7), (1, 200_000)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.4e-7)
    assert np.isfinite(got).all()


def test_calibration_tokens_equal_reference():
    """The W8A8 engine's calibration batches are the reference engine's
    ``randint(fold_in(PRNGKey(0), i), (2, t), 0, vocab)``, bitwise."""
    for t, vocab in ((32, 128), (17, 151936)):
        cfg = dataclasses.replace(tsmoke(), vocab_size=vocab)
        got = tsched._calibration_batches(cfg, t, 4, "cpu")
        key = jax.random.PRNGKey(0)
        for i, batch in enumerate(got):
            want = np.asarray(jax.random.randint(jax.random.fold_in(key, i), (2, t), 0, vocab))
            np.testing.assert_array_equal(batch["tokens"].numpy(), want)


GENS = [dict(temperature=1.0), dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_k=1),
        dict(temperature=0.0)]


@pytest.mark.parametrize("gen", GENS, ids=["t1", "t0.7-top5", "t1.3-top1", "greedy"])
def test_sample_rows_equal_reference(gen):
    rng = np.random.default_rng(3)
    b, v = 16, 1000
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, size=b)
    pos = rng.integers(0, 4096, size=b).astype(np.int32)
    jkeys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    want = np.asarray(jdec.sample_rows(jnp.asarray(logits), jdec.GenerateConfig(**gen),
                                       jkeys, jnp.asarray(pos)))
    got = tdec.sample_rows(torch.from_numpy(logits), tdec.GenerateConfig(**gen),
                           torch.from_numpy(seeds), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gen", GENS[:2], ids=["t1", "t0.7-top5"])
def test_sample_rows_all_equal_reference(gen):
    rng = np.random.default_rng(4)
    b, t, v = 3, 5, 300
    logits = (rng.standard_normal((b, t, v)) * 2).astype(np.float32)
    seeds = np.array([1, 2, 3])
    pos = np.array([0, 17, 250], np.int32)
    jkeys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    want = np.asarray(jdec.sample_rows_all(jnp.asarray(logits), jdec.GenerateConfig(**gen),
                                           jkeys, jnp.asarray(pos)))
    got = tdec.sample_rows_all(torch.from_numpy(logits), tdec.GenerateConfig(**gen),
                               torch.from_numpy(seeds), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_batcher_tokens_equal_reference():
    """A whole sampled run (temperature 0.8, top-k 20; per-request seeds,
    chunked prefill): the port's engine draws the reference engine's
    tokens."""
    jc, tc = japply(jsmoke(), "vanilla"), tapply(tsmoke(), "vanilla")
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 120, size=n).astype(np.int32) for n in (5, 19, 9)]
    engine = dict(batch_size=2, max_len=64, paged=True, block_size=16, token_budget=8)

    def run(serve, params, cfg, **kw):
        b = serve.ContinuousBatcher(params, cfg, gen=serve.GenerateConfig(
            temperature=0.8, top_k=20), **engine, **kw)
        for u, p in enumerate(prompts):
            b.submit(serve.Request(uid=u, prompt=p, max_new_tokens=8, seed=100 + u))
        b.run()
        return {r.uid: list(map(int, r.output)) for r in b.done}

    want = run(jserve, jp, jc)
    got = run(tserve, tp, tc, device="cpu")
    assert got == want
    assert len({tuple(v) for v in got.values()}) == len(got)
