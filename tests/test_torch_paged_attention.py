"""The port's paged attention read against the JAX package's
``paged_attention(..., backend="gather")``, at f32 on the CPU.

Two port paths are held against it: the ``paged_attention`` dispatcher
(CPU tensors -> ``paged_attention_gather``) and the CUDA kernel's plain
version ``paged_flash_attention_ref`` (through the ``paged_mha``
adapter, which on CPU tensors computes it). The sweep covers ragged
per-row offsets, ``-1`` entries, partial tail blocks, ``live_width`` /
``live_widths``, softcap, window, vanilla, clipped (static and
alpha-resolved gamma), gated, int8 pools, Tq in {1, 5} and G in
{1, 4, 5}. Tolerance: atol 2e-5, the reference kernel's own f32
tolerance (``repro/kernels/paged_attention.py``). The kernel itself runs
only on the GPU, where ``chip_smoke.py`` holds it against the plain
version."""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jatt = importlib.import_module("repro.core.attention")
jsm = importlib.import_module("repro.core.softmax")
tatt = importlib.import_module("repro_torch.core.attention")
tsm = importlib.import_module("repro_torch.core.softmax")
tpa = importlib.import_module("repro_torch.kernels.paged_attention")

ATOL = 2e-5

# one XLA compile per case instead of one per primitive and shape
_jax_paged = jax.jit(jatt.paged_attention,
                     static_argnames=("cfg", "live_width", "backend"))


def _case(b=3, w=4, bs=8, hkv=2, g=2, dh=16, tq=1, seed=0, int8=False):
    """Random pools + scrambled prefix-dense tables (-1 tails) + ragged
    positions: row i owns exactly the blocks covering [0, pos + tq), so
    its last block is partially filled when pos + tq is not a multiple
    of bs."""
    rng = np.random.default_rng(seed)
    nb = b * w + 2
    hq = hkv * g
    q = rng.standard_normal((b, tq, hq, dh)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, (nb, bs, hkv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, hkv, dh)).astype(np.int8)
        ks = (rng.random((nb, bs)) / 127).astype(np.float32)
        vs = (rng.random((nb, bs)) / 127).astype(np.float32)
    else:
        kp = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
        vp = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
        ks = vs = None
    pos = rng.integers(0, w * bs - tq + 1, size=b).astype(np.int32)
    table = np.full((b, w), -1, np.int32)
    perm = rng.permutation(nb)
    nxt = 0
    for i in range(b):
        need = -(-(int(pos[i]) + tq) // bs)
        table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    gate = (1 / (1 + np.exp(-rng.standard_normal((b, tq, hq))))).astype(np.float32)
    return dict(q=q, k_pool=kp, v_pool=vp, block_table=table, q_offset=pos,
                gate=gate, k_scale=ks, v_scale=vs)


def _cfgs(hq, hkv, dh, sm=None, window=None, softcap=None):
    sm = sm or {}
    kw = dict(n_heads=hq, n_kv_heads=hkv, d_head=dh, window=window,
              logit_softcap=softcap)
    return (jatt.AttentionConfig(**kw, softmax=jsm.ClippedSoftmaxConfig(**sm)),
            tatt.AttentionConfig(**kw, softmax=tsm.ClippedSoftmaxConfig(**sm)))


def _check(c, sm=None, window=None, softcap=None, gated=False,
           live_width=None, live_widths=None):
    """JAX gather vs (port dispatcher, port plain kernel version)."""
    b, tq, hq, dh = c["q"].shape
    hkv = c["k_pool"].shape[2]
    jc, tc = _cfgs(hq, hkv, dh, sm, window, softcap)
    gate = c["gate"] if gated else None

    def opt(x, f):
        return None if x is None else f(x)

    ref = _jax_paged(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        jnp.asarray(c["block_table"]), cfg=jc, q_offset=jnp.asarray(c["q_offset"]),
        gate_pi=opt(gate, jnp.asarray), backend="gather", live_width=live_width,
        live_widths=opt(live_widths, jnp.asarray),
        k_scale=opt(c["k_scale"], jnp.asarray), v_scale=opt(c["v_scale"], jnp.asarray))
    ref = np.asarray(ref, np.float32)
    t = {k: opt(v, torch.from_numpy) for k, v in c.items()}
    lws = opt(live_widths, torch.from_numpy)
    out = tatt.paged_attention(
        t["q"], t["k_pool"], t["v_pool"], t["block_table"], tc,
        q_offset=t["q_offset"], gate_pi=t["gate"] if gated else None,
        live_width=live_width, live_widths=lws,
        k_scale=t["k_scale"], v_scale=t["v_scale"])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the kernel's plain version, in the kernel's own layout
    bt = t["block_table"]
    if live_width is not None:
        bt = bt[:, :max(1, min(live_width, bt.shape[1]))]
    sm_t = tsm.ClippedSoftmaxConfig(**(sm or {}))
    gamma = sm_t.resolve_gamma(c["block_table"].shape[1] * c["k_pool"].shape[1])
    gamma, zeta = (0.0, 1.0) if sm_t.is_vanilla else (gamma, sm_t.zeta)
    before = tpa.launches
    plain = tpa.paged_mha(
        t["q"], t["k_pool"], t["v_pool"], bt, t["q_offset"],
        t["gate"] if gated else None, window=window, softcap=softcap,
        gamma=gamma, zeta=zeta, k_scale=t["k_scale"], v_scale=t["v_scale"],
        live_widths=lws)
    assert tpa.launches == before          # CPU tensors never launch
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=0)


SOFTMAXES = [dict(), dict(gamma=-0.03), dict(gamma=-0.01, zeta=1.03),
             dict(alpha=4.0)]


@pytest.mark.parametrize("sm", SOFTMAXES, ids=str)
def test_softmax_variants_ragged_positions(sm):
    _check(_case(seed=1), sm=sm)


@pytest.mark.parametrize("g", [1, 4, 5])
@pytest.mark.parametrize("tq", [1, 5])
def test_gqa_groups_and_query_blocks(g, tq):
    _check(_case(g=g, tq=tq, seed=10 * g + tq), sm=dict(alpha=4.0), gated=True)
    _check(_case(g=g, tq=tq, seed=10 * g + tq + 1))


def test_gated_vanilla_and_clipped():
    c = _case(seed=3, tq=2)
    _check(c, gated=True)
    _check(c, sm=dict(gamma=-0.05), gated=True)


@pytest.mark.parametrize("window", [3, 11])
def test_local_window(window):
    _check(_case(seed=4, tq=3), window=window)
    _check(_case(seed=5, tq=1), sm=dict(alpha=4.0), window=window)


def test_softcap():
    _check(_case(seed=6, tq=2), softcap=5.0)
    _check(_case(seed=7), sm=dict(gamma=-0.02), softcap=2.0)


@pytest.mark.parametrize("sm", [dict(), dict(alpha=4.0)], ids=str)
def test_live_width_slicing(sm):
    """Slicing the table to the live prefix is exact, and alpha resolves
    gamma from the LOGICAL width, not the sliced one."""
    c = _case(b=2, w=8, bs=4, seed=8)
    c["q_offset"] = np.array([3, 9], np.int32)
    c["block_table"][:, :] = -1
    c["block_table"][0, :1] = [5]
    c["block_table"][1, :3] = [1, 7, 2]
    for lw in (3, 4, 8):
        _check(c, sm=sm, live_width=lw)


def test_per_row_live_widths():
    c = _case(b=3, w=6, bs=4, seed=9, tq=2)
    lws = (c["block_table"] >= 0).sum(axis=1).astype(np.int32)
    _check(c, sm=dict(alpha=4.0), live_width=6, live_widths=lws)
    # a count below the allocation hides the entries past it, exactly
    _check(c, live_widths=np.maximum(lws - 1, 0).astype(np.int32))


@pytest.mark.parametrize("sm", [dict(), dict(alpha=4.0)], ids=str)
def test_int8_pools(sm):
    c = _case(seed=11, int8=True, tq=5, g=5, hkv=1)
    _check(c, sm=sm, gated=True)
    _check(_case(seed=12, int8=True), sm=sm, live_width=2)


def test_unallocated_row_outputs_zero():
    c = _case(b=2, seed=13)
    c["block_table"][1, :] = -1
    for sm in (dict(), dict(gamma=-0.03)):
        _, tc = _cfgs(4, 2, 16, sm)
        out = tatt.paged_attention(
            torch.from_numpy(c["q"]), torch.from_numpy(c["k_pool"]),
            torch.from_numpy(c["v_pool"]), torch.from_numpy(c["block_table"]), tc,
            q_offset=torch.from_numpy(c["q_offset"]))
        assert torch.equal(out[1], torch.zeros_like(out[1]))
        plain = tpa.paged_mha(
            torch.from_numpy(c["q"]), torch.from_numpy(c["k_pool"]),
            torch.from_numpy(c["v_pool"]), torch.from_numpy(c["block_table"]),
            torch.from_numpy(c["q_offset"]), gamma=sm.get("gamma", 0.0))
        assert torch.equal(plain[1], torch.zeros_like(plain[1]))


def test_scalar_offset():
    c = _case(seed=14, tq=3)
    c["q_offset"] = np.array(7, np.int32)
    c["block_table"][:, 2:] = -1
    _check(c, sm=dict(alpha=2.0))


def test_plain_version_matches_pallas_kernel_interpret():
    """One small case against the Pallas kernel itself, in interpret mode."""
    from repro.kernels.paged_attention import paged_mha as jpaged_mha
    c = _case(b=2, w=2, bs=8, hkv=1, g=4, dh=8, tq=2, seed=15)
    gamma = -4.0 / 16
    ref = jpaged_mha(jnp.asarray(c["q"]), jnp.asarray(c["k_pool"]),
                     jnp.asarray(c["v_pool"]), jnp.asarray(c["block_table"]),
                     jnp.asarray(c["q_offset"]), jnp.asarray(c["gate"]),
                     gamma=gamma, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in c.items() if v is not None}
    out = tpa.paged_mha(t["q"], t["k_pool"], t["v_pool"], t["block_table"],
                        t["q_offset"], t["gate"], gamma=gamma)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_kernel_backend_on_cpu_tensors_raises():
    c = _case(seed=16)
    _, tc = _cfgs(4, 2, 16)
    t = {k: torch.from_numpy(v) for k, v in c.items() if v is not None}
    with pytest.raises(ValueError, match="CUDA"):
        tatt.paged_attention(t["q"], t["k_pool"], t["v_pool"], t["block_table"],
                             tc, q_offset=t["q_offset"], backend="kernel")
    with pytest.raises(ValueError, match="unknown"):
        tatt.paged_attention(t["q"], t["k_pool"], t["v_pool"], t["block_table"],
                             tc, q_offset=t["q_offset"], backend="xla")


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel module builds nothing and needs no nvcc: the
    build runs at the first launch on a GPU."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME",)}
    env["PATH"] = ""
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    code = ("import repro_torch.kernels.paged_attention as pa, "
            "repro_torch.kernels.build as b; "
            "assert pa.launches == 0 and not b._LOADED; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
