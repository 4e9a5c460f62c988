"""The arithmetic of the Hopper attention kernels, emulated step by step in
PyTorch on the CPU and held against the plain versions the kernels are
checked against on the card (``mha_flash_ref``, ``paged_flash_attention_ref``).

  (a) P carried through bf16 tensor-core operands as hi = bf16(P) and
      lo = bf16(P - hi): hi + lo reconstructs P within 2^-16 |P|, and a
      forward whose P.V runs on the split stays within relative RMS 1e-4
      of ``mha_flash_ref`` (P in f32) for vanilla, clipped and gated
      attention; rounding P itself to bf16 lands far outside that.
  (b) The split-KV decode read: each chunk of a row's live span yields a
      partial (m, Z, acc) and the last split merges them (M = max m_s,
      w_s = e^(m_s - M), Z = sum z_s w_s); the clipped softmax merges
      (m, Z) first and sums its clip(.) V partials. Equal to
      ``paged_flash_attention_ref`` within 1e-6 (f32) over 1, 3 and 8
      splits, with fully masked splits and a row with nothing live.
  (c) int8 pools on the tensor-core route: the products run on the codes,
      the per-token K scale multiplies the score after the product and the
      V scale multiplies P; equal to dequantizing first within 1e-5.

Nothing here is part of the package: the emulations live in this file.
They document the arithmetic the kernels are designed to, and never run
a kernel: ``split_spans`` and ``merge_parts`` restate the CUDA code's
chunk formula and merge, so a kernel that drifted from them would still
pass here. What holds the kernels themselves is ``chip_smoke.py`` on the
card: its split-KV decode reads at the f32 tolerance for the merge, and
its relative-RMS checks of the tensor-core routes (P per layer in the
flash kernel, the paged prefill read) for the hi/lo split of P."""
import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("repro_torch.kernels.flash_attention")
tpa = importlib.import_module("repro_torch.kernels.paged_attention")

NEG_INF = -1e30
B, T, HQ, HKV, DH = 2, 256, 8, 2, 128


def _rel_rms(a, b):
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def split_hi_lo(p):
    """The kernels' split of an f32 probability into two bf16 operands."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi, lo


def flash_inputs(seed):
    """``chip_smoke.flash_case`` at a small size: q scaled by 2 so that
    attention is peaked, bf16 q/k/v, a sigmoid gate."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, T, HQ, DH), dtype=np.float32) * 2)
    k = torch.from_numpy(rng.standard_normal((B, T, HKV, DH), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, HKV, DH), dtype=np.float32))
    gate = torch.from_numpy(1 / (1 + np.exp(-rng.standard_normal((B, T, HQ)))).astype(np.float32))
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), gate


def flash_emulated(q, k, v, gate_pi, gamma, zeta, p_round):
    """The tensor-core flash route's function: q * Dh^-0.5 rounded to bf16,
    f32 scores, causal mask, softmax statistics in f32, then the P.V
    product with P handed over by ``p_round`` (a list of bf16 operands
    whose products are summed), Z division or clip, gate, bf16 out."""
    g = HQ // HKV
    qs = (q * DH ** -0.5).float().transpose(1, 2)                   # (B, H, T, D)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    s = qs @ kf.transpose(-1, -2)
    pos = torch.arange(T)
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    z = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    clipped = not (gamma == 0.0 and zeta == 1.0)
    if clipped:
        p = torch.where(mask, torch.clamp((zeta - gamma) * (p / z) + gamma, 0.0, 1.0), 0.0)
    out = sum(part.float() @ vf for part in p_round(p))
    if not clipped:
        out = out / z
    out = out.transpose(1, 2)
    if gate_pi is not None:
        out = out * gate_pi[..., None]
    return out.to(q.dtype)


def test_hi_lo_reconstructs_p():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp(rng.uniform(-30, 0, 1 << 16)).astype(np.float32))
    hi, lo = split_hi_lo(p)
    err = (hi.double() + lo.double() - p.double()).abs()
    assert bool((err <= 2.0 ** -16 * p.double()).all()), float((err / p.double()).max())
    # the split is much finer than rounding P to bf16
    assert float((err / p.double()).max()) <= 2.0 ** -17
    assert float(((hi.double() - p.double()).abs() / p.double()).max()) > 2.0 ** -10


@pytest.mark.parametrize("variant", ["vanilla", "clipped", "gated"])
def test_flash_forward_with_split_p_matches_plain(variant):
    q, k, v, gate = flash_inputs(seed={"vanilla": 1, "clipped": 2, "gated": 3}[variant])
    gamma = -4.0 / T if variant == "clipped" else 0.0
    gate = gate if variant == "gated" else None
    ref = tfa.mha_flash_ref(q, k, v, gate, gamma=gamma)
    split = flash_emulated(q, k, v, gate, gamma, 1.0, lambda p: split_hi_lo(p))
    bf16_p = flash_emulated(q, k, v, gate, gamma, 1.0, lambda p: [p.to(torch.bfloat16)])
    rel, rel_bf16 = _rel_rms(split.float(), ref.float()), _rel_rms(bf16_p.float(), ref.float())
    msg = (f"{variant}: hi/lo-split P relative RMS {rel:.3e}; "
           f"P rounded to bf16 {rel_bf16:.3e}")
    assert split.dtype == torch.bfloat16
    assert rel <= 1e-4, msg
    # what the split buys: bf16 P lands an order of magnitude further out
    assert rel_bf16 > 10 * max(rel, 1e-5), msg


# -- (b) the split-KV read ------------------------------------------------
def paged_case(seed, b=4, hkv=2, g=5, dh=16, bs=16, w=8, lengths=(1, 17, 100, 128),
               dead=(), int8=False):
    """A decode read (Tq 1) over scrambled tables; row i's live length is
    lengths[i] (its query sits at position lengths[i] - 1); rows in
    ``dead`` have tables of -1 only."""
    rng = np.random.default_rng(seed)
    nb = b * w + 3
    perm = rng.permutation(nb).astype(np.int32)
    table = np.full((b, w), -1, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        need = -(-n // bs)
        if i not in dead:
            table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    if int8:
        kp = rng.integers(-127, 128, (nb, bs, hkv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, hkv, dh)).astype(np.int8)
        ks = (rng.random((nb, bs)) / 127).astype(np.float32)
        vs = (rng.random((nb, bs)) / 127).astype(np.float32)
    else:
        kp = rng.standard_normal((nb, bs, hkv, dh), dtype=np.float32)
        vp = rng.standard_normal((nb, bs, hkv, dh), dtype=np.float32)
        ks = vs = None
    q = rng.standard_normal((b, hkv, g, dh), dtype=np.float32) * 2
    pos = np.array([n - 1 for n in lengths], np.int32)
    t = torch.from_numpy
    return dict(q=t(q), k_pool=t(kp), v_pool=t(vp), block_table=t(table), q_off=t(pos),
                k_scale=None if ks is None else t(ks), v_scale=None if vs is None else t(vs),
                group=g)


def gathered_scores(c):
    """Each row's scores over its table's logical tokens, the visibility
    mask (live entry, causal) and the gathered V, as the plain version
    computes them: (B, Hkv, R, Tk), (B, 1, R, Tk), (B, Hkv, Tk, Dh)."""
    q, table = c["q"], c["block_table"]
    b, hkv, r, dh = q.shape
    bs = c["k_pool"].shape[1]
    tk = table.shape[1] * bs
    safe = table.clamp(min=0).long()
    k = c["k_pool"][safe].reshape(b, tk, hkv, dh).permute(0, 2, 1, 3).float()
    v = c["v_pool"][safe].reshape(b, tk, hkv, dh).permute(0, 2, 1, 3).float()
    s = torch.einsum("bhrd,bhkd->bhrk", q.float(), k) * dh ** -0.5
    live = torch.repeat_interleave(table >= 0, bs, dim=1)                  # (B, Tk)
    k_pos = torch.arange(tk)
    q_pos = c["q_off"].long()[:, None] + torch.arange(r) // c["group"]    # (B, R)
    mask = (live[:, None, :] & (k_pos <= q_pos[..., None]))[:, None]
    return torch.where(mask, s, NEG_INF), mask, v


def split_spans(c, n_splits, tile=32):
    """Each row's chunks of its live span [0, position + 1), in whole tiles,
    as the kernel cuts them (empty chunks past the span included)."""
    spans = []
    for pos in c["q_off"].tolist():
        length = pos + 1
        chunk = -(-(-(-length // n_splits)) // tile) * tile
        spans.append([(min(s * chunk, length), min((s + 1) * chunk, length))
                      for s in range(n_splits)])
    return spans


def merge_parts(m, z):
    """attn::merge_parts over the split axis (last): (M, Z, w)."""
    big = m.amax(-1, keepdim=True)
    w = torch.exp(m - big)
    return big, (z * w).sum(-1, keepdim=True), w


def split_read(c, n_splits, gamma=0.0, zeta=1.0):
    s, mask, v = gathered_scores(c)
    b, hkv, r, tk = s.shape
    ms = torch.full((b, hkv, r, n_splits), NEG_INF)
    zs = torch.zeros(b, hkv, r, n_splits)
    acc = torch.zeros(b, hkv, r, n_splits, v.shape[-1])
    chunks = split_spans(c, n_splits)
    sel = torch.zeros(b, n_splits, tk, dtype=torch.bool)
    for i, row in enumerate(chunks):
        for j, (lo, hi) in enumerate(row):
            sel[i, j, lo:hi] = True
    for j in range(n_splits):
        part = mask & sel[:, j][:, None, None, :]                          # (B, 1, R, Tk)
        sp = torch.where(part, s, NEG_INF)
        m = sp.amax(-1)
        p = torch.where(part, torch.exp(sp - m[..., None]), 0.0)
        ms[..., j], zs[..., j] = m, p.sum(-1)
        acc[..., j, :] = p @ v
    big, zz, w = merge_parts(ms, zs)
    if gamma == 0.0 and zeta == 1.0:
        return (acc * w[..., None]).sum(-2) / torch.clamp(zz, min=1e-30)
    # clipped: the merged (M, Z), then each split's clip(.) V, summed
    out = torch.zeros_like(acc[..., 0, :])
    for j in range(n_splits):
        part = mask & sel[:, j][:, None, None, :]
        p = torch.exp(s - big) / torch.clamp(zz, min=1e-30)
        p = torch.where(part, torch.clamp((zeta - gamma) * p + gamma, 0.0, 1.0), 0.0)
        out = out + p @ v
    return out


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("variant", ["vanilla", "clipped"])
def test_split_kv_merge_matches_plain(n_splits, variant):
    gamma = -4.0 / 128 if variant == "clipped" else 0.0
    # short rows leave the later splits with nothing live; row 2 has
    # nothing live at all
    c = paged_case(seed=n_splits, lengths=(1, 17, 100, 128), dead=(2,))
    ref = tpa.paged_flash_attention_ref(
        c["q"], c["k_pool"], c["v_pool"], c["block_table"], c["q_off"], group=c["group"],
        gamma=gamma)
    got = split_read(c, n_splits, gamma=gamma)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    assert not bool(got[2].any()) and not bool(ref[2].any())   # exact zeros


def test_fully_masked_split_weighs_exactly_zero():
    big, zz, w = merge_parts(torch.tensor([[NEG_INF, 3.0, NEG_INF]]),
                             torch.tensor([[0.0, 2.5, 0.0]]))
    assert w.tolist() == [[0.0, 1.0, 0.0]] and float(zz) == 2.5 and float(big) == 3.0
    big, zz, w = merge_parts(torch.full((1, 4), NEG_INF), torch.zeros(1, 4))
    assert float(zz) == 0.0     # nothing live anywhere: out = 0 / 1e-30 = 0


# -- (c) int8 scales after the product --------------------------------------
@pytest.mark.parametrize("variant", ["vanilla", "clipped"])
def test_int8_scales_after_the_product_match_dequantize_first(variant):
    gamma = -4.0 / 128 if variant == "clipped" else 0.0
    c = paged_case(seed=5, int8=True, lengths=(40, 17, 100, 128))
    ref = tpa.paged_flash_attention_ref(
        c["q"], c["k_pool"], c["v_pool"], c["block_table"], c["q_off"], group=c["group"],
        gamma=gamma, k_scale=c["k_scale"], v_scale=c["v_scale"])
    # scores on the codes, then the K scale column, then Dh^-0.5
    q, table = c["q"], c["block_table"]
    b, hkv, r, dh = q.shape
    bs = c["k_pool"].shape[1]
    tk = table.shape[1] * bs
    safe = table.clamp(min=0).long()
    codes_k = c["k_pool"][safe].reshape(b, tk, hkv, dh).permute(0, 2, 1, 3).float()
    codes_v = c["v_pool"][safe].reshape(b, tk, hkv, dh).permute(0, 2, 1, 3).float()
    ks = c["k_scale"][safe].reshape(b, 1, 1, tk)
    vs = c["v_scale"][safe].reshape(b, 1, tk, 1)
    s = torch.einsum("bhrd,bhkd->bhrk", q.float(), codes_k) * ks * dh ** -0.5
    live = torch.repeat_interleave(table >= 0, bs, dim=1)
    q_pos = c["q_off"].long()[:, None] + torch.arange(r) // c["group"]
    mask = (live[:, None, :] & (torch.arange(tk) <= q_pos[..., None]))[:, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    z = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if variant == "vanilla":
        out = ((p * vs.transpose(-1, -2)) @ codes_v) / z     # V scale on P
    else:
        p = torch.where(mask, torch.clamp((1.0 - gamma) * (p / z) + gamma, 0.0, 1.0), 0.0)
        out = (p * vs.transpose(-1, -2)) @ codes_v
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
