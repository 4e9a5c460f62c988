#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. Card: name and power limit, as ``nvidia-smi`` gives them.
  2. Build: every CUDA kernel of the serving path is compiled by ``nvcc``
     from ``src/repro_torch/csrc`` (one ``nvcc`` per source, started
     together) into ``src/repro_torch/_build``.
  3. Kernel against plain version, at qwen3-14b's attention shapes (Hkv 8,
     G 5, Dh 128, block 16; 8 rows at ragged positions up to 1024 with
     scrambled tables and -1 tails): decode Tq = 1 and a prefill chunk
     Tq = 128; vanilla, clipped (alpha-resolved gamma), gated and int8
     pools; float32 at atol 2e-5 (the reference kernel's own) and bfloat16
     at atol 2e-2. Then device times of the kernel, its plain version and
     one PyTorch call computing the same attention
     (``F.scaled_dot_product_attention`` on the gathered, head-repeated
     K/V: a yardstick the port never calls), beside the bound (bytes of
     K/V visited / 3.35 TB/s, or flops / 989 TFLOP/s, the larger).
     A float32 query over a bfloat16 pool (the W8A8 tick without int8 KV)
     is held at the float32 tolerance.
  3b. The W8A8 kernel against its plain version at the main path's
     (M, K, N): decode M = 8 and the padded mixed tick M = 2048 over
     qwen3-14b's projections, and two ragged shapes; static and dynamic
     activation ranges, x in float32 and in bfloat16. The check is
     bitwise (max abs difference 0). Then device times of the kernel, its
     plain version and ``torch._int_mm`` (cuBLASLt, a yardstick the port
     never calls) on the same codes plus the f32 epilogue; ``_int_mm``
     needs M > 16, so decode is timed for it at M padded to 32. Bound:
     max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s).
  4. Serving: ``ContinuousBatcher(paged=True)`` at qwen3-14b's full width
     and 40 layers in bfloat16 with random weights from a seed: 12 greedy
     requests (prompts of 32..512 tokens from a numpy seed, 32 new tokens
     each), batch 8, max_len 1024, token budget 256, on five engines one
     after another: vanilla, clipped softmax (alpha 4) and gated attention
     over an int8 KV pool, then W8A8 (``qconfig=QConfig()``): clipped
     softmax (alpha 4) over a bfloat16 pool (float32 queries) and gated
     attention over an int8 pool. Each must
     finish every request, pass ``audit()`` with no block leak, and
     launch the attention kernel once per layer per forward and, under
     W8A8, the int8 kernel 7 times per layer per forward. At one mixed
     prefill/decode tick the logits of the kernel path and of the plain
     path (``paged_backend="gather"``, and under W8A8 the int8 product's
     plain version) must agree within LOGIT_REL_RMS and LOGIT_MAX_ABS
     (W8A8: W8A8_LOGIT_REL_RMS); under W8A8 the tick through the gather
     read must give bitwise equal logits with the int8 kernel and with its
     plain version, and a W8A8 tick's logits must stay within
     W8A8_VS_FP_REL_RMS of the fp tick's on the same weights.
  5. The kernels line, then the device line.

TF32 is switched off for matmuls and convolutions, so float32 compares
are full float32. Requires ``torch.cuda.is_available()``; exits non-zero
without a GPU or without the repository's ``src/``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Kernel path vs plain path at one mixed tick, 40 bf16 layers deep. Both are
# correct; they round in different places (the plain path scales q and casts
# the probabilities to bf16 before P.V, the kernel keeps both in f32), so each
# layer's attention output differs by about one bf16 ulp (2^-8 relative) and
# 40 bf16 residual updates carry it to the logits. The check is on the RMS
# of the difference relative to the RMS of the logits: a few ulp per layer
# keep it at the percent level, while a wrong read (a wrong block, mask or
# gamma) moves the logits by their own scale, a relative RMS near 1. The max
# over ~4e7 logits is an extreme value and is bounded loosely, at about 0.7
# of the logits' standard deviation (near 1.4 for these random weights).
LOGIT_REL_RMS = 0.05
LOGIT_MAX_ABS = 1.0
# W8A8 kernel path vs plain path. The int8 products are bitwise equal on
# equal inputs (checked at the tick itself: the int8 kernel alone leaves
# the logits bitwise unchanged), so the paths differ by the attention read
# as in the fp engines, but under W8A8 that difference moves activations
# across int8 code boundaries: the gather read rounds its output to bf16
# (~2^-9 relative), about a tenth of a code step s_x, so about a tenth of
# the o-projection's codes move by one step in every layer, a noise of
# the size of the quantization noise itself, compounded over 40 layers.
# Measured: relative RMS 0.164 on clipped-w8a8 (first run of this check,
# against 0.027 for the same model in fp); bounded at 0.3.
W8A8_LOGIT_REL_RMS = 0.3
# W8A8 tick vs fp tick on the same weights and cache: 280 int8
# quantizations of activations and weights per forward. A wrong scale or
# zero-point moves the logits by their own size (relative RMS near 1).
W8A8_VS_FP_REL_RMS = 0.6
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
# (M, K, N) of the W8A8 linears on the main path: decode (8 rows) and the
# padded mixed tick (8 rows x 256 tokens) over qwen3-14b's projections
# (q/o 5120x5120, k/v 5120x1024, gate/up 5120x17408, down 17408x5120),
# then two shapes ragged against every tile
INT8_SHAPES = [(8, 5120, 5120), (8, 5120, 1024), (8, 5120, 17408), (8, 17408, 5120),
               (2048, 5120, 17408), (2048, 17408, 5120), (5, 64, 16), (37, 96, 80)]
KERNEL_SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu",
                  "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:177",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:61"}


def check(ok, msg: str) -> None:
    """A failed check ends the run (explicit, so it also holds under -O)."""
    if not ok:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------
def attention_case(torch, tq, dtype, variant, seed, b=8, hkv=8, g=5, dh=128,
                   bs=16, max_len=1024, copies=1, q_dtype=None):
    """Inputs at qwen3-14b's shapes: rows at ragged positions up to
    max_len, scrambled prefix-dense tables with -1 tails. ``copies``
    independent pool sets let a timing loop find its K/V cold in L2.
    ``q_dtype`` (default: ``dtype``) lets f32 queries read a bf16 pool."""
    gen = torch.Generator().manual_seed(seed)
    w = max_len // bs
    nb = b * w + 8
    pos = torch.randint(0, max_len - tq + 1, (b,), generator=gen, dtype=torch.int32)
    table = torch.full((b, w), -1, dtype=torch.int32)
    perm = torch.randperm(nb, generator=gen).to(torch.int32)
    nxt = 0
    for i in range(b):
        need = -(-(int(pos[i]) + tq) // bs)
        table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    int8 = variant == "int8"
    sets = []
    for _ in range(copies):
        if int8:
            kp = torch.randint(-127, 128, (nb, bs, hkv, dh), generator=gen, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb, bs, hkv, dh), generator=gen, dtype=torch.int8)
            ks = torch.rand(nb, bs, generator=gen) / 127
            vs = torch.rand(nb, bs, generator=gen) / 127
        else:
            kp = torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype)
            vp = torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype)
            ks = vs = None
        sets.append(tuple(None if x is None else x.cuda() for x in (kp, vp, ks, vs)))
    q = torch.randn(b, hkv, tq * g, dh, generator=gen).to(q_dtype or dtype).cuda()
    gate = torch.sigmoid(torch.randn(b, hkv, tq * g, generator=gen)).cuda() \
        if variant == "gated" else None
    gamma = -4.0 / max_len if variant == "clipped" else 0.0   # alpha 4, logical length
    return dict(q=q, sets=sets, table=table.cuda(), pos=pos.cuda(), gate=gate,
                gamma=gamma, group=g, bs=bs)


def run_kernel(pa, c, k=0):
    kp, vp, ks, vs = c["sets"][k]
    return pa.paged_flash_attention(c["q"], kp, vp, c["table"], c["pos"], c["gate"],
                                    group=c["group"], gamma=c["gamma"],
                                    k_scale=ks, v_scale=vs)


def run_plain(pa, c, k=0):
    kp, vp, ks, vs = c["sets"][k]
    return pa.paged_flash_attention_ref(c["q"], kp, vp, c["table"], c["pos"], c["gate"],
                                        group=c["group"], gamma=c["gamma"],
                                        k_scale=ks, v_scale=vs)


def library_inputs(torch, c, k=0):
    """Dense, head-repeated K/V and the boolean mask for one PyTorch
    ``scaled_dot_product_attention`` call computing the same (vanilla)
    attention. Built outside any timing."""
    kp, vp, _, _ = c["sets"][k]
    b, hkv, tqg, dh = c["q"].shape
    g, bs = c["group"], c["bs"]
    tq, w = tqg // g, c["table"].shape[1]
    safe = c["table"].clamp(min=0).long()
    kk = kp[safe].reshape(b, w * bs, hkv, dh).permute(0, 2, 1, 3)
    vv = vp[safe].reshape(b, w * bs, hkv, dh).permute(0, 2, 1, 3)
    kk = kk.repeat_interleave(g, dim=1).contiguous()
    vv = vv.repeat_interleave(g, dim=1).contiguous()
    q = c["q"].reshape(b, hkv, tq, g, dh).permute(0, 1, 3, 2, 4).reshape(b, hkv * g, tq, dh)
    q_pos = c["pos"].long()[:, None] + torch.arange(tq, device="cuda")
    k_pos = torch.arange(w * bs, device="cuda")
    valid = (c["table"] >= 0).repeat_interleave(bs, dim=1)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & valid[:, None, :]
    return q.contiguous(), kk, vv, mask[:, None]


def device_ms(torch, fns, reps):
    """Mean device time of one call: ``reps`` calls enqueued back to back
    behind a GPU sleep (so host overhead does not leave the device idle),
    cycling through ``fns`` (independent input copies, so K/V come from
    HBM rather than L2), between two CUDA events."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(c, elem_bytes):
    """Least time for one call on an H100: each input read once (the K/V
    of every row's live tokens, q, table, scales, gate), the output
    written once, against 3.35 TB/s; the QK and PV flops of every causally
    visible (query, key) pair against the dense bf16 (or f32) peak."""
    q = c["q"]
    b, hkv, tqg, dh = q.shape
    g = c["group"]
    tq = tqg // g
    pos = c["pos"].long().cpu()
    live = int((pos + tq).sum())                       # K/V tokens the rows need
    kv_elem = c["sets"][0][0].element_size()
    nbytes = 2 * live * hkv * dh * kv_elem             # K and V
    if c["sets"][0][2] is not None:
        nbytes += 2 * live * 4                         # per-token scales
    nbytes += 2 * q.numel() * q.element_size()         # q in, out
    nbytes += c["table"].numel() * 4 + b * 4
    if c["gate"] is not None:
        nbytes += c["gate"].numel() * 4
    pairs = int(sum(int(p) * tq + tq * (tq + 1) // 2 for p in pos))
    flops = 4 * dh * hkv * g * pairs
    peak = BF16_FLOPS if elem_bytes == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_checks(torch, pa):
    max_err = 0.0
    bad = []
    # (q dtype, pool dtype): matching pairs, and f32 queries over a bf16
    # pool, which compute in f32 and are held at the f32 tolerance
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))
    for tq in (1, 128):
        for variant in ("vanilla", "clipped", "gated", "int8"):
            for q_dtype, dtype in pairs:
                if variant == "int8" and q_dtype != dtype:
                    continue                   # int8 pools take either q
                c = attention_case(torch, tq, dtype, variant, seed=tq + len(variant),
                                   q_dtype=q_dtype)
                out = run_kernel(pa, c)
                torch.cuda.synchronize()
                ref = run_plain(pa, c)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                name = str(q_dtype).replace("torch.", "")
                if q_dtype != dtype:
                    name += "/" + str(dtype).replace("torch.", "") + "-pool"
                tol = TOL[str(q_dtype).replace("torch.", "")]
                ok = err <= tol and bool(torch.isfinite(out).all())
                max_err = max(max_err, err)
                print(f"kernel check tq={tq:<3} {variant:<7} {name:<19} "
                      f"max_abs_err={err:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    bad.append((tq, variant, name, err))
    check(not bad, f"paged_attention kernel disagrees with its plain version: {bad}")
    return max_err


def phase_kernel_times(torch, pa):
    import torch.nn.functional as F
    times = {}
    for tq, shape in ((1, "decode"), (128, "prefill")):
        for variant in ("vanilla", "clipped", "gated", "int8"):
            c = attention_case(torch, tq, torch.bfloat16, variant, seed=7 + tq, copies=4)
            reps = 40 if tq == 1 else 10
            kern = device_ms(torch, [lambda k=k: run_kernel(pa, c, k) for k in range(4)], reps)
            plain = device_ms(torch, [lambda k=k: run_plain(pa, c, k) for k in range(4)],
                              max(4, reps // 4))
            lib = None
            if variant == "vanilla":
                ins = [library_inputs(torch, c, k) for k in range(4)]
                lib = device_ms(torch, [
                    lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
                    for a in ins], reps)
                del ins
            bound, by = attention_bound_ms(c, 2)
            times[(shape, variant)] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                                           bound_ms=bound, bound_by=by)
            print(f"kernel time {shape:<7} {variant:<7} bf16: kernel {kern:.4f} ms, "
                  f"plain {plain:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms "
                  f"({by})", flush=True)
            del c
            torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 3b: the W8A8 kernel against its plain version
# ---------------------------------------------------------------------------
def int8_case(torch, im, m, k, n, x_dtype, static, seed, copies=1):
    """x (M, K) and ``copies`` weight sets (K, N) int8 with their scales;
    a static range is taken slightly inside x's own so that some codes
    saturate, as they do under calibrated ranges."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, k, generator=gen) * 1.5 + 0.2).to(x_dtype).cuda()
    sets = [im.quantize_weights_int8((torch.randn(k, n, generator=gen) * 0.02).cuda())
            for _ in range(copies)]
    kw = {}
    if static:
        s, z = im.activation_qparams(x)
        kw = dict(x_scale=float(s) * 0.9, x_zero=float(z))
    return x, sets, kw


def int8_bound_ms(m, k, n, x_elem):
    """Least time on an H100: x, w_q and the scales read once, the f32
    output written once, against 3.35 TB/s; 2*M*K*N int8 operations
    against 1979 TOP/s. The larger of the two."""
    nbytes = m * k * x_elem + k * n + m * n * 4 + 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_int8_checks(torch, im):
    bad = []
    max_err = 0.0
    for m, k, n in INT8_SHAPES:
        for x_dtype in (torch.float32, torch.bfloat16):
            for static in (True, False):
                x, sets, kw = int8_case(torch, im, m, k, n, x_dtype, static, seed=m + k + n)
                wq, ws = sets[0]
                out = im.int8_matmul(x, wq, ws, **kw)
                torch.cuda.synchronize()
                ref = im.int8_matmul_ref(x, wq, ws, **kw)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                ok = torch.equal(out, ref) and bool(torch.isfinite(out).all())
                max_err = max(max_err, err)
                name = str(x_dtype).replace("torch.", "")
                print(f"int8 check ({m}, {k}, {n}) {name:<8} "
                      f"{'static ' if static else 'dynamic'} max_abs_err={err:.3e} "
                      f"(bitwise) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append((m, k, n, name, static, err))
                del x, sets, out, ref
    torch.cuda.empty_cache()
    check(not bad, f"int8_matmul kernel disagrees with its plain version: {bad}")
    return max_err


def phase_int8_times(torch, im):
    """Device times at the largest projection (5120 -> 17408, and back),
    x in f32 (what the tick feeds every linear after layer 0's first
    projections), static range: kernel, plain version, and torch._int_mm
    on the same codes plus the f32 epilogue (cuBLASLt wants its B
    K-contiguous, so it gets the same codes transposed; decode runs it at
    M padded to 32, its least M)."""
    times = {}
    for m, k, n in ((8, 5120, 17408), (2048, 5120, 17408), (8, 17408, 5120),
                    (2048, 17408, 5120)):
        x, sets, kw = int8_case(torch, im, m, k, n, torch.float32, True, seed=3, copies=2)
        reps = 40 if m == 8 else 10
        kern = device_ms(torch, [lambda w=w: im.int8_matmul(x, w[0], w[1], **kw)
                                 for w in sets], reps)
        plain = device_ms(torch, [lambda w=w: im.int8_matmul_ref(x, w[0], w[1], **kw)
                                  for w in sets], 4)
        s_x, z_x = im.activation_qparams(x, kw["x_scale"], kw["x_zero"])
        codes = im.quantize_activations(x, s_x, z_x)
        m_lib = max(m, 32)
        if m_lib != m:
            codes = torch.cat([codes, codes.new_zeros(m_lib - m, k)])
        cols = [(w[0].t().contiguous().t(), s_x * w[1]) for w in sets]
        lib = device_ms(torch, [lambda c=c: torch._int_mm(codes, c[0]).float() * c[1]
                                for c in cols], reps)
        bound, by = int8_bound_ms(m, k, n, 4)
        times[(m, k, n)] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                bound_by=by)
        print(f"int8 time ({m}, {k}, {n}) f32 x: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, _int_mm+epilogue (M {m_lib}) {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        del x, sets, cols, codes
        torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 4: serving at qwen3-14b full width
# ---------------------------------------------------------------------------
def phase_serving(torch, np, pa, im, name, method, kv_int8, w8a8=False, **method_kw):
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.qwen3_14b import full
    from repro_torch.models.transformer import model_init
    from repro_torch.nn import layers
    from repro_torch.nn.module import tree_map
    from repro_torch.quant.qconfig import NO_QUANT, QConfig
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving import scheduler as sched
    from repro_torch.serving.decode import step_rows_full

    cfg = apply_method(full(), method, **method_kw)
    t0 = time.perf_counter()
    params = model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lengths = rng.integers(32, 513, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lengths]
    setup = {}

    def timed(key, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            setup[key] = time.perf_counter() - t
            return out
        return run

    # time the two set-up steps of a W8A8 engine inside its constructor
    calibrate_engine, attach = sched._calibrate_engine, sched.attach_int8_weights
    sched._calibrate_engine = timed("calib_s", calibrate_engine)
    sched.attach_int8_weights = timed("quant_s", attach)
    try:
        b = ContinuousBatcher(params, cfg, batch_size=8, max_len=1024, block_size=16,
                              token_budget=256, kv_int8=kv_int8,
                              qconfig=QConfig() if w8a8 else None, device="cuda")
    finally:
        sched._calibrate_engine, sched.attach_int8_weights = calibrate_engine, attach
    snapshot = {}
    step_fn = b._step_fn

    def capture(params_, cache, tokens, pos, counts, keys, lw, lws):
        # the first mixed tick (decode rows beside prefill chunks): keep
        # its inputs and a copy of the cache it reads, for the comparison
        # below, outside the counted run
        c = counts.cpu()
        if not snapshot and (c == 1).any() and (c > 1).any():
            snapshot.update(cache=tree_map(lambda x: x.clone(), cache),
                            args=(tokens.clone(), pos.clone(), counts.clone(), lw,
                                  lws.clone()))
        return step_fn(params_, cache, tokens, pos, counts, keys, lw, lws)

    b._step_fn = capture
    for u, p in enumerate(prompts):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=32))
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    im.launches = 0
    ticks = 0
    t0 = time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        ticks += 1
        if ticks > 1000:
            raise RuntimeError(f"{name}: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches = pa.launches, im.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tokens = sum(len(o) for o in outs.values())
    extra = (f", calibration {setup['calib_s']:.2f} s, weight quantization "
             f"{setup['quant_s']:.2f} s, int8 kernel launches {int8_launches}") if w8a8 else ""
    print(f"serving {name} ({cfg.n_layers} layers): {ticks} ticks, {b.forward_calls} "
          f"forwards, {n_tokens} generated tokens in {wall:.3f} s = "
          f"{n_tokens / wall:.2f} tok/s, peak memory {peak_gb:.2f} GB, weights init "
          f"{init_s:.2f} s, attention kernel launches {launches}{extra}", flush=True)
    check(len(outs) == 12 and all(len(o) == 32 for o in outs.values()),
          f"{name}: not every request finished with 32 tokens")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs.values()),
          f"{name}: token ids outside the vocabulary")
    check(not b.failed, f"{name}: failed requests {[r.status for r in b.failed]}")
    b.audit()
    check(b.allocator.available == b.num_blocks and (b.tables == -1).all(),
          f"{name}: block leak")
    check(launches > 0 and launches == cfg.n_layers * b.forward_calls,
          f"{name}: {launches} kernel launches for {b.forward_calls} forwards")
    check(int8_launches == (7 * cfg.n_layers * b.forward_calls if w8a8 else 0),
          f"{name}: {int8_launches} int8 launches for {b.forward_calls} forwards")
    check(snapshot, f"{name}: no mixed prefill/decode tick was seen")

    # the mixed tick again: through the kernels, through the plain path
    # (the gather read and, under W8A8, the int8 product's plain version),
    # and under W8A8 through the fp tick on the same weights
    tokens, pos, counts, lw, lws = snapshot["args"]
    live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    # (name, paged backend, int8 product's plain version, quantization)
    runs = [("auto", "auto", False, b._qctx), ("gather", "gather", True, b._qctx)]
    if w8a8:
        runs += [("gather+int8-kernel", "gather", False, b._qctx),
                 ("fp", "auto", False, NO_QUANT)]
    logits = {}
    with torch.no_grad():
        for key, backend, plain_int8, ctx in runs:
            cache = tree_map(lambda x: x.clone(), snapshot["cache"])
            c2 = dataclasses.replace(b.cfg, paged_backend=backend)
            if plain_int8:
                layers.int8_matmul = im.int8_matmul_ref
            try:
                out, _ = step_rows_full(b.params, c2, cache, tokens, pos, counts, lw, lws,
                                        ctx=ctx)
            finally:
                layers.int8_matmul = im.int8_matmul
            logits[key] = out[live][:, :cfg.vocab_size]
            del cache, out

    def rel(a, ref):
        return ((a - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()

    delta = logits["auto"] - logits["gather"]
    diff = delta.abs().max().item()
    rel_rms = rel(logits["auto"], logits["gather"])
    spread = logits["gather"].std().item()
    agree = (logits["auto"].argmax(-1) == logits["gather"].argmax(-1)).float().mean().item()
    tol = W8A8_LOGIT_REL_RMS if w8a8 else LOGIT_REL_RMS
    print(f"serving {name}: mixed tick (counts {counts.tolist()}): kernel vs plain "
          f"logits relative RMS {rel_rms:.4f} (tol {tol}), max_abs_diff "
          f"{diff:.4f}{'' if w8a8 else f' (tol {LOGIT_MAX_ABS})'} (logit std "
          f"{spread:.3f}), argmax agreement {agree:.4f}", flush=True)
    check(rel_rms <= tol and (w8a8 or diff <= LOGIT_MAX_ABS),
          f"{name}: kernel and plain logits differ: relative RMS {rel_rms}, max {diff}")
    result = dict(engine=name, layers=cfg.n_layers, ticks=ticks, forwards=b.forward_calls,
                  tokens=n_tokens, wall_s=wall, tok_per_s=n_tokens / wall,
                  peak_gb=peak_gb, launches=launches, int8_launches=int8_launches,
                  logit_max_abs_diff=diff, logit_rel_rms=rel_rms,
                  logit_std=spread, argmax_agreement=agree, init_s=init_s, **setup)
    if w8a8:
        # the same tick with only the int8 product swapped for its plain
        # version: every product is bitwise equal, so the logits are too
        same = torch.equal(logits["gather+int8-kernel"], logits["gather"])
        print(f"serving {name}: mixed tick through the gather read: int8 kernel vs "
              f"its plain version, logits bitwise equal: {same}", flush=True)
        check(same, f"{name}: the int8 kernel changed the tick's logits")
        vs_fp = rel(logits["auto"], logits["fp"])
        agree_fp = (logits["auto"].argmax(-1) == logits["fp"].argmax(-1)).float().mean().item()
        print(f"serving {name}: W8A8 tick vs fp tick on the same weights: logits "
              f"relative RMS {vs_fp:.4f} (tol {W8A8_VS_FP_REL_RMS}), argmax agreement "
              f"{agree_fp:.4f}", flush=True)
        check(vs_fp <= W8A8_VS_FP_REL_RMS,
              f"{name}: W8A8 logits far from fp logits: relative RMS {vs_fp}")
        result.update(w8a8_vs_fp_rel_rms=vs_fp, w8a8_vs_fp_argmax_agreement=agree_fp)
    del b, params, snapshot, logits, delta
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch.kernels import build
        from repro_torch.kernels import int8_matmul as im
        from repro_torch.kernels import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and convolutions", flush=True)

    card = nvidia_smi()
    print(card, flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:   # one nvcc per source
        built = dict(zip(KERNEL_SOURCES, ex.map(build.build, KERNEL_SOURCES)))
    for name, (path, secs) in built.items():
        ptxas = [line.split("ptxas info    :")[-1].strip()
                 for line in build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in line or "spill stores" in line]
        print(f"built {name}: {path.name} in {secs:.1f} s; ptxas per kernel: "
              f"{'; '.join(ptxas) or 'n/a'}", flush=True)
    print(f"build phase {time.perf_counter() - t0:.1f} s", flush=True)

    max_err = phase_kernel_checks(torch, pa)
    times = phase_kernel_times(torch, pa)
    int8_err = phase_int8_checks(torch, im)
    int8_times = phase_int8_times(torch, im)

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    engines = [
        phase_serving(torch, np, pa, im, "vanilla", "vanilla", False),
        phase_serving(torch, np, pa, im, "clipped", "clipped_softmax", False, alpha=4.0),
        phase_serving(torch, np, pa, im, "gated-int8kv", "gated_attention", True),
        phase_serving(torch, np, pa, im, "clipped-w8a8", "clipped_softmax", False,
                      w8a8=True, alpha=4.0),
        phase_serving(torch, np, pa, im, "gated-w8a8-int8kv", "gated_attention", None,
                      w8a8=True)]

    dec = times[("decode", "vanilla")]
    i8 = int8_times[(8, 5120, 17408)]
    kernels = [dict(name="paged_attention", route="cuda",
                    source=KERNEL_SOURCES["paged_attention"],
                    replaces=REPLACES["paged_attention"],
                    launches=sum(e["launches"] for e in engines),
                    max_abs_err=max_err, ms=dec["ms"], plain_ms=dec["plain_ms"],
                    bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                    library_ms=dec["library_ms"]),
               dict(name="int8_matmul", route="cuda",
                    source=KERNEL_SOURCES["int8_matmul"],
                    replaces=REPLACES["int8_matmul"],
                    launches=sum(e["int8_launches"] for e in engines),
                    max_abs_err=int8_err, ms=i8["ms"], plain_ms=i8["plain_ms"],
                    bound_ms=i8["bound_ms"], bound_by=i8["bound_by"],
                    library_ms=i8["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
