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
  4. Serving: ``ContinuousBatcher(paged=True)`` at qwen3-14b's full width
     and 40 layers in bfloat16 with random weights from a seed: 12 greedy
     requests (prompts of 32..512 tokens from a numpy seed, 32 new tokens
     each), batch 8, max_len 1024, token budget 256, on three engines one
     after another: vanilla, clipped softmax (alpha 4) and gated attention
     over an int8 KV pool. Each must finish every request, pass
     ``audit()`` with no block leak, and launch the attention kernel once
     per layer per forward. At one mixed prefill/decode tick the logits of
     the kernel path and of the plain path (``paged_backend="gather"``)
     must agree within LOGIT_REL_RMS and LOGIT_MAX_ABS.
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
KERNEL_SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:177"}


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
                   bs=16, max_len=1024, copies=1):
    """Inputs at qwen3-14b's shapes: rows at ragged positions up to
    max_len, scrambled prefix-dense tables with -1 tails. ``copies``
    independent pool sets let a timing loop find its K/V cold in L2."""
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
    q = torch.randn(b, hkv, tq * g, dh, generator=gen).to(dtype).cuda()
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
    for tq in (1, 128):
        for variant in ("vanilla", "clipped", "gated", "int8"):
            for dtype in (torch.float32, torch.bfloat16):
                c = attention_case(torch, tq, dtype, variant, seed=tq + len(variant))
                out = run_kernel(pa, c)
                torch.cuda.synchronize()
                ref = run_plain(pa, c)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                name = str(dtype).replace("torch.", "")
                tol = TOL[name]
                ok = err <= tol and bool(torch.isfinite(out).all())
                max_err = max(max_err, err)
                print(f"kernel check tq={tq:<3} {variant:<7} {name:<8} "
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
# phase 4: serving at qwen3-14b full width, 40 layers
# ---------------------------------------------------------------------------
def phase_serving(torch, np, pa, name, method, kv_int8, **method_kw):
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.qwen3_14b import full
    from repro_torch.models.transformer import model_init
    from repro_torch.nn.module import tree_map
    from repro_torch.serving import ContinuousBatcher, Request
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
    b = ContinuousBatcher(params, cfg, batch_size=8, max_len=1024, block_size=16,
                          token_budget=256, kv_int8=kv_int8, device="cuda")
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
    ticks = 0
    t0 = time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        ticks += 1
        if ticks > 1000:
            raise RuntimeError(f"{name}: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tokens = sum(len(o) for o in outs.values())
    print(f"serving {name}: {ticks} ticks, {b.forward_calls} forwards, "
          f"{n_tokens} generated tokens in {wall:.3f} s = {n_tokens / wall:.2f} tok/s, "
          f"peak memory {peak_gb:.2f} GB, weights init {init_s:.2f} s, "
          f"kernel launches {launches}", flush=True)
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
    check(snapshot, f"{name}: no mixed prefill/decode tick was seen")

    # the mixed tick again, through the kernel and through the plain path
    tokens, pos, counts, lw, lws = snapshot["args"]
    logits = {}
    with torch.no_grad():
        for backend in ("auto", "gather"):
            cache = tree_map(lambda x: x.clone(), snapshot["cache"])
            c2 = dataclasses.replace(cfg, paged_backend=backend)
            out, _ = step_rows_full(params, c2, cache, tokens, pos, counts, lw, lws)
            live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] \
                < counts[:, None]
            logits[backend] = out[live][:, :cfg.vocab_size]
            del cache, out
    delta = logits["auto"] - logits["gather"]
    diff = delta.abs().max().item()
    rel_rms = (delta.square().mean().sqrt() / logits["gather"].square().mean().sqrt()).item()
    spread = logits["gather"].std().item()
    agree = (logits["auto"].argmax(-1) == logits["gather"].argmax(-1)).float().mean().item()
    print(f"serving {name}: mixed tick (counts {counts.tolist()}): kernel vs plain "
          f"logits relative RMS {rel_rms:.4f} (tol {LOGIT_REL_RMS}), max_abs_diff "
          f"{diff:.4f} (tol {LOGIT_MAX_ABS}; logit std {spread:.3f}), argmax "
          f"agreement {agree:.4f}", flush=True)
    check(rel_rms <= LOGIT_REL_RMS and diff <= LOGIT_MAX_ABS,
          f"{name}: kernel and plain logits differ: relative RMS {rel_rms}, max {diff}")
    result = dict(engine=name, ticks=ticks, forwards=b.forward_calls,
                  tokens=n_tokens, wall_s=wall, tok_per_s=n_tokens / wall,
                  peak_gb=peak_gb, launches=launches, logit_max_abs_diff=diff,
                  logit_rel_rms=rel_rms,
                  logit_std=spread, argmax_agreement=agree, init_s=init_s)
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

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    engines = [phase_serving(torch, np, pa, "vanilla", "vanilla", False),
               phase_serving(torch, np, pa, "clipped", "clipped_softmax", False,
                             alpha=4.0),
               phase_serving(torch, np, pa, "gated-int8kv", "gated_attention", True)]

    dec = times[("decode", "vanilla")]
    kernels = [dict(name="paged_attention", route="cuda",
                    source=KERNEL_SOURCES["paged_attention"],
                    replaces=REPLACES["paged_attention"],
                    launches=sum(e["launches"] for e in engines),
                    max_abs_err=max_err, ms=dec["ms"], plain_ms=dec["plain_ms"],
                    bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                    library_ms=dec["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
