#!/usr/bin/env python3
"""Size the RG-LRU reverse scan's TMA ring on the card: consumer warps a
CTA, tile length and ring depth.

    python3 tools/rg_lru_bwd_sweep.py [--warps 1 2 4 8] [--tiles 32] [--stages 3]
                                      [--shapes 8,256,4096 1,2048,4096 ...]

Each (BWD_WARPS, BWD_TILE, BWD_STAGES) is built from
``src/repro_torch/csrc/rg_lru.cu`` by ``kernels/build.py`` with those
values as ``-D`` (all builds at once, into the ignored build directory);
each build's reverse-scan ring entry prints its ptxas registers and spill
stores, and a variant whose shared memory does not fit a CTA is reported
as failed. Then at each shape (``chip_smoke.RG_TIMED`` unless given) every
variant's route 1 and the default build's route 0 (direct loads, the
first design) are held bitwise against ``rglru_bwd_ref`` and timed with
CUDA events as phase 3f times the kernel (``chip_smoke.device_ms``, the
same input copies), in turns: through the list, then back; both readings
are printed. The card's name and power limit come first. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def bound(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the reverse scan's argument and result types set."""
    lib.rglru_bwd_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.rglru_bwd_launch.restype = ctypes.c_int
    return lib


def launch(torch, lib, route, a, h, dh, dh_last, h0):
    """(da, db, dh0) of the reverse scan through ``lib`` on ``route``."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.rglru_bwd_launch(ptr(a), ptr(h), ptr(dh), ptr(dh_last), ptr(h0), ptr(da),
                               ptr(db), ptr(dh0), *a.shape, route,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_bwd_launch route {route}: cudaError {err}")
    return da, db, dh0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", type=int, nargs="+", default=[1])
    ap.add_argument("--tiles", type=int, nargs="+", default=[32])
    ap.add_argument("--stages", type=int, nargs="+", default=[3])
    ap.add_argument("--shapes", nargs="+", default=None, help="B,T,D each")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rg_lru_bwd_sweep: this needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import rg_lru as rl

    print(cs.nvidia_smi(), flush=True)
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes] if args.shapes
              else cs.RG_TIMED)
    variants = [(f"BWD_WARPS={w}", f"BWD_TILE={t}", f"BWD_STAGES={s}")
                for w, t, s in itertools.product(args.warps, args.tiles, args.stages)]

    def try_build(defines):
        try:
            return build.build("rg_lru", defines)[0], build.BUILD_LOG[" ".join(("rg_lru",
                                                                                *defines))]
        except RuntimeError as e:
            return None, str(e)

    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(try_build, variants))
    libs = [("default build", bound(ctypes.CDLL(str(build.build("rg_lru")[0]))), 0)]
    for defines, (path, log) in zip(variants, built):
        name = " ".join(defines)
        if path is None:
            print(f"{name}: build failed: "
                  f"{' '.join(line for line in log.splitlines() if 'error' in line)[:300]}",
                  flush=True)
            continue
        entry = [(r, sp) for f, r, sp in cs.ptxas_report(log) if "rglru_bwd_tma" in f]
        print(f"{name}: ring entry (registers, spill-store bytes) {entry}", flush=True)
        libs.append((name, bound(ctypes.CDLL(str(path))), 1))
    for shape in shapes:
        sets = cs.rg_bwd_case(torch, rl, shape, seed=170,
                              copies=2 if shape[0] * shape[1] >= 2048 else 8)
        want = rl.rglru_bwd_ref(*sets[0])
        readings = {}
        for order in (libs, libs[::-1]):
            for name, lib, route in order:
                got = launch(torch, lib, route, *sets[0])
                same = all(torch.equal(x, y) for x, y in zip(got, want) if x is not None)
                ms = cs.device_ms(torch, [lambda s=s: launch(torch, lib, route, *s)
                                          for s in sets], 20)
                readings.setdefault((name, route), []).append((ms, same))
        for (name, route), r in readings.items():
            print(f"rg_lru bwd sweep {shape} {name} route {route}: "
                  f"{' / '.join(f'{ms:.4f}' for ms, _ in r)} ms (forward / backward turn), "
                  f"bound {cs.rg_bwd_bound_ms(shape):.4f} ms, bitwise "
                  f"{'ok' if all(ok for _, ok in r) else 'FAIL'}", flush=True)
        del sets, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
