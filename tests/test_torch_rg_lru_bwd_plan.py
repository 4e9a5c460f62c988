"""The static launch plan of the RG-LRU reverse scan, on the CPU.

``repro_torch.kernels.rg_lru.plan_bwd`` picks the reverse-scan kernel's
route from the shape and the alignment alone: route 1, a TMA ring walked
backwards in one-warp strips, for D % 4 == 0 and 16-byte aligned a, h,
dh, da and db; route 0, direct loads, for the rest. It is pure Python and
is tested here: the routes, the grid at B 1 against a 132-SM card, the
launch limits, the ring's constants against the CUDA source's, the plans
of the card's shapes, and that the wrapper hands the plan's route to the
kernel (a stood-in library and CUDA tensor: this machine has no card).
The kernel itself runs only on the card, where ``chip_smoke.py`` phase 3f
holds both routes bitwise against ``rglru_bwd_ref``;
``tests/test_torch_rg_lru_backward.py`` holds that plain loop against
the reference's ``jax.vjp``."""
import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

trl = importlib.import_module("repro_torch.kernels.rg_lru")
SMS = 132                       # an H100 SXM's SMs
SRC = Path(trl.__file__).parent.parent / "csrc" / "rg_lru.cu"


def _constant(name):
    """``name``'s value in the CUDA source: a constant, or the default of a
    size a build may set with -D."""
    found = re.search(rf"constexpr int {name} = (\d+);|#define {name} (\d+)\n",
                      SRC.read_text())
    return int(found.group(1) or found.group(2))


@pytest.mark.parametrize("d,aligned,route", [
    (4096, True, 1), (4100, True, 1), (16, True, 1), (4096, False, 0), (777, True, 0),
    (70, True, 0), (18, False, 0)])
def test_plan_bwd_takes_the_ring_only_for_d_a_multiple_of_4_and_aligned(d, aligned, route):
    """The ring's tensor maps need a row stride of a multiple of 16 bytes
    and 16-byte aligned bases; everything else takes route 0, and T or B
    never change the route."""
    for b, t in ((1, 2048), (8, 32), (3, 33), (65535, 1)):
        assert trl.plan_bwd(b, t, d, aligned=aligned).route == route


@pytest.mark.parametrize("b,t,d", [
    (1, 4096, 4096), (1, 2048, 4096), (8, 256, 4096), (8, 32, 4096), (1, 1000, 4096),
    (8, 1, 4096), (2, 300, 4100), (16, 1, 4096), (1, 10, 16), (3, 33, 777),
    (65535, 1, 4096), (65535, 3, 777), (65535, 2, 1 << 16)])
def test_plan_bwd_covers_a_wave_within_the_launch_limits(b, t, d):
    """Every channel of every row has a CTA; the grid, the CTA's threads
    and its shared memory stay within a launch's limits; the ring's boxes
    within TMA's 256 elements a side; one-warp strips, the most CTAs a
    grid of whole warps can have, so the grid covers one wave of the card
    whenever any can (at B 1, D 4096: 128 CTAs, one an SM)."""
    p = trl.plan_bwd(b, t, d)
    assert p.ctas == b * -(-d // p.channels)
    assert 1 <= p.ctas <= 2 ** 31 - 1
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.smem <= 232448
    if p.route == 0:
        assert (p.channels, p.threads, p.smem) == (128, 128, 0)
        return
    assert (p.warps, p.channels, p.threads) == (1, 32, 64)
    assert p.tile_t == trl.BWD_TILE_STEPS and 1 <= p.tile_t <= 256
    assert p.smem == trl.BWD_SMEM_BYTES
    assert p.ctas == b * -(-d // 32)
    assert (p.ctas >= SMS) == (b * -(-d // 32) >= SMS)
    assert p.ctas >= trl.plan(b, t, d, SMS).ctas    # never fewer than the forward's


def test_bwd_ring_constants_match_the_kernel():
    """The wrapper's warps, tile, ring depth and shared-memory size are
    the CUDA source's defaults: one consumer warp, slots of a, dh and h
    over 32 steps x 32 channels (12 KB), two da and two db tiles (16 KB),
    two barriers a slot and the alignment slack, within a CTA's 227 KB;
    the forward's own constants are left as they were."""
    assert _constant("BWD_WARPS") == trl.BWD_WARPS == 1
    assert _constant("BWD_TILE") == trl.BWD_TILE_STEPS == 32
    assert _constant("BWD_STAGES") == trl.BWD_STAGES
    slot = 3 * trl.BWD_TILE_STEPS * 32 * 4
    assert slot == 12288
    assert trl.BWD_SMEM_BYTES == trl.BWD_STAGES * slot + 16384 + 16 * trl.BWD_STAGES + 128
    assert trl.BWD_SMEM_BYTES <= 227 * 1024
    assert _constant("STAGES") == trl.TMA_STAGES


def test_plan_bwd_of_the_card_shapes():
    """The plans phase 3f prints: the training step's long row in one-warp
    strips (128 CTAs, tiles of 32 steps; T 1000 leaves a partial tile of
    8), a serving-sized batch in the same strips (1024 CTAs), a ragged D
    or misaligned inputs on route 0."""
    assert trl.plan_bwd(1, 2048, 4096)[:5] == (1, 1, 32, 32, 128)
    assert trl.plan_bwd(1, 1000, 4096)[:5] == (1, 1, 32, 32, 128)
    assert 1000 % trl.plan_bwd(1, 1000, 4096).tile_t == 8
    assert trl.plan_bwd(8, 256, 4096)[:5] == (1, 1, 32, 32, 1024)
    assert trl.plan_bwd(3, 33, 777)[:5] == (0, 4, 128, 16, 21)
    assert trl.plan_bwd(8, 256, 4096, aligned=False)[:5] == (0, 4, 128, 16, 256)


@pytest.mark.parametrize("d,route", [(8, 1), (6, 0)])
def test_launch_bwd_hands_the_plan_to_the_kernel(monkeypatch, d, route):
    """``_launch_bwd`` on CUDA tensors (a stand-in whose ``is_cuda`` is
    true, with the library, the device guard and the stream stood in)
    passes ``plan_bwd``'s route after (B, T, D), counts the launch, and
    raises naming the plan when the kernel refuses."""
    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    calls, err = [], [0]

    class Lib:
        def rglru_bwd_launch(self, *args):
            calls.append(args)
            return err[0]

    class Stream:
        cuda_stream = 0

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trl, "_kernel_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)   # 16-byte aligned
    a, h, dh = (torch.rand(2, 5, d).as_subclass(Cuda) for _ in range(3))
    dl = torch.zeros(2, d).as_subclass(Cuda)
    before = trl.bwd_launches
    trl._launch_bwd(a, h, dh, dl, None)
    assert calls[0][8:12] == (2, 5, d, route)
    assert trl.bwd_launches == before + 1
    err[0] = 1
    with pytest.raises(RuntimeError, match=f"route={route}"):
        trl._launch_bwd(a, h, dh, dl, None)
    assert trl.bwd_launches == before + 1
