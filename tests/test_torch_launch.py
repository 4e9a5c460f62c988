"""The port's launchers (``repro_torch.launch``) on the CPU.

  * **Flops against XLA.** One step of each kind (train, prefill,
    decode) of qwen3-14b at its full width, depth 1, batch 2, sequence
    64, counted by the dry-run (``launch.dryrun.count_step``, one
    device) against XLA's ``cost_analysis`` of the reference's
    ``build_lowered`` on a (1, 1) mesh, unrolled. torch's flop formulas
    count the matrix products (and attention's); XLA also counts every
    elementwise op (AdamW's update, the f32 head's cast of the table), so
    the port's count sits at or below XLA's: readings 0.923 / 0.993 /
    0.701 of it on this CPU. Bound: ``FLOPS_LO`` <= port / XLA <= 1. The
    control leaves the lm_head's products out of the port's count (0.28,
    0.30, 0.21): it must land below ``FLOPS_LO``.
  * **Sharding.** On a 4x4 fake mesh, a ``tp_fsdp`` train cell counts
    each device's flops at global / 16 and non-zero collectives; a
    ``replicated`` prefill cell none (and global / 4: the batch still
    splits over 'data'); a cell with an op DTensor has no strategy for
    names that op.
  * **The training launcher** (``launch.train.train_on_mesh``) on a
    one-device (1, 1) mesh: its first step's loss on converted reference
    weights against the reference's step at rtol 1e-6; 2k steps bitwise
    a plain ``make_train_step`` loop; a run resumed from the checkpoint
    at k bitwise the uninterrupted one; each leaf of its state placed as
    ``tree_param_specs`` says under the three profiles; a mesh that
    splits a tensor raises.
  * Both CLIs in a process of their own.

A process has one default group: a module fixture starts torch's fake
backend at 16 ranks (rank 0) and destroys it after the last test. The
(1, 1) mesh is rank 0 alone.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import apply_method as japply
from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_make_mesh
from repro.launch.roofline import normalize_cost_analysis
from repro_torch.configs import SHAPES, ShapeSpec, apply_method, get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.nn.module import flatten_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_sharding import reference_dryrun
from test_torch_train import (LOSS_RTOL, SEQ, VOCAB, _batch, _jb, _states, _task_pair, jstep,
                              tstep, tsyn)

ROOT = Path(__file__).resolve().parent.parent
FLOPS_LO = 0.6
FLOPS_ARCH, FLOPS_B, FLOPS_T = "qwen3-14b", 2, 64
HALF = 4                                 # k: 2k steps, a restart at k


@pytest.fixture(scope="module")
def meshes():
    """(the (1, 1) mesh over rank 0, a 4x4 mesh) on a 16-rank fake group."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    tmesh.close_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    one = DeviceMesh("cpu", torch.tensor([[0]]), mesh_dim_names=("data", "model"))
    four = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    yield one, four
    tmesh.close_mesh()


def _flops_cfgs():
    j = dataclasses.replace(japply(jget_arch(FLOPS_ARCH).full(), "clipped_softmax"),
                            n_layers=1, scan_layers=False, remat=False, max_seq_len=72)
    t = dataclasses.replace(apply_method(get_arch(FLOPS_ARCH).full(), "clipped_softmax"),
                            n_layers=1, scan_layers=False, max_seq_len=72)
    return j, t


@pytest.mark.parametrize("step", ("train", "prefill", "decode"))
def test_counted_flops_against_xla(step):
    jdry = reference_dryrun()
    jc, tc = _flops_cfgs()
    jmesh = compat_make_mesh((1, 1), ("data", "model"))
    xla = float(normalize_cost_analysis(
        jdry.build_lowered(jc, JShape("x", FLOPS_T, FLOPS_B, step), jmesh, "tp_fsdp")
        .compile())["flops"])
    counts, _ = tdry.count_step(tc, ShapeSpec("x", FLOPS_T, FLOPS_B, step), None, "tp_fsdp")
    assert counts.collectives.counts == {}
    tokens = FLOPS_B * (1 if step == "decode" else FLOPS_T)
    head = 2.0 * tokens * tc.d_model * tc.padded_vocab * (3 if step == "train" else 1)
    ratio, control = counts.flops / xla, (counts.flops - head) / xla
    print(f"{step}: port {counts.flops:.6g} / XLA {xla:.6g} = {ratio:.4f}; "
          f"without the lm_head {control:.4f}")
    assert FLOPS_LO <= ratio <= 1.0
    assert control < FLOPS_LO


def test_tp_fsdp_train_cell_divides_flops_and_communicates(meshes):
    _, four = meshes
    _, tc = _flops_cfgs()
    shape = ShapeSpec("x", 64, 16, "train")
    whole, _ = tdry.count_step(tc, shape, None, "tp_fsdp")
    local, mem = tdry.count_step(tc, shape, four, "tp_fsdp")
    share = local.flops * 16 / whole.flops
    colls = local.collectives
    print(f"tp_fsdp train on 4x4: local {local.flops:.6g} x 16 / global {whole.flops:.6g} = "
          f"{share:.4f}; collectives {colls.counts}, wire {colls.wire_bytes:.4g} B")
    assert 0.99 <= share <= 1.01
    assert colls.wire_bytes > 0 and colls.counts.get("all-gather", 0) > 0
    assert colls.counts.get("reduce-scatter", 0) + colls.counts.get("all-reduce", 0) > 0
    roof = tdry.analyze(local, 16, model_flops_total=whole.flops)
    assert roof.collective_s > 0 and roof.bottleneck in ("compute", "memory", "collective")
    assert roof.useful_flops_ratio == pytest.approx(1 / share)
    assert 0 < mem["argument_bytes"]


def test_replicated_prefill_cell_has_no_collectives(meshes):
    _, four = meshes
    rep = tdry.lower_cell("hubert-xlarge", "prefill_32k", four, "replicated", n_layers=1)
    r = rep["roofline"]
    assert rep["status"] == "ok" and rep["mesh"] == [4, 4]
    assert r["collectives"]["counts"] == {} and r["wire_bytes_per_device"] == 0
    assert r["collective_s"] == 0 and r["flops_per_device"] > 0
    # the batch splits over 'data' (4), the weights are whole
    shape = SHAPES["prefill_32k"]
    cfg = dataclasses.replace(apply_method(get_arch("hubert-xlarge").full(), "clipped_softmax"),
                              n_layers=1, max_seq_len=shape.seq_len + 8)
    whole, _ = tdry.count_step(cfg, shape, None, "replicated")
    assert r["flops_per_device"] * 4 == pytest.approx(whole.flops, rel=1e-6)
    skipped = tdry.lower_cell("hubert-xlarge", "decode_32k", four, "replicated")
    assert skipped["status"] == "skipped" and "encoder-only" in skipped["reason"]


def test_a_cell_without_a_sharding_rule_names_its_op(meshes):
    """qwen2-moe-a2.7b's decode cell has one dispatch group, which the
    4-wide data axis cannot split: DTensor has no strategy for the
    in-place scatter into it, and the error names the op."""
    _, four = meshes
    with pytest.raises(Exception) as err:
        tdry.lower_cell("qwen2-moe-a2.7b", "decode_32k", four, "tp_fsdp", n_layers=1)
    assert tdry._op_name(err.value) == "aten.scatter_.src"
    assert "aten.scatter_.src" in tdry._error_text(err.value)


def _opt_task():
    jt, tt, kind = _task_pair("opt", "clipped")
    data = tsyn.SyntheticLM(tsyn.SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                                   batch_size=4))
    return jt, tt, kind, data


def test_launcher_first_step_matches_reference(meshes):
    one, _ = meshes
    jt, tt, kind, data = _opt_task()
    b = data.batch(0, kind)
    for k, v in _batch(kind).items():
        np.testing.assert_array_equal(b[k], v)
    js, ts = _states(jt, tt)
    _, jm = jax.jit(jstep.make_train_step(jt))(js, _jb(b))
    run = tlaunch.train_on_mesh(tt, data, one, "tp_fsdp", steps=1, batch_kind=kind,
                                device="cpu", state=ts, log=lambda _m: None)
    np.testing.assert_allclose(run["losses"][0], float(jm["loss"]), rtol=LOSS_RTOL)


def test_launcher_is_the_plain_loop_and_resumes_bitwise(meshes, tmp_path):
    one, _ = meshes
    _, tt, kind, data = _opt_task()
    quiet = lambda _m: None  # noqa: E731
    full = tlaunch.train_on_mesh(tt, data, one, "tp_fsdp", steps=2 * HALF, batch_kind=kind,
                                 device="cpu", ckpt_dir=str(tmp_path / "full"),
                                 ckpt_every=HALF, log=quiet)
    state, step, losses = tstep.init_train_state(0, tt, device="cpu"), \
        tstep.make_train_step(tt), []
    for i in range(2 * HALF):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in data.batch(i, kind).items()})
        losses.append(float(m["loss"]))
    assert full["losses"] == losses
    final = dict(flatten_params(full["local"]))
    assert all(torch.equal(x, final[p]) for p, x in flatten_params(state))
    assert all(torch.equal(x.to_local(), final[p]) for p, x in flatten_params(full["state"]))

    shutil.copytree(tmp_path / "full" / f"step_{HALF:08d}", tmp_path / "half" / f"step_{HALF:08d}")
    resumed = tlaunch.train_on_mesh(tt, data, one, "tp_fsdp", steps=2 * HALF, batch_kind=kind,
                                    device="cpu", ckpt_dir=str(tmp_path / "half"), log=quiet)
    assert resumed["start_step"] == HALF and resumed["losses"] == losses[HALF:]
    assert all(torch.equal(x, final[p]) for p, x in flatten_params(resumed["local"]))


@pytest.mark.parametrize("profile", tsh.PROFILES)
def test_launcher_placements_are_the_profiles(meshes, profile):
    one, four = meshes
    _, tt, kind, data = _opt_task()
    state = tstep.init_train_state(0, tt, device="cpu")
    run = tlaunch.train_on_mesh(tt, data, one, profile, steps=0, batch_kind=kind,
                                device="cpu")
    specs = dict(tsh.spec_leaves(tsh.tree_param_specs(state, profile, one)))
    got = dict(tsh.placement_leaves(run["placements"]))
    assert sorted(got) == sorted(specs) == [p for p, _ in flatten_params(state)]
    for path, x in flatten_params(run["state"]):
        assert tuple(x.placements) == got[path] == tsh.placements_for(specs[path], one)
    assert (any(any(p.is_shard() for p in pl) for pl in got.values())
            == (profile != "replicated"))
    if profile != "replicated":
        with pytest.raises(NotImplementedError, match=r"ROADMAP 5\.5"):
            tlaunch.train_on_mesh(tt, data, four, profile, steps=1, batch_kind=kind,
                                  device="cpu")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


def test_train_cli_on_the_cpu(tmp_path):
    out = _cli("repro_torch.launch.train", "--arch", "qwen3-14b", "--smoke", "--steps", "2",
               "--seq-len", "16", "--batch-size", "2", "--device", "cpu",
               "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mesh: {'data': 1, 'model': 1} over 1 devices" in out.stdout
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_dryrun_cli_reports_a_cell(tmp_path):
    out = _cli("repro_torch.launch.dryrun", "--arch", "hubert-xlarge", "--shape",
               "decode_32k", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[skipped] hubert-xlarge__decode_32k__16x16__tp_fsdp" in out.stdout
    assert (tmp_path / "hubert-xlarge__decode_32k__16x16__tp_fsdp.json").exists()
