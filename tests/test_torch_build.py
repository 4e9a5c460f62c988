"""The port's kernel build names each library by a hash of its source and
of every local header the source includes, transitively: an edited header
rebuilds its kernels, an unchanged tree loads the library it has. Runs on
the CPU: ``library_path`` hashes files and never calls ``nvcc``."""
import importlib

import pytest

build = importlib.import_module("repro_torch.kernels.build")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                              'extern "C" int f() { return A + 1; }\n')
    (src / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#define A B\n')
    (src / "b.cuh").write_text("#pragma once\n#define B 2\n")
    (src / "unused.cuh").write_text("#define U 3\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_unchanged_tree_keeps_its_library(csrc):
    first = build.library_path("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")
    assert build.library_path("k") == first
    # rewriting a file with the same bytes changes nothing
    (csrc / "a.cuh").write_text((csrc / "a.cuh").read_text())
    assert build.library_path("k") == first


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_the_source_or_an_included_header_changes_the_library(csrc, edited):
    before = build.library_path("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert build.library_path("k") != before


def test_a_header_nobody_includes_does_not_count(csrc):
    before = build.library_path("k")
    (csrc / "unused.cuh").write_text("#define U 4\n")
    assert build.library_path("k") == before
    assert build.sources("k") == [csrc / "k.cu", csrc / "a.cuh", csrc / "b.cuh"]


def test_the_port_kernels_hash_their_shared_header():
    """Both attention kernels include csrc/attn_common.cuh."""
    for name in ("flash_attention", "paged_attention"):
        names = [p.name for p in build.sources(name)]
        assert names == [f"{name}.cu", "attn_common.cuh"]
    assert [p.name for p in build.sources("rg_lru")] == ["rg_lru.cu"]


PTXAS = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
         "ptxas info    : Used 40 registers, 0 bytes spill stores\n")


@pytest.fixture
def fake_nvcc(csrc, monkeypatch):
    """An ``nvcc`` stand-in: writes the ``-o`` file and prints a ptxas
    report. Records each call."""
    calls = []

    def run(cmd, capture_output, text):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return build.subprocess.CompletedProcess(cmd, 0, stdout="", stderr=PTXAS)

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build, "BUILD_LOG", {})
    return calls


def test_a_library_found_built_keeps_its_compiler_log(fake_nvcc):
    path, _ = build.build("k")
    assert len(fake_nvcc) == 1 and path == build.library_path("k") and path.exists()
    assert build.BUILD_LOG["k"] == PTXAS
    assert build.log_path(path).read_text() == PTXAS
    build.BUILD_LOG.clear()                 # a second process, same checkout
    again, secs = build.build("k")
    assert (again, secs) == (path, 0.0) and len(fake_nvcc) == 1
    assert build.BUILD_LOG["k"] == PTXAS


def test_a_cached_library_without_its_log_is_rebuilt(fake_nvcc):
    path = build.library_path("k")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"\x7fELF")            # built before logs were kept
    build.build("k")
    assert len(fake_nvcc) == 1 and build.BUILD_LOG["k"] == PTXAS
    assert sorted(p.name for p in path.parent.iterdir()) == \
        sorted([path.name, build.log_path(path).name])
