"""The CUDA build's cache key, on the CPU (no nvcc): a library is named by a
hash of its source, every shared header in ``csrc/`` and the flags, so an
edit to any of them builds a new library instead of loading a stale one."""

import shutil

import pytest

from loongx_tpu_torch.ops import cuda_build


@pytest.fixture()
def csrc(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, out)
    return out


def test_every_source_has_a_stable_path(csrc):
    for name in cuda_build.SOURCES:
        path = cuda_build._lib_path(name, csrc)
        assert path == cuda_build._lib_path(name, csrc)
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        # the copy holds the same bytes as the package's sources
        assert path == cuda_build._lib_path(name)


def test_the_sources_include_the_hopper_header(csrc):
    for name in ("quant_matmul", "quant_matmul_t", "flash_attention"):
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", ["quant_matmul", "quant_matmul_t", "flash_attention"])
def test_header_edit_changes_the_library_path(csrc, name):
    before = cuda_build._lib_path(name, csrc)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build._lib_path(name, csrc) != before


def test_new_header_changes_the_library_path(csrc):
    before = cuda_build._lib_path("quant_matmul", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build._lib_path("quant_matmul", csrc) != before


def test_source_edit_changes_only_its_library(csrc):
    before = {n: cuda_build._lib_path(n, csrc) for n in cuda_build.SOURCES}
    src = csrc / "s4d_scan.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n, csrc) for n in cuda_build.SOURCES}
    assert after["s4d_scan"] != before["s4d_scan"]
    assert all(after[n] == before[n] for n in cuda_build.SOURCES
               if n != "s4d_scan")


def test_flags_are_in_the_key(csrc, monkeypatch):
    before = cuda_build._lib_path("quant_matmul", csrc)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-DEXTRA",))
    assert cuda_build._lib_path("quant_matmul", csrc) != before
