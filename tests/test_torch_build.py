"""The kernel build's library names (`lira_tpu_torch/kernels.py`): a
library is named by a hash of its `.cu` source and of the shared headers
of `csrc/`, so an edited source or header gives a new path and is rebuilt
instead of a stale library being loaded.  The path is computed before any
build, so these tests need no nvcc."""

import pytest

from lira_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "shared.cuh"\n__global__ void k() { f(); }\n')
    (src / "shared.cuh").write_text("__device__ inline void f() {}\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", src / "_build")
    return src


@pytest.mark.parametrize("edited", ["shared.cuh", "k.cu"])
def test_library_path_follows_source_and_headers(csrc, edited):
    before = kernels._lib_path("k")
    assert before.parent == csrc / "_build" and before.name.startswith("libk_")
    assert kernels._lib_path("k") == before  # the same sources, the same library
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = kernels._lib_path("k")
    assert after != before and after.parent == before.parent


def test_real_sources_have_distinct_library_paths():
    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    assert {"union_groupmin", "groupmin", "probed_scan"} <= set(names)
    assert list(kernels.CSRC.glob("*.cuh")), "the shared FMA mainloop header is missing"
    assert len({kernels._lib_path(n) for n in names}) == len(names)
