"""The kernel build's library names (singa_tpu_torch.ops._build): a library
is named by a hash of its source, of every ``csrc/`` header the source
includes (directly or through another header) and of the flags, so that
editing a shared header rebuilds each library that uses it and editing
an unrelated file rebuilds none.  No compiler is needed: the names are
computed from the files alone."""

import os

import pytest

from singa_tpu_torch.ops import _build

FILES = {
    "k.cu": '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n',
    "a.cuh": '#pragma once\n  #  include "sub/b.cuh"\nint a;\n',
    "sub/b.cuh": '#pragma once\nint b;\n',
    "c.cuh": '#pragma once\nint c;\n',
    "other.cu": '#include "c.cuh"\nint other;\n',
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for rel, text in FILES.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "SOURCES", {"k": "k.cu", "other": "other.cu"})
    return tmp_path


def test_inputs_follow_quoted_includes_transitively(csrc):
    assert _build._inputs("k") == ["k.cu", "a.cuh",
                                   os.path.join("sub", "b.cuh")]
    assert _build._inputs("other") == ["other.cu", "c.cuh"]


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True), ("a.cuh", True), ("sub/b.cuh", True),
    ("c.cuh", False), ("other.cu", False)])
def test_editing_a_file_renames_exactly_the_libraries_that_include_it(
        csrc, edited, rebuilds):
    before = _build._lib_path("k")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._lib_path("k") != before) == rebuilds
    assert os.path.dirname(_build._lib_path("k")) == _build.BUILD_DIR


def test_flash_kernels_hash_their_shared_tile_header():
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert "flash_mma.cuh" in _build._inputs(name)
