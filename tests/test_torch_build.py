"""repro_torch's kernel build: the cached library's name hashes every file
that goes into it, so an edited header rebuilds as an edited source does.
Works on a copy of ``csrc`` and calls no compiler."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _paths():
    return {name: build.lib_path(name) for name in build.SOURCES}


def test_every_source_includes_the_shared_hopper_header(csrc):
    for name in build.SOURCES:
        found = build._sources_of(csrc / f"{name}.cu", [])
        assert csrc / "hopper.cuh" in found, name


@pytest.mark.parametrize("name", build.SOURCES)
def test_lib_path_changes_when_an_included_header_changes(csrc, name):
    before = _paths()
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert after[name] != before[name]


@pytest.mark.parametrize("name", build.SOURCES)
def test_lib_path_changes_only_for_the_edited_source(csrc, name):
    before = _paths()
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert {n for n in before if before[n] != after[n]} == {name}


def test_lib_path_ignores_headers_no_source_includes(csrc):
    before = _paths()
    (csrc / "unused.cuh").write_text("#pragma once\n")
    assert _paths() == before


def test_lib_path_follows_nested_includes(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n// one\n")
    header = csrc / "hopper.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    before = _paths()
    (csrc / "inner.cuh").write_text("#pragma once\n// two\n")
    after = _paths()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_lib_path_is_stable_and_names_the_source(csrc):
    first, second = _paths(), _paths()
    assert first == second
    for name, path in first.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
