"""The kernel build cache (kernels/build.py) names each library by what
went into it: the source, every csrc/*.cuh header, and nvcc's flags. An
edited header must rebuild every library, since any source may include
it. Works on a copy of csrc/; no nvcc is run."""
import shutil

import pytest

from minimax_speech_torch.kernels import build, variants


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _paths():
    return {p.stem: build.library_path(p.stem)
            for p in sorted(build.CSRC.glob("*.cu"))}


def test_sources_and_headers_are_there(csrc):
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "flash_attention.cu", "splash_attention.cu"]
    assert [p.name for p in csrc.glob("*.cuh")] == ["attention_mma.cuh"]
    for p in csrc.glob("*.cu"):
        assert '#include "attention_mma.cuh"' in p.read_text()


def test_library_path_is_stable(csrc):
    before = _paths()
    assert _paths() == before
    assert len(set(before.values())) == len(before)
    for name, path in before.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


def test_edited_header_rebuilds_every_library(csrc):
    before = _paths()
    header = csrc / "attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[n] != before[n] for n in before)


def test_new_header_rebuilds_every_library(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[n] != before[n] for n in before)


def test_edited_source_rebuilds_only_its_library(csrc):
    before = _paths()
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_attention"] != before["flash_attention"]
    assert after["splash_attention"] == before["splash_attention"]


@pytest.mark.parametrize("name", list(variants.VARIANTS))
def test_kernel_variants_patch_the_sources(name, tmp_path):
    """kernels/variants.py's patterns are in the committed header, so each
    variant differs from the sources in the named change only."""
    out = variants.make_sources(name, build.CSRC, tmp_path / name)
    header = (out / variants.HEADER).read_text()
    committed = (build.CSRC / variants.HEADER).read_text()
    assert (header == committed) == (name == "committed")
    for src in build.CSRC.glob("*.cu"):
        assert (out / src.name).read_text() == src.read_text()


@pytest.mark.parametrize("chunk,left", [(1, -1), (50, 2), (0, -1)])
def test_warp_pairs_count_the_visible_mask(chunk, left):
    """kernels/variants.warp_pairs counts the mask's visible pairs, and
    the warp-granular tiles cover them."""
    import torch

    from minimax_speech_torch.kernels import splash
    lens = [77, 40]
    visible, computed = variants.warp_pairs(lens, 77, chunk, left)
    mask = splash.visible_mask(77, torch.tensor(lens), chunk, left)
    assert visible == int(mask.sum())
    assert visible <= computed <= 2 * 77 * 128
