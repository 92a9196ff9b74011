"""The kernel libraries are named by the content of the files they are
compiled from, so a build left over from an older source is never
loaded.  CPU only: no ``nvcc`` is run."""

import os
import re
import shutil

import pytest

from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled, split_spmm,
                                tiled_spmm)

MODULES = {"K1": dedup_spmm, "K2": split_spmm, "K3": tiled_spmm,
           "K4-K6": gat_dedup, "K7-K9": gat_tiled}
# the kernels compiled with the count-block walk (K1, K2) or its list
# step (K6, in the K4-K6 library)
COUNT_BLOCK = {"K1", "K2", "K4-K6"}
CSRC = os.path.dirname(dedup_spmm.SOURCE)


def _copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(CSRC, dst)
    return dst


def _flip_byte(path, offset=-2):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x20
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_library_named_by_its_sources(name):
    source = MODULES[name].SOURCE
    stem = os.path.splitext(os.path.basename(source))[0]
    library = dedup_spmm.library_path(source)
    assert os.path.dirname(library) == dedup_spmm.BUILD_DIR
    assert re.fullmatch(rf"lib{stem}-[0-9a-f]{{12}}\.so",
                        os.path.basename(library))
    assert dedup_spmm.library_path(source) == library


@pytest.mark.parametrize("name", sorted(MODULES))
def test_header_edit_renames_only_its_users(tmp_path, name):
    """One byte of ``count_block.cuh`` changes the library names of K1,
    K2 and K4-K6 and no other kernel's."""
    library = dedup_spmm.library_path(MODULES[name].SOURCE)
    csrc = _copy_csrc(tmp_path)
    source = str(csrc / os.path.basename(MODULES[name].SOURCE))
    assert dedup_spmm.library_path(source) == library  # content only
    _flip_byte(csrc / "count_block.cuh")
    changed = dedup_spmm.library_path(source) != library
    assert changed == (name in COUNT_BLOCK)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_source_edit_renames_its_library(tmp_path, name):
    source = MODULES[name].SOURCE
    csrc = _copy_csrc(tmp_path)
    path = csrc / os.path.basename(source)
    _flip_byte(path)
    assert dedup_spmm.library_path(str(path)) != \
        dedup_spmm.library_path(source)


def test_launch_shape_matches_header():
    with open(os.path.join(CSRC, "count_block.cuh"), encoding="utf-8") as fh:
        text = fh.read()
    for name, value in (("FT", dedup_spmm.FEATURE_TILE),
                        ("WARPS", dedup_spmm.ROWS_PER_BLOCK)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value, name
    assert dedup_spmm.launch_grid(159, 256) == (1, 16, 159)
    assert dedup_spmm.launch_grid(7, 602, 64) == (3, 8, 7)


@pytest.mark.parametrize("name", ["K1", "K2", "K4-K6"])
def test_list_step_is_shared(name):
    """K1, K2 and K6 build their lists of nonzero counts with the one
    device function of ``count_block.cuh``; none keeps a copy of it."""
    with open(os.path.join(CSRC, "count_block.cuh"), encoding="utf-8") as fh:
        header = fh.read()
    assert header.count("int list_nonzero(") == 1
    sources = dedup_spmm._sources(MODULES[name].SOURCE)
    assert os.path.join(CSRC, "count_block.cuh") in sources
    with open(MODULES[name].SOURCE, encoding="utf-8") as fh:
        text = fh.read()
    assert "nonzero4(" not in text and "__shfl_up_sync" not in text
    if name == "K4-K6":
        assert "count_block::list_nonzero(" in text
    else:
        assert "count_block::tile_spmm<" in text
