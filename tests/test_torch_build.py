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
# step (K4, K5 and K6)
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
    """K1, K2 and K4-K6 build their lists of nonzero counts with the one
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


def _gat_dedup_source():
    with open(gat_dedup.SOURCE, encoding="utf-8") as fh:
        return fh.read()


def _body(text, name):
    """The text of the first definition of ``name(`` that has a body:
    from its opening brace to the matching closing one."""
    for found in re.finditer(rf"\b{name}\(", text):
        start = text.index("{", found.end())
        if ";" in text[found.end():start]:
            continue                      # a call, not a definition
        depth = 0
        for i in range(start, len(text)):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                return text[start:i + 1]
    raise AssertionError(f"no definition of {name}")


@pytest.mark.parametrize("name", ["atomicAdd", "atomicMax", "sddmm_rowsum",
                                  "fma_chunk", "stage_rows", "SDDMM_SMEM"])
def test_gat_dedup_has_no_dense_blocks_or_atomics(name):
    """K4, K5 and K6 walk the nonzero counts and store every output
    element once: no atomics, none of the dense-block helpers."""
    assert name not in _gat_dedup_source()


@pytest.mark.parametrize("kernel", ["gat_fwd_kernel", "gat_bwd_b1_kernel",
                                    "gat_bwd_b2_kernel"])
def test_gat_dedup_kernels_walk_the_lists(kernel):
    """Each of K4, K5 and K6 walks its rows through the one row walk of
    ``gat_dedup.cu``, whose counts come from ``count_block.cuh``'s
    ``load_counts`` and ``list_nonzero``."""
    text = _gat_dedup_source()
    walk = _body(text, "walk_row")
    assert "count_block::list_nonzero(" in walk
    assert "count_block::load_counts<" in walk
    assert text.count("count_block::list_nonzero(") == 1
    assert "walk_row(" in _body(text, kernel)


def _read(path):
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def _call(text, name):
    """The text of the first call ``name(...)`` in ``text``: from its
    opening parenthesis to the matching closing one."""
    start = text.index(f"{name}(") + len(name)
    depth = 0
    for i in range(start, len(text)):
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"no call of {name}")


@pytest.mark.parametrize("name", ["atomicAdd", "atomicMax"])
def test_gat_tiled_has_no_atomics(name):
    """K7-K9 and the walks they share store every output element once,
    without atomics."""
    text = _read(gat_tiled.SOURCE)
    header = _read(os.path.join(CSRC, "tiled_rows.cuh"))
    assert name not in text and name not in header


@pytest.mark.parametrize("kernel,source", [
    ("tiled_spmm_kernel", tiled_spmm.SOURCE),
    ("tiled_gat_fwd_kernel", gat_tiled.SOURCE),
    ("tiled_gat_b1_kernel", gat_tiled.SOURCE),
    ("tiled_gat_b2_kernel", gat_tiled.SOURCE)])
def test_v1_kernels_share_the_group_walk(kernel, source):
    """K3, K7, K8 and K9 walk their rows through the one group walk of
    ``tiled_rows.cuh``, which no longer defines the port's first walk
    (``gather_rows`` and its ``store_row``)."""
    header = _read(os.path.join(CSRC, "tiled_rows.cuh"))
    assert header.count("void walk_groups(") == 1
    assert "walk_groups<" in _body(_read(source), kernel)
    for name in ("gather_rows", "store_row"):
        assert re.search(rf"\b{name}\b", header) is None, name


@pytest.mark.parametrize("name", ["gather_rows", "store_row", "ACC", "FC",
                                  "vec_width", "Alpha", "warp_sum"])
def test_v1_sources_drop_the_first_walk(name):
    """What only K9's first walk used is gone from the v1 kernels'
    sources: the walk and its store, its accumulator and column counts,
    the host's vector width (K9 takes its plan from the host) and the
    weight functor; ``gat_dedup.cu`` keeps its own ``warp_sum``."""
    for path in (gat_tiled.SOURCE, tiled_spmm.SOURCE,
                 os.path.join(CSRC, "tiled_rows.cuh")):
        assert re.search(rf"\b{name}\b", _read(path)) is None, path


def test_b2_sums_dsrc_in_the_walk():
    """K9 gathers ds through ``pos_in_other`` inside its walk over the
    row's slots, on block column 0, and sums dsrc with one segment sum
    after it: no second loop over the row, no second read of its
    receivers."""
    body = _body(_read(gat_tiled.SOURCE), "tiled_gat_b2_kernel")
    walk = _call(body, "walk_groups<G, ROWS>")
    assert "__ldg(ds + __ldg(pos_in_other + e))" in walk
    assert "if (first && live)" in walk
    assert body.count("pos_in_other") == 1
    assert body.count("receivers") == 1      # in row_slots
    assert re.search(r"for \(int64_t", body) is None
    assert body.count("seg_sum<W>(part)") == 1
    assert body.index("walk_groups<") < body.index("seg_sum<W>(part)")
    assert "cols.fma(gs + (int64_t)sk * d, pk, acc)" in walk


def test_b1_keeps_g_r_in_registers():
    """K8 loads the row's G_r once per column chunk, before its walk over
    the row's slots, and the walk reads only z rows: no load of g per
    slot."""
    body = _body(_read(gat_tiled.SOURCE), "tiled_gat_b1_kernel")
    walk = _call(body, "walk_groups<G, ROWS>")
    assert body.index("cols.load(g + (int64_t)row * d + cols.base, gr)") < \
        body.index("walk_groups<")
    assert re.search(r"\bg\s*[+\[]", walk) is None
    assert "cols.dot(zs + (int64_t)sk * d, gr)" in walk
    assert "warp_sum(" not in body


def test_k1_instances_match_tile_sizes():
    """K1's source has one instance per tile size and slot count the
    wrapper accepts (``dedup_spmm.TILE_SIZES`` x ``dedup_spmm.CUS``) and
    refuses any other."""
    text = _read(dedup_spmm.SOURCE)
    launch = _body(text, "launch")
    shapes = sorted((int(tn), int(cu)) for tn, cu in re.findall(
        r"K1_SHAPE\((\d+), (\d+)\)", launch))
    assert shapes == sorted((tn, cu) for tn in dedup_spmm.TILE_SIZES
                            for cu in dedup_spmm.CUS)
    assert launch.index("return (int)cudaErrorInvalidValue;") > \
        launch.rindex("K1_SHAPE(")
