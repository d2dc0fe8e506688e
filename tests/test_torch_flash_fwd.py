"""The flash forward's source contract and its tuning table, on the CPU.

The CUDA kernel of ``csrc/flash_attention.cu`` runs only on the card
(``chip_smoke.py`` phase 3 holds it to ``flash_attention_plain`` at every
head-dim pair, its ``--flash-ab`` times it against the parent's); its
function's parity with the JAX reference is in
``tests/test_torch_kernels.py``.  Here: what the sources may and may not
issue, that the per-head-dim tuning table covers every instance, that
``--flash-ab``'s rewrites of the source (its variants) still find what they
rewrite and that its clock64 build reads what the kernel sums, and the
wrapper's grid limits.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kf

ROOT = Path(__file__).resolve().parent.parent
FLASH_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_common.cuh",
                 "flash_sm90.cuh")


def _code(text: str) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _read(name: str) -> str:
    return (build.CSRC_DIR / name).read_text()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg() -> dict:
    """FLASH_FWD_CFG's entries: q/k head dim -> (key tile, stages, blocks
    an SM)."""
    m = re.search(r"#define FLASH_FWD_CFG\(X\)(.*?)\n\n", _read(kf.SOURCE), re.S)
    assert m, "no FLASH_FWD_CFG table"
    rows = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", m.group(1))
    return {int(r[0]): tuple(int(x) for x in r[1:]) for r in rows}


def test_fwd_source_is_the_hopper_design():
    """The forward's products are wgmma (Q K^T from shared memory, P V with
    P in registers) on tiles that TMA loads through mbarriers; no mma.sync
    product, ldmatrix load or cp.async copy is left."""
    code = _code(_read(kf.SOURCE))
    header = _code(_read("flash_sm90.cuh"))
    assert '#include "flash_sm90.cuh"' in code
    for call in ("wgmma_ss<BK>(", "wgmma_rs<HDV>(", "load_tile<HD, BK>(",
                 "load_tile<HDV, BK>(", "load_tile<HD, BQ>(", "mbar_wait(",
                 "mbar_expect_tx(", "encode_map<", "__grid_constant__"):
        assert call in code, call
    for name in ("mma_bf16(", "ldsm_x4", "cp_async16", "cp_async4", "cp_async_wait"):
        assert name not in code, name
    # the tile loader the forward calls is a TMA tensor copy
    loader = header[header.index("void load_tile("):]
    assert "tma_load_4d(" in loader[:loader.index("}")]


@pytest.mark.parametrize("name", FLASH_SOURCES)
def test_flash_sources_have_no_ampere_copies_or_products(name):
    """No flash source issues mma.sync, ldmatrix or a non-bulk cp.async
    (cp.async.cg / .ca); cp.async.bulk is TMA and stays."""
    code = _code(_read(name))
    assert "mma.sync" not in code and "ldmatrix" not in code
    assert not re.search(r"cp\.async\.(cg|ca)\b", code)
    assert "cp_async16" not in code and "cp_async4" not in code
    for helper in ("mma_bf16", "ldsm_x4", "cp_async_commit"):
        assert f"void {helper}" not in code, helper


def test_fwd_source_issues_no_atomics():
    """Two launches of the forward are bitwise equal only if no result
    depends on the order threads or blocks run in: no atomic of any kind
    (the tile flags are one plain byte store each), no PTX red, no bulk
    reduce, outside the clock64 probes of a -DFLASH_CLOCKS build."""
    code = re.sub(r"#ifdef FLASH_CLOCKS\n.*?#endif", "", _code(_read(kf.SOURCE)),
                  flags=re.S)
    assert "atomic" not in code
    assert not re.search(r"(?<![\w.])red\.", code)
    assert "cp.reduce.async.bulk" not in code


def test_fwd_tuning_table_covers_every_instance():
    """FLASH_FWD_CFG has one entry per q/k head dim of HEAD_DIM_PAIRS, each
    a shape the kernel takes: a key tile of 32 or 64 (a whole number of
    warps, one wgmma of scores), at least two stages, and blocks of 160
    threads (a consumer warpgroup and a producer warp) that 1,024 threads
    hold."""
    cfg = _cfg()
    assert sorted(cfg) == sorted({hd for hd, _ in kf.HEAD_DIM_PAIRS})
    for hd, (bk, stages, blocks) in cfg.items():
        assert bk in (32, 64), hd
        assert stages >= 2, hd
        assert 1 <= blocks and blocks * 160 <= 1024, hd


def test_fwd_instances_match_the_wrapper():
    """The C entry points dispatch exactly HEAD_DIM_PAIRS, serving and LSE."""
    code = _code(_read(kf.SOURCE))
    m = re.search(r"#define FLASH_INSTANCES\(X\)([^\n]*)", code)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", m.group(1)))
    assert pairs == kf.HEAD_DIM_PAIRS
    assert "launch<D, DV, false>" in code and "launch<D, DV, true>" in code


def test_flash_ab_variants_rewrite_the_table():
    """Each ``--flash-ab`` variant replaces exactly its head dims' entries
    of FLASH_FWD_CFG and leaves the others as shipped."""
    cs = _chip_smoke()
    text = _read(kf.SOURCE)
    shipped = _cfg()
    for name, variant in cs.FLASH_VARIANTS.items():
        out = cs.flash_variant_source(text, variant)
        m = re.search(r"#define FLASH_FWD_CFG\(X\)(.*?)\n\n", out, re.S)
        rows = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", m.group(1))
        got = {int(r[0]): tuple(int(x) for x in r[1:]) for r in rows}
        assert got == {**shipped, **variant}, name
        assert out.replace(m.group(1), "") == text.replace(
            re.search(r"#define FLASH_FWD_CFG\(X\)(.*?)\n\n", text, re.S).group(1), "")


def test_flash_clocks_build_matches_the_reader():
    """``--flash-ab``'s clock64 copy is this source built with
    -DFLASH_CLOCKS: the probes sum one slot per name of CLOCK_SLOTS, and
    then the kv loop's and all cycles, which ``repro_flash_clocks`` copies
    out; the shipped build has no clock64 at all."""
    cs = _chip_smoke()
    code = _code(_read(kf.SOURCE))
    m = re.search(r"constexpr int CLOCK_SLOTS = (\d+);", code)
    assert m and int(m.group(1)) == len(cs.CLOCK_SLOTS)
    assert "flash_clk[CLOCK_SLOTS + 2]" in code
    blocks = re.findall(r"#ifdef FLASH_CLOCKS\n(.*?)#endif", code, flags=re.S)
    assert any('extern "C" int repro_flash_clocks(' in b for b in blocks)
    # outside the macro's blocks, clock64 is only ever inside CLOCKED(...)
    rest = re.sub(r"#ifdef FLASH_CLOCKS\n.*?#endif", "", code, flags=re.S)
    rest = re.sub(r"CLOCKED\((?:[^()]|\([^()]*\))*\)", "", rest)
    assert "clock64" not in rest


def test_fwd_grid_guard_checks_query_tiles():
    """The forward's grid is (B*H, query tiles of 64): B*H may pass 65,535
    (the x dimension), the query tiles may not (the y dimension)."""
    kf._check_fwd_grid(kf.MAX_GRID_Y * kf.FWD_TILE)
    with pytest.raises(ValueError, match="query tiles"):
        kf._check_fwd_grid(kf.MAX_GRID_Y * kf.FWD_TILE + 1)


def test_bwd_grid_guard_checks_heads():
    """The backward's dQ grid puts B*H on y: at most 65,535."""
    kf._check_bwd_grid(1, kf.MAX_GRID_Y)
    with pytest.raises(ValueError, match="B\\*H"):
        kf._check_bwd_grid(2, kf.MAX_GRID_Y // 2 + 1)
