"""The flash backward's host-side plan and source contract, on the CPU.

The CUDA kernels of ``csrc/flash_attention_bwd.cu`` run only on the card
(``chip_smoke.py`` phase 13 holds them to ``flash_attention_bwd_plain``);
their function's parity with the JAX reference is in
``tests/test_torch_kernels.py``.  Here: the rule that sizes the dK/dV
launch's thread-block cluster, the way a key tile's items are dealt to the
cluster's blocks, and what the source may and may not issue.
"""

import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kf

H100_SMS = 132

# (B, KV, Sk, G, Sq, hd, causal: a block takes two key tiles) -> the
# cluster size on 132 SMs: qwen2-1.5b's diffusion batch and causal AR
# prefill, hymba-1.5b's 2 x 1280, paligemma-3b's 8 x 256 (MQA, G 8) and
# deepseek-v2-lite's MLA 8 x 256 (H = KV = 16, causal: 256 blocks, past one
# wave already), and the shapes of chip_smoke.py's backward cases
CLUSTER_CASES = {
    "qwen2 8x256": ((8, 2, 256, 6, 256, 128, False), 2),
    "qwen2 8x512 causal": ((8, 2, 512, 6, 512, 128, True), 2),
    "hymba 2x1280": ((2, 5, 1280, 5, 1280, 64, True), 1),
    "ragged S 200": ((2, 2, 200, 6, 200, 128, True), 8),
    "fully masked row": ((2, 2, 96, 2, 64, 64, False), 2),
    "queries offset, window": ((2, 6, 300, 1, 70, 128, True), 2),
    "softcap hd32": ((2, 1, 130, 6, 100, 32, False), 8),
    "paligemma 8x256": ((8, 1, 256, 8, 256, 256, False), 4),
    "MLA 8x256 causal": ((8, 16, 256, 1, 256, 192, True), 1),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_bwd_cluster_size_at_path_and_smoke_shapes(case):
    *shape, pair = CLUSTER_CASES[case][0]
    assert kf.bwd_cluster_size(*shape, H100_SMS, pair) == CLUSTER_CASES[case][1]


SHAPES = [(b, kvh, s, g, s, hd)
          for b in (1, 2, 8) for kvh in (1, 2, 5) for s in (1, 63, 64, 200, 1280)
          for g in (1, 6) for hd in (32, 64, 128)]


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_bwd_cluster_size_bounds(sms, pair):
    """C is a power of two of at most 8 and of at most the key tile's item
    count; past 1 it keeps the launch to one wave of blocks (a block per
    key tile, or per two with ``pair``), and it stops growing only at one
    of those limits."""
    for b, kvh, sk, g, sq, hd in SHAPES:
        c = kf.bwd_cluster_size(b, kvh, sk, g, sq, hd, sms, pair)
        nk = -(-sk // kf.BWD_TILE)
        blocks = b * kvh * (-(-nk // 2) if pair else nk)
        items = g * -(-sq // kf.BWD_TILE)
        assert c in (1, 2, 4, 8) and c <= kf.BWD_MAX_CLUSTER
        assert c == 1 or (c <= items and blocks * c <= sms)
        assert 2 * c > kf.BWD_MAX_CLUSTER or 2 * c > items or blocks * 2 * c > sms


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n_items", [0, 1, 5, 8, 24, 48, 100])
def test_bwd_rank_items_deal_every_item_once(cluster, n_items):
    """The ranks of a cluster take disjoint items whose union is the key
    tile's whole list, so the rank-order sum of their partials is dK / dV."""
    dealt = [i for r in range(cluster) for i in kf.bwd_rank_items(r, cluster, n_items)]
    assert sorted(dealt) == list(range(n_items))
    sizes = [len(kf.bwd_rank_items(r, cluster, n_items)) for r in range(cluster)]
    assert max(sizes) - min(sizes) <= 1


def test_bwd_cluster_size_refuses_head_dims_without_an_instance():
    """Every pair of the forward has a backward instance, MLA's (192, 128)
    and paligemma's (256, 256) among them; head dims of no pair, or a value
    head dim that is not its pair's, are refused."""
    for hd, hd_v in kf.HEAD_DIM_PAIRS:
        assert kf.bwd_cluster_size(1, 1, 64, 1, 64, hd, H100_SMS, hd_v=hd_v) == 1
        assert kf.bwd_cluster_size(1, 1, 64, 1, 64, hd, H100_SMS) == 1
    for hd in (16, 96):
        with pytest.raises(ValueError, match="no instance"):
            kf.bwd_cluster_size(1, 1, 64, 1, 64, hd, H100_SMS)
    with pytest.raises(ValueError, match="no instance"):
        kf.bwd_cluster_size(1, 1, 64, 1, 64, 192, H100_SMS, hd_v=192)


def _source() -> str:
    return (build.CSRC_DIR / kf.BWD_SOURCE).read_text()


def _code(text: str) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_bwd_source_issues_no_float_atomics():
    """Two runs of the backward are bitwise equal only if no sum depends on
    the order blocks run in: no atomicAdd, no PTX red, no bulk reduce."""
    code = _code(_source()) + _code((build.CSRC_DIR / "flash_sm90.cuh").read_text())
    assert "atomicAdd" not in code
    assert not re.search(r"(?<![\w.])red\.", code)
    assert "cp.reduce.async.bulk" not in code


def test_bwd_source_is_the_hopper_design():
    """Every product is a wgmma fed from TMA through mbarriers; no mma.sync
    product or ldmatrix load is left in the backward."""
    code = _code(_source())
    header = _code((build.CSRC_DIR / "flash_sm90.cuh").read_text())
    assert '#include "flash_sm90.cuh"' in code
    assert "mma_bf16(" not in code and "ldsm_x4" not in code
    assert "cp_async16" not in code and "cp_async4" not in code
    # its tiles come through load_tile, flash_sm90.cuh's TMA tensor copy,
    # which the forward shares
    for call in ("wgmma_ss_n64(", "wgmma_rs<HD>(", "load_tile<HD>(", "bulk_load(",
                 "mbar_wait(", "cluster_sync()", "ld_cluster_f4("):
        assert call in code, call
    assert "tma_load_4d(" in header[header.index("void load_tile("):]
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.4d", "mbarrier.try_wait",
                "barrier.cluster", "ld.shared::cluster"):
        assert ptx in header, ptx
    assert "mma.sync" not in header
