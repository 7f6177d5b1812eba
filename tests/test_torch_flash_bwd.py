"""The backward wrapper's arithmetic on the CPU: the split plan of B13a
(`dkv_splits`, pure Python, from the shapes alone; 128-key blocks at D 64 /
128, 64-key blocks at D 256) and the padded lse /
delta rows the kernels read by bulk copies (`padded_rows`). The kernels
themselves run only on the card (tests/test_torch_cuda_kernels.py); their
plain version is held to JAX's backward in tests/test_torch_autodiff.py."""

import math

import pytest
import torch

from flash_attention_cute_tpu_torch.ops import flash_bwd

PLAN = {
    # (batch, hkv, group, sq, skv): splits
    "llama_training_b2_s2048": ((2, 8, 4, 2048, 2048), 1),  # 256 blocks: two waves
    "d64_b2_s1024": ((2, 8, 4, 1024, 1024), 1),  # 128 blocks, over half the SMs
    "mistral_window_s5120": ((1, 8, 4, 5120, 5120), 1),
    "qwen2_28_4_s1024": ((1, 4, 7, 1024, 1024), 4),  # 32 blocks
    "short_s130": ((1, 8, 4, 130, 130), 3),  # 16 blocks; 12 tiles a walk
    "mqa_group32_s512": ((1, 1, 32, 512, 512), 8),  # capped at MAX_SPLITS
    "sq64_skv1000": ((1, 8, 4, 64, 1000), 1),  # a walk of 4 tiles: no finer
    "sq256_skv1024": ((1, 8, 4, 256, 1024), 2),
    "no_keys": ((1, 8, 4, 64, 0), 1),
}


@pytest.mark.parametrize("case", list(PLAN), ids=list(PLAN))
def test_dkv_splits(case):
    shape, want = PLAN[case]
    assert flash_bwd.dkv_splits(*shape) == want


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("hkv", [1, 8])
@pytest.mark.parametrize("group", [1, 7, 32])
@pytest.mark.parametrize("s", [64, 130, 2048])
def test_dkv_splits_bounds(batch, hkv, group, s):
    """Each part walks at least MIN_SPLIT_TILES q tiles of the longest walk
    (or there is one part), at most MAX_SPLITS parts, and the split grid
    stays within one block per SM."""
    splits = flash_bwd.dkv_splits(batch, hkv, group, s, s)
    blocks = -(-s // flash_bwd.KEY_BLOCK) * hkv * batch
    walk = group * -(-s // flash_bwd.Q_TILE)
    assert 1 <= splits <= flash_bwd.MAX_SPLITS
    if splits > 1:
        assert 2 * blocks <= flash_bwd.NUM_SMS
        assert splits * blocks <= flash_bwd.NUM_SMS
        assert walk // splits >= flash_bwd.MIN_SPLIT_TILES
    else:
        assert (2 * blocks > flash_bwd.NUM_SMS or flash_bwd.NUM_SMS // blocks == 1
                or walk < 2 * flash_bwd.MIN_SPLIT_TILES)


PLAN_D256 = {
    # (batch, hkv, group, sq, skv): splits of B13a at D 256 (blocks of 64 keys)
    "gemma2_training_b1_s4608": ((1, 8, 2, 4608, 4608), 1),  # 576 blocks
    "gemma7b_mha_s2048": ((1, 16, 1, 2048, 2048), 1),
    "mqa_group32_s1024": ((1, 1, 32, 1024, 1024), 8),  # 16 blocks
    "sq1024_skv256": ((1, 8, 2, 1024, 256), 4),  # 32 blocks, 32 tiles a walk
    "window_s300": ((1, 2, 2, 300, 300), 2),  # 10 blocks, 10 tiles a walk
    "no_keys": ((1, 8, 2, 64, 0), 1),
}


@pytest.mark.parametrize("case", list(PLAN_D256), ids=list(PLAN_D256))
def test_dkv_splits_d256(case):
    shape, want = PLAN_D256[case]
    assert flash_bwd.key_block(256) == flash_bwd.KEY_BLOCK_D256 == 64
    assert flash_bwd.dkv_splits(*shape, head_dim=256) == want
    # The same shapes plan with 128-key blocks below D 256.
    assert flash_bwd.dkv_splits(*shape, head_dim=128) == flash_bwd.dkv_splits(*shape)


@pytest.mark.parametrize("group", [1, 2, 32])
@pytest.mark.parametrize("s", [64, 300, 1024, 4608])
def test_dkv_splits_bounds_d256(group, s):
    """The bounds of test_dkv_splits_bounds with D 256's 64-key blocks."""
    splits = flash_bwd.dkv_splits(1, 8 if group < 32 else 1, group, s, s, head_dim=256)
    blocks = -(-s // 64) * (8 if group < 32 else 1)
    walk = group * -(-s // flash_bwd.Q_TILE)
    assert 1 <= splits <= flash_bwd.MAX_SPLITS
    if splits > 1:
        assert 2 * blocks <= flash_bwd.NUM_SMS and splits * blocks <= flash_bwd.NUM_SMS
        assert walk // splits >= flash_bwd.MIN_SPLIT_TILES
    else:
        assert (2 * blocks > flash_bwd.NUM_SMS or flash_bwd.NUM_SMS // blocks == 1
                or walk < 2 * flash_bwd.MIN_SPLIT_TILES)


@pytest.mark.parametrize("sq", [1, 63, 64, 127, 128, 130, 1000, 2048])
@pytest.mark.parametrize("fill", [math.inf, 0.0])
def test_padded_rows(sq, fill):
    x = torch.randn(2, 3, sq)
    got = flash_bwd.padded_rows(x, sq, fill)
    width = -(-sq // flash_bwd.ROW_PAD) * flash_bwd.ROW_PAD
    assert got.shape == (2, 3, width) and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got[..., :sq], x)
    assert bool((got[..., sq:] == fill).all())
    assert (got is x) == (sq == width)


def test_padded_rows_copies_what_the_kernels_cannot_read():
    """Another dtype, a strided view or a buffer of the wrong width is copied
    into a fresh padded buffer; an already padded buffer passes as it is."""
    base = torch.randn(2, 3, 256, dtype=torch.float64)
    strided = base.float().transpose(0, 1).contiguous().transpose(0, 1)
    for x in (base, base.float()[..., :130], strided):
        got = flash_bwd.padded_rows(x, x.shape[-1], math.inf)
        assert got is not x and got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got[..., : x.shape[-1]], x.float())
    padded = flash_bwd.padded_rows(base.float()[..., :130], 130, math.inf)
    assert flash_bwd.padded_rows(padded, 130, math.inf) is padded


def test_cpu_route_is_the_plain_version():
    """A CPU tensor takes the plain backward, whatever the plan would say."""
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn(1, 7, 130, 16, generator=gen) for _ in "ab")
    k, v = (torch.randn(1, 1, 130, 16, generator=gen) for _ in "ab")
    o = torch.randn(1, 7, 130, 16, generator=gen)
    lse = torch.randn(1, 7, 130, generator=gen) + 8.0
    got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=40)
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True, window=40)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
