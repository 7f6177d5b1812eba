"""The port's packed ragged-batch attention (`flash_attention_varlen`,
`flash_attention_packed`, `_seg_metadata`) against the JAX package's, on
the CPU, over the cases of tests/test_flash_varlen.py.

Inputs are made with numpy seeds; JAX runs its Pallas kernel in interpret
mode (the default anchored lazy max, exact at these magnitudes), the port
its plain version (per-segment dense attention in fp32). Tolerance atol
2e-5 / rtol 2e-2, the JAX package's own against its per-sequence oracle;
rows with no visible key are exact zeros in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops import flash_varlen as jax_varlen
from flash_attention_cute_tpu_torch import flash_attention_varlen
from flash_attention_cute_tpu_torch.ops import flash_varlen

TOL = dict(atol=2e-5, rtol=2e-2)


def pack(seed, lens_q, lens_kv, hq, hkv, d, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((sum(lens_q), hq, d), np.float32) * scale
    k = rng.standard_normal((sum(lens_kv), hkv, d), np.float32) * scale
    v = rng.standard_normal((sum(lens_kv), hkv, d), np.float32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_kv = np.concatenate([[0], np.cumsum(lens_kv)]).astype(np.int32)
    return q, k, v, cu_q, cu_kv


CASES = {
    # name: (q lengths, kv lengths (None: q's), hq, hkv, causal, window, softcap, score scale)
    "equal_full": ([100, 37, 256, 1], None, 4, 2, False, None, None, 1.0),
    "equal_causal": ([100, 37, 256, 1], None, 4, 2, True, None, None, 1.0),
    "cross_bottom_right": ([64, 200, 32], [128, 100, 32], 4, 4, True, None, None, 1.0),
    "windowed": ([300, 80], None, 4, 2, True, 64, None, 1.0),
    "gqa_group4": ([130, 70, 456], None, 8, 2, True, None, None, 1.0),
    "single_sequence": ([256], None, 4, 4, True, None, None, 1.0),
    "unequal_kv_longer": ([16] * 8, [256] * 8, 4, 2, True, None, None, 1.0),
    "large_scores_x4": ([100, 37, 256, 90], None, 4, 2, True, None, None, 2.0),
    "logit_softcap": ([90, 40], None, 4, 2, True, None, 20.0, 1.0),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_varlen_matches_jax(case):
    lens_q, lens_kv, hq, hkv, causal, window, cap, scale = CASES[case]
    q, k, v, cu_q, cu_kv = pack(0, lens_q, lens_kv or lens_q, hq, hkv, 64, scale)
    kv_arg = None if lens_kv is None else cu_kv
    want = jax_varlen.flash_attention_varlen(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu_q),
        None if kv_arg is None else jnp.asarray(kv_arg), causal=causal, window=window,
        logit_softcap=cap, block_q=128, block_kv=128, interpret=True)
    got = flash_attention_varlen(
        *map(torch.from_numpy, (q, k, v, cu_q)),
        None if kv_arg is None else torch.from_numpy(kv_arg), causal=causal, window=window,
        logit_softcap=cap)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "cross_bottom_right":  # q longer than kv: the first 100 rows of seq 1 are 0
        assert (got[64:164] == 0).all()


# Gemma-2-9B's head dim and soft caps (its 50, and 1.0, which binds on every
# score), windowed and not, at Qwen2-7B's GQA group of 7 (14 / 2 heads):
# (q lengths, kv lengths (None: q's), causal, window, cap).
D256_CASES = {
    "causal_cap50": ([40, 1, 70], None, True, None, 50.0),
    "causal_cap1_window16": ([40, 1, 70], None, True, 16, 1.0),
    "cross_cap50_window16": ([24, 60], [40, 30], True, 16, 50.0),
    "full_cap1": ([33, 50], None, False, None, 1.0),
}


@pytest.mark.parametrize("case", list(D256_CASES), ids=list(D256_CASES))
def test_varlen_plain_at_d256_with_cap_matches_jax_kernel(case):
    """B12's plain version at D 256 with the caps and windows, GQA group 7,
    against the JAX kernel in interpret mode at atol 1e-5 (fp32 sums in
    another order); rows with no visible key exact zeros in both."""
    lens_q, lens_kv, causal, window, cap = D256_CASES[case]
    q, k, v, cu_q, cu_kv = pack(4, lens_q, lens_kv or lens_q, 14, 2, 256)
    kv_arg = None if lens_kv is None else cu_kv
    want = jax_varlen.flash_attention_varlen(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu_q),
        None if kv_arg is None else jnp.asarray(kv_arg), causal=causal, window=window,
        logit_softcap=cap, block_q=128, block_kv=128, interpret=True)
    got = flash_attention_varlen(
        *map(torch.from_numpy, (q, k, v, cu_q)),
        None if kv_arg is None else torch.from_numpy(kv_arg), causal=causal, window=window,
        logit_softcap=cap)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if case == "cross_cap50_window16":  # q longer than kv: seq 1's first 30 rows are 0
        assert (got[24:54] == 0).all()


def test_packed_core_and_metadata_match_jax():
    """`_seg_metadata` equals JAX's; the packed core with the front end's
    metadata (and with windowed, non-causal masking) equals JAX's."""
    lens = [50, 1, 77]
    q, k, v, cu, _ = pack(1, lens, lens, 4, 2, 32)
    seg, pos = flash_varlen._seg_metadata(torch.from_numpy(cu), sum(lens))
    j_seg, j_pos = jax_varlen._seg_metadata(jnp.asarray(cu), sum(lens))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(j_seg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    for causal, window in ((True, None), (False, 16)):
        args = [x.transpose(1, 0, 2).copy() for x in (q, k, v)]
        want = jax_varlen.flash_attention_packed(
            *map(jnp.asarray, args), jnp.asarray(seg.numpy()), jnp.asarray(seg.numpy()),
            q_bounds=jnp.asarray(pos.numpy()), kv_positions=jnp.asarray(pos.numpy()),
            causal=causal, window=window, block_q=128, block_kv=128, interpret=True)
        got = flash_varlen.flash_attention_packed(
            *map(torch.from_numpy, args), seg, seg, q_bounds=pos, kv_positions=pos,
            causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="q_bounds"):
        flash_varlen.flash_attention_packed(*map(torch.from_numpy, args), seg, seg, causal=True)
