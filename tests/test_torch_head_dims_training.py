"""Head dims outside {64, 128, 256} in the port's training path and packed
batches against the JAX package, on the CPU.

The backward kernels B13a / B13b and the packed-batch kernel B12 take every
head dim that is a multiple of 8 from 8 to 256, each run on the card in the
layout of the next of 64, 128 and 256 (`_build.padded_head_dim`). Here the
plain versions, which those kernels are held to on the card, are held to
the JAX kernels in interpret mode (which pad D to 128 lanes):

  * the recompute backward at D 24, 40, 96 and 136 (causal, windowed, GQA,
    Sq != Skv), each side fed the o and lse of its own forward: atol 2e-5
    / rtol 1e-4, as tests/test_torch_autodiff.py (fp32 sums in other
    orders);
  * packed attention at D 24, 40 and 96: atol 1e-5, as
    tests/test_torch_head_dims.py;
  * every parameter's gradient of the tiny 2-layer Llama of head dim 24
    (4 / 4 heads) of tests/test_torch_head_dims.py, with JAX's weights
    (`params_from_jax`), against `jax.grad` through the JAX forward on its
    Pallas kernels, at GRAD_TOL (the JAX package's tolerance for its Pallas
    backward).

B13a's block of keys and its split plan follow the layout, not d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import flash_varlen as jax_varlen
from flash_attention_cute_tpu.ops.flash_bwd import flash_attention_bwd as jax_bwd
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu_torch import flash_attention_varlen
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.ops import flash_bwd, flash_fwd

GRAD_TOL = dict(atol=5e-4, rtol=5e-3)

BACKWARD = {
    # name: (d, hq, hkv, sq, skv, causal, window)
    "d24_causal_gqa": (24, 4, 2, 96, 96, True, None),
    "d40_window": (40, 2, 2, 130, 130, True, 32),
    "d96_sq_lt_skv_gqa": (96, 4, 1, 64, 160, True, None),
    "d136_sq_gt_skv_window": (136, 4, 2, 160, 96, True, 40),
}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("case", list(BACKWARD), ids=list(BACKWARD))
def test_plain_backward_matches_jax_backward(case):
    d, hq, hkv, sq, skv, causal, window = BACKWARD[case]
    rng = np.random.default_rng(d)
    q, k, v = normal(rng, 1, hq, sq, d), normal(rng, 1, hkv, skv, d), normal(rng, 1, hkv, skv, d)
    do = normal(rng, 1, hq, sq, d)
    j_q, j_k, j_v, j_do = map(jnp.asarray, (q, k, v, do))
    j_o, j_lse = jax_fwd(j_q, j_k, j_v, causal=causal, window=window, return_lse=True,
                         interpret=True)
    want = jax_bwd(j_q, j_k, j_v, j_o, j_do, j_lse, causal=causal, window=window,
                   interpret=True)
    t_q, t_k, t_v, t_do = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_fwd.flash_attention_fwd(t_q, t_k, t_v, causal=causal, window=window,
                                           return_lse=True)
    got = flash_bwd.flash_attention_bwd(t_q, t_k, t_v, o, t_do, lse, causal=causal,
                                        window=window)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)
    if sq > skv:  # rows with no key
        assert (got[0][:, :, : sq - skv] == 0).all()


VARLEN = {
    # name: (d, q lengths, kv lengths (None: q's), hq, hkv, causal, window)
    "d24_causal_gqa": (24, [50, 1, 77], None, 4, 2, True, None),
    "d40_cross_window": (40, [24, 60], [40, 30], 2, 2, True, 16),
    "d96_full_gqa": (96, [33, 50, 7], None, 4, 1, False, None),
}


@pytest.mark.parametrize("case", list(VARLEN), ids=list(VARLEN))
def test_varlen_plain_matches_jax_kernel(case):
    d, lens_q, lens_kv, hq, hkv, causal, window = VARLEN[case]
    lens_kv = lens_kv or lens_q
    rng = np.random.default_rng(100 + d)
    q, k, v = normal(rng, sum(lens_q), hq, d), normal(rng, sum(lens_kv), hkv, d), \
        normal(rng, sum(lens_kv), hkv, d)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_kv = np.concatenate([[0], np.cumsum(lens_kv)]).astype(np.int32)
    want = jax_varlen.flash_attention_varlen(
        *map(jnp.asarray, (q, k, v, cu_q, cu_kv)), causal=causal, window=window, block_q=128,
        block_kv=128, interpret=True)
    got = flash_attention_varlen(*map(torch.from_numpy, (q, k, v, cu_q, cu_kv)), causal=causal,
                                 window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_model_grads_at_d24_match_jax_grad():
    """loss.backward() through a 2-layer Llama of head dim 24 against
    jax.grad through the JAX forward on its Pallas kernels, every leaf."""
    shape = dict(num_layers=2, head_dim=24, num_q_heads=4, num_kv_heads=4)
    jcfg = jax_tiny(dtype=jnp.float32, **shape)
    cfg = tiny_test_config(**shape)
    jparams = jax_init(jcfg, jax.random.key(5))  # tests/test_torch_head_dims.py's model
    ids = np.random.default_rng(25).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)

    def loss_jax(p):
        logits, _ = jax_forward(p, jcfg, jnp.asarray(ids), mode="prefill", interpret=True)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], axis=-1))

    want = jax.tree.leaves(jax.grad(loss_jax)(jparams))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = jax.tree.leaves(params)
    for x in leaves:
        x.requires_grad_()
    t_ids = torch.from_numpy(ids).long()
    logits, _ = forward(params, cfg, t_ids)
    torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1),
                                      t_ids[:, 1:].flatten()).backward()
    assert len(leaves) == len(want) and params["layers"]["q_proj"].shape[-1] == 4 * 24
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("d, block", [(8, 128), (96, 128), (128, 128), (136, 64), (200, 64),
                                      (256, 64)])
def test_key_block_and_splits_follow_the_layout(d, block):
    """A d of 136-248 runs D 256's 64-key B13a blocks, a d up to 128 the
    128-key ones, and the split plan follows: the same as at the layout's
    own head dim."""
    layout = 64 if d <= 64 else 128 if d <= 128 else 256
    assert flash_bwd.key_block(d) == block == flash_bwd.key_block(layout)
    for shape in ((1, 8, 4, 1024, 1024), (1, 4, 1, 300, 300), (1, 32, 1, 2040, 2040),
                  (2, 32, 1, 2040, 2040)):
        assert flash_bwd.dkv_splits(*shape, head_dim=d) == flash_bwd.dkv_splits(
            *shape, head_dim=layout)


@pytest.mark.parametrize("d", [100, 264, 4])
def test_key_block_refuses_what_no_layout_takes(d):
    """d 100 and 4, refused before the pitched rows, now take the 128-key
    blocks of their layouts (D 128, D 64); d 264, refused before the wide
    layout of 512, takes its 64-key blocks, and 520 stays refused."""
    if d <= 256:
        assert flash_bwd.key_block(d) == 128
        return
    assert flash_bwd.key_block(d) == 64
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        flash_bwd.key_block(520)
