"""Head dims from 257 to 512 in the attention backward (B13a / B13b) and in
the autograd op `ops.autodiff.flash_attention`, against the JAX package, on
the CPU.

On the card B13a / B13b run a d from 257 to 512 in the layout of 512
(csrc/flash_bwd.cu: B13a two blocks a 64-key block, 256 of dK's and dV's
columns each, over 32-row q tiles; B13b 64 q rows over 16-key tiles, its
two consumers splitting the depth of S and dP), rows at
`_build.row_pitch(d)` (d 260 at a pitch of 264); above 512 they, and the
autograd op, refuse before any launch, naming ROADMAP.md A14. The API and
the model path keep JAX's own refusal above 256. Here the plain versions,
which the kernels are held to on the card, are held to the JAX kernels in
interpret mode (whose wrapper pads D to a multiple of 128 lanes), in fp32,
at the tolerances of tests/test_torch_head_dims_training.py:

  * the recompute backward at d 260, 320 and 512, each side fed the o and
    lse of its own forward: causal GQA 8 / 1 with Sq < Skv, a window of
    40, and Sq > Skv (the rows of no key give zero dq); atol 2e-5 / rtol
    1e-4 (fp32 sums in other orders);
  * gradients through `ops.autodiff.flash_attention` against `jax.grad`
    through JAX's `ops.autodiff.flash_attention(..., interpret=True)` at d
    320 and 512, causal and windowed, at GRAD_TOL (the JAX package's
    tolerance for its Pallas backward). Standard normal inputs keep the
    scores inside the envelope of JAX's lazy softmax (ROADMAP.md C, "To
    watch");
  * the B13a plan of the layout (`key_block`, `q_tile`, `dkv_splits`) and
    the routing on the `meta` device: d 264 and 512 reach the kernels'
    CUDA-tensor check, 520 is refused naming ROADMAP.md A14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops.autodiff import flash_attention as jax_flash_attention
from flash_attention_cute_tpu.ops.flash_bwd import flash_attention_bwd as jax_bwd
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.ops import autodiff, flash_bwd, flash_fwd

GRAD_TOL = dict(atol=5e-4, rtol=5e-3)

BACKWARD = {
    # name: (hq, hkv, sq, skv, causal, window)
    "causal_gqa8_sq_lt_skv": (8, 1, 48, 96, True, None),
    "window40": (2, 2, 130, 130, True, 40),
    "sq_gt_skv_rows_of_no_key": (4, 2, 96, 64, True, None),
}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("d", [260, 320, 512])
@pytest.mark.parametrize("case", list(BACKWARD), ids=list(BACKWARD))
def test_plain_backward_matches_jax_backward(case, d):
    hq, hkv, sq, skv, causal, window = BACKWARD[case]
    rng = np.random.default_rng(d + sq)
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


GRAD_CASES = {
    # name: (hq, hkv, s, d, window)
    "d320_causal": (2, 2, 96, 320, None),
    "d320_window40": (2, 1, 130, 320, 40),
    "d512_causal_gqa": (4, 1, 96, 512, None),
    "d512_window40": (2, 2, 96, 512, 40),
}


@pytest.mark.parametrize("case", list(GRAD_CASES), ids=list(GRAD_CASES))
def test_op_grads_match_jax_grad(case):
    hq, hkv, s, d, window = GRAD_CASES[case]
    rng = np.random.default_rng(7 + d + s)
    q, k, v = normal(rng, 1, hq, s, d), normal(rng, 1, hkv, s, d), normal(rng, 1, hkv, s, d)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, None, True, window, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (autodiff.flash_attention(*leaves, causal=True, window=window) ** 2).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("d", [264, 512])
def test_key_block_and_splits_follow_the_wide_layout(d):
    """d 257-512 runs D 512's B13a: 64-key blocks over 32-row q tiles, two
    blocks a key block (256 columns each), which the split plan counts: the
    same plan as at D 512 itself."""
    assert flash_bwd.key_block(d) == 64 == flash_bwd.key_block(512)
    assert flash_bwd.q_tile(d) == 32 and flash_bwd.q_tile(256) == 64
    # DeepSeek-V4-Flash's 64 / 1 heads at S 4096: 64 key blocks x 2 = 128
    # blocks, more than half the SMs, so no split.
    assert flash_bwd.dkv_splits(1, 1, 64, 4096, 4096, head_dim=d) == 1
    for shape in ((1, 1, 8, 256, 256), (1, 2, 4, 1024, 1024), (1, 1, 64, 300, 300)):
        blocks = -(-shape[4] // 64) * 2 * shape[1] * shape[0]
        walk = shape[2] * -(-shape[3] // 32)
        want = max(1, min(flash_bwd.NUM_SMS // blocks, flash_bwd.MAX_SPLITS,
                          walk // flash_bwd.MIN_SPLIT_TILES))
        assert flash_bwd.dkv_splits(*shape, head_dim=d) == want == flash_bwd.dkv_splits(
            *shape, head_dim=512)


@pytest.mark.parametrize("d", [264, 512, 520])
def test_backward_and_autograd_op_route_wide_head_dims(d):
    """On the `meta` device no kernel runs: d 264 and 512 reach the
    kernels' CUDA-tensor check in the backward and in the autograd op's
    forward, 520 is refused naming ROADMAP.md A14 before any launch; the
    API keeps JAX's refusal above 256."""
    q = torch.empty(1, 4, 64, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 1, 64, d, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 4, 64, dtype=torch.float32, device="meta")
    calls = (lambda: flash_bwd.flash_attention_bwd(q, k, k, q, q, lse, causal=True),
             lambda: autodiff.flash_attention(q.requires_grad_(), k, k, causal=True))
    for call in calls:
        if d <= 512:
            with pytest.raises(ValueError, match="CUDA tensor"):
                call()
        else:
            with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
                call()
    with pytest.raises(ValueError, match=f"head_dim {d} > 256 unsupported"):
        api.flash_attn_func(q, k, k, causal=True)
