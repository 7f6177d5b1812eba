"""The port's training path against the JAX package, on the CPU: the lse of
the prefill forward, the recompute backward, the autograd op and gradients
through the whole model.

Inputs are made with numpy seeds and cross as numpy arrays; JAX runs its
Pallas kernels in interpret mode. On CPU tensors the port's wrappers run
their plain versions (fp32), so every comparison is fp32 against fp32:
  * lse (log2 units): atol 1e-4, and the +inf rows identical;
  * the backward on identical (q, k, v, o, dO, lse): atol 2e-5 / rtol 1e-4
    (fp32 sums in other orders);
  * gradients through the op and the model: atol 5e-4 / rtol 5e-3, the
    JAX package's own tolerance for its Pallas backward
    (tests/test_autodiff.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops.autodiff import flash_attention as jax_flash_attention
from flash_attention_cute_tpu.ops.flash_bwd import flash_attention_bwd as jax_bwd
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.ops import autodiff
from flash_attention_cute_tpu_torch.ops.flash_bwd import flash_attention_bwd_plain
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd

GRAD_TOL = dict(atol=5e-4, rtol=5e-3)


def make(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


LSE_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, window)
    "causal": (1, 2, 2, 160, 160, 32, True, None),
    "window": (1, 4, 2, 200, 200, 32, True, 48),
    "sq_lt_skv": (1, 2, 2, 96, 256, 32, True, None),
    "sq_gt_skv_inf_rows": (1, 2, 2, 160, 96, 32, True, None),
    "gqa_full": (2, 8, 2, 128, 128, 64, False, None),
}


@pytest.mark.parametrize("case", list(LSE_CASES), ids=list(LSE_CASES))
def test_plain_lse_matches_jax(case):
    b, hq, hkv, sq, skv, d, causal, window = LSE_CASES[case]
    q, k, v = make(0, b, hq, hkv, sq, skv, d)
    j_out, j_lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           window=window, return_lse=True, interpret=True)
    out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                   window=window, return_lse=True)
    j_lse = np.asarray(j_lse)
    assert lse.dtype == torch.float32 and lse.shape == j_lse.shape
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5, rtol=1e-4)
    if sq > skv:
        assert np.isinf(lse.numpy()[:, :, : sq - skv]).all()


@pytest.mark.parametrize("lse_from", ["jax", "port"])
@pytest.mark.parametrize("case", ["window", "sq_gt_skv_inf_rows", "gqa_full"])
def test_plain_backward_matches_jax_backward(case, lse_from):
    """Identical (q, k, v, o, dO, lse) into both backwards; the lse comes
    from either package's forward, so each feeds the other's backward."""
    b, hq, hkv, sq, skv, d, causal, window = LSE_CASES[case]
    q, k, v = make(1, b, hq, hkv, sq, skv, d)
    do = np.random.default_rng(2).standard_normal(q.shape, np.float32)
    o, lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, return_lse=True, interpret=True)
    o, lse = np.array(o), np.array(lse)
    if lse_from == "port":
        lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                  window=window, return_lse=True)[1].numpy()
    want = jax_bwd(*map(jnp.asarray, (q, k, v, o, do, lse)), causal=causal, window=window,
                   interpret=True)
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, do, lse)),
                                    causal=causal, window=window)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)


GRAD_CASES = {
    # the cases of tests/test_autodiff.py: name: (b, hq, hkv, sq, skv, d, causal, window)
    "mha_full": (2, 4, 4, 128, 128, 64, False, None),
    "gqa_causal": (2, 8, 2, 128, 128, 64, True, None),
    "window_48": (1, 4, 2, 160, 160, 32, True, 48),
    "cross_96_256": (1, 4, 2, 96, 256, 64, True, None),
    "cross_256_96": (1, 4, 2, 256, 96, 64, True, None),
    # head dim 256 (Gemma 2, Gemma-7B): B13a / B13b's own layout on the card
    "d256_causal": (1, 2, 1, 128, 128, 256, True, None),
    "d256_window_48": (1, 4, 2, 160, 160, 256, True, 48),
}


@pytest.mark.parametrize("case", list(GRAD_CASES), ids=list(GRAD_CASES))
def test_op_grads_match_jax_grad(case):
    b, hq, hkv, sq, skv, d, causal, window = GRAD_CASES[case]
    q, k, v = make(3, b, hq, hkv, sq, skv, d)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, None, causal, window, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (autodiff.flash_attention(*leaves, causal=causal, window=window) ** 2).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD_TOL)
    if sq > skv:
        assert (leaves[0].grad[:, :, : sq - skv] == 0).all()  # rows with no key


def next_token_loss_jax(params, cfg, ids):
    logits, _ = jax_forward(params, cfg, ids, mode="prefill", interpret=True)
    lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    return -jnp.mean(jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1))


def next_token_loss(params, cfg, ids):
    """The loss of tests/test_autodiff.py: mean next-token NLL."""
    logits, _ = forward(params, cfg, ids)
    return torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())


MODEL_FAMILIES = {
    "llama": {},
    "mistral_window": dict(sliding_window=8, use_sliding_window=True),
    # Gemma 2 without the attention cap (a capped prefill stays forward
    # only): head dim 256, windows (8, None), the query_pre_attn_scalar
    # scale, the final-logit cap, sandwich norms, GeGLU, scaled and tied
    # embeddings.
    "gemma2_uncapped_d256": dict(
        head_dim=256, layer_window_pattern=(8, None), attention_scale=24 ** -0.5,
        logit_softcap=None, final_logit_softcap=30.0, hidden_activation="gelu_tanh",
        sandwich_norms=True, scale_embeddings=True, rms_norm_plus_one=True,
        tie_word_embeddings=True),
}


@pytest.mark.parametrize("family", list(MODEL_FAMILIES))
def test_model_grads_match_jax_grad(family):
    """loss.backward() through the port's forward against jax.grad through
    the JAX forward on its Pallas kernels, every parameter leaf."""
    extra = MODEL_FAMILIES[family]
    jcfg = jax_tiny(num_layers=2, dtype=jnp.float32, **extra)
    cfg = tiny_test_config(num_layers=2, **extra)
    jparams = jax_init(jcfg, jax.random.key(3))
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.grad(next_token_loss_jax)(jparams, jcfg, jnp.asarray(ids))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    next_token_loss(params, cfg, torch.from_numpy(ids).long()).backward()
    flat_want = jax.tree.leaves(want)
    assert len(leaves) == len(flat_want)
    for t, w in zip(leaves, flat_want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_api_enters_the_autograd_op_only_when_autograd_records(monkeypatch):
    calls = []
    real = autodiff.flash_attention
    monkeypatch.setattr(api.autodiff, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.from_numpy(x) for x in make(5, 1, 4, 2, 32, 32, 16))
    api.flash_attn_func(q, k, v, causal=True)
    assert calls == []  # nothing requires grad
    q.requires_grad_()
    with torch.no_grad():
        api.flash_attn_func(q, k, v, causal=True)
    assert calls == []
    api.flash_attn_func(q, k, v, causal=True, logit_softcap=30.0)
    assert calls == []  # the soft cap stays on the forward-only route
    out = api.flash_attn_func(q, k, v, causal=True)
    assert calls == [1] and out.grad_fn is not None
    # Decode and extend stay forward only.
    api.flash_attn_func(q[:, :, :1], k, v)
    api.flash_attn_func(q, k, v, causal=True, kv_length=torch.full((1,), 32, dtype=torch.int32))
    assert calls == [1]


def test_adamw_steps_lower_the_loss():
    cfg = tiny_test_config(num_layers=2)
    jparams = jax_init(jax_tiny(num_layers=2, dtype=jnp.float32), jax.random.key(6))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    opt = torch.optim.AdamW(leaves, lr=3e-3)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16))).long()
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = next_token_loss(params, cfg, ids)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_forward_under_no_grad_is_bit_identical():
    """The differentiable route's forward value equals the forward-only
    route's, bit for bit (the same plain forward on CPU)."""
    cfg = tiny_test_config(num_layers=2)
    jparams = jax_init(jax_tiny(num_layers=2, dtype=jnp.float32), jax.random.key(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 20))).long()
    with torch.no_grad():
        want, _ = forward(params, cfg, ids)
    for t in jax.tree.leaves(params):
        t.requires_grad_()
    got, _ = forward(params, cfg, ids)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)


def test_model_grads_route_through_the_op(monkeypatch):
    """Each layer's prefill attention runs the autograd op once."""
    calls = []
    real = autodiff.FlashAttention.apply
    monkeypatch.setattr(autodiff.FlashAttention, "apply",
                        lambda *a: calls.append(1) or real(*a))
    cfg = dataclasses.replace(tiny_test_config(), num_layers=3)
    jparams = jax_init(jax_tiny(num_layers=3, dtype=jnp.float32), jax.random.key(10))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    params["layers"]["q_proj"].requires_grad_()
    ids = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12))).long()
    next_token_loss(params, cfg, ids).backward()
    assert calls == [1, 1, 1]
    assert params["layers"]["q_proj"].grad.abs().sum() > 0
