"""The port's attention ops (flash_attention_cute_tpu_torch) against the
JAX package on identical inputs, on the CPU.

On CPU tensors every port op runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode or its XLA reference. Inputs are
made with numpy from a seed and handed to both. Tolerances are fp32:
1e-5 between the two references, 2e-5 against a Pallas kernel (which sums
in blocks in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops.flash_decode import (
    flash_attention_decode as jax_decode,
)
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.ops.reference import (
    attention_reference as jax_reference,
)
from flash_attention_cute_tpu_torch import api, dispatch
from flash_attention_cute_tpu_torch.ops import autodiff, flash_bwd, flash_decode, flash_fwd, flash_varlen
from flash_attention_cute_tpu_torch.ops.reference import (
    attention_reference,
    bottom_right_causal_mask,
)


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return normal(rng, b, hq, sq, d), normal(rng, b, hkv, skv, d), normal(rng, b, hkv, skv, d)


def t(x):
    return torch.from_numpy(np.array(x))


REF_CASES = {
    # name: (hq, hkv, sq, skv, causal, kv_length)
    "mha_causal": (4, 4, 32, 32, True, None),
    "gqa_causal": (8, 2, 32, 32, True, None),
    "mqa_causal": (8, 1, 32, 32, True, None),
    "gqa_full": (8, 2, 24, 40, False, None),
    "sq_lt_skv_causal": (4, 2, 16, 48, True, None),
    "sq_gt_skv_zero_rows": (4, 2, 48, 16, True, None),
    "kv_length": (4, 2, 1, 40, False, [17, 40]),
    "kv_length_causal": (4, 2, 8, 40, True, [33, 12]),
}


@pytest.mark.parametrize("case", list(REF_CASES), ids=list(REF_CASES))
def test_reference_matches_jax(case):
    hq, hkv, sq, skv, causal, kv_length = REF_CASES[case]
    q, k, v = qkv(0, 2, hq, hkv, sq, skv, 16)
    lens = None if kv_length is None else np.array(kv_length, np.int32)
    want = jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_length=None if lens is None else jnp.asarray(lens),
        precision=jax.lax.Precision.HIGHEST,
    )
    got = attention_reference(
        t(q), t(k), t(v), causal=causal, kv_length=None if lens is None else t(lens)
    )
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if case == "sq_gt_skv_zero_rows":
        assert (got[:, :, : sq - skv] == 0).all()


def test_reference_window_softcap_q_offset_match_jax():
    q, k, v = qkv(1, 2, 4, 2, 12, 40, 16)
    off = np.array([10, 28], np.int32)
    lens = np.array([22, 40], np.int32)
    want = jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_length=jnp.asarray(lens), q_offset=jnp.asarray(off), window=7,
        logit_softcap=5.0, precision=jax.lax.Precision.HIGHEST,
    )
    got = attention_reference(
        t(q), t(k), t(v), causal=True, kv_length=t(lens), q_offset=t(off),
        window=7, logit_softcap=5.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_bottom_right_mask_matches_jax():
    for q_len, kv_len in ((5, 9), (9, 5), (7, 7)):
        from flash_attention_cute_tpu.ops.reference import (
            bottom_right_causal_mask as jax_mask,
        )

        np.testing.assert_array_equal(
            bottom_right_causal_mask(q_len, kv_len).numpy(),
            np.asarray(jax_mask(q_len, kv_len)),
        )


def test_prefill_matches_jax_diag_kernel():
    """Causal Sq == Skv at block 128: the JAX side takes the diag-first
    kernel (`_flash_fwd_kernel_diag`), the kernel this op replaces."""
    q, k, v = qkv(2, 1, 4, 2, 256, 256, 64)
    want = jax_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=128, block_kv=128, interpret=True,
    )
    got = flash_fwd.flash_attention_fwd(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


LSE_CASES = {
    # name: (head_dim, soft cap, window), at Sq 70 / Skv 90, Hq 4 / Hkv 2
    "d256": (256, None, None),
    "d256_cap50": (256, 50.0, None),
    "d256_cap1_window40": (256, 1.0, 40),
    "d128_cap2": (128, 2.0, None),
}


@pytest.mark.parametrize("case", list(LSE_CASES), ids=list(LSE_CASES))
def test_prefill_with_lse_matches_jax_at_d256_and_with_the_cap(case):
    """The output and lse the prefill kernel writes at D 256 and with the
    soft cap: the plain version against the JAX forward (strict softmax,
    interpret mode) with `return_lse`, both at 1e-5."""
    d, cap, window = LSE_CASES[case]
    q, k, v = qkv(5, 1, 4, 2, 70, 90, d)
    want, want_lse = jax_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        logit_softcap=cap, return_lse=True, stable="strict", interpret=True,
    )
    got, lse = flash_fwd.flash_attention_fwd(t(q), t(k), t(v), causal=True, window=window,
                                             logit_softcap=cap, return_lse=True)
    assert lse.shape == (1, 4, 70) and lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_splits", [1, 4])
def test_decode_matches_jax_kernel_stacked_cache(num_splits):
    """Stacked [L,B,Hkv,C,D] cache, layer 1, ragged lengths; the port's
    cache holds NaN past the lengths (uninitialised memory), JAX's zeros."""
    rng = np.random.default_rng(3)
    n_layers, b, hq, hkv, cap, d = 3, 2, 8, 2, 512, 64
    q = normal(rng, b, hq, 1, d)
    kc = normal(rng, n_layers, b, hkv, cap, d)
    vc = normal(rng, n_layers, b, hkv, cap, d)
    lens = np.array([300, 37], np.int32)
    for i, n in enumerate(lens):
        kc[:, i, :, n:] = 0.0
        vc[:, i, :, n:] = 0.0
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), kv_length=jnp.asarray(lens),
        layer=jnp.asarray(1, jnp.int32), num_splits=num_splits, block_kv=128,
        interpret=True,
    )
    kp, vp = t(kc), t(vc)
    for i, n in enumerate(lens):
        kp[:, i, :, n:] = float("nan")
        vp[:, i, :, n:] = float("nan")
    got = flash_decode.flash_attention_decode(
        t(q), kp, vp, kv_length=t(lens), num_splits=num_splits, layer=1
    )
    assert got.shape == (b, hq, 1, d)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("window,softcap", [(None, None), (50, 10.0)], ids=["full", "window_cap"])
def test_decode_plain_at_group_24_matches_jax_kernel(window, softcap):
    """A GQA group of 24 (48 / 2 heads, which the kernel takes since it runs
    B5's body; JAX pads the group to 24 rows): the plain D1 + D2 against
    the JAX kernel in interpret mode, ragged lengths, 3 splits."""
    rng = np.random.default_rng(8)
    b, hq, hkv, cap, d = 2, 48, 2, 256, 64
    q, kc, vc = normal(rng, b, hq, 1, d), normal(rng, b, hkv, cap, d), normal(rng, b, hkv, cap, d)
    lens = np.array([256, 77], np.int32)
    want = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      kv_length=jnp.asarray(lens), window=window, logit_softcap=softcap,
                      num_splits=3, block_kv=128, interpret=True)
    got = flash_decode.flash_attention_decode(t(q), t(kc), t(vc), kv_length=t(lens),
                                              window=window, logit_softcap=softcap, num_splits=3)
    assert got.shape == (b, hq, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_decode_split_count_invariance_and_dead_rows():
    rng = np.random.default_rng(4)
    q = t(normal(rng, 3, 8, 1, 32))
    k = t(normal(rng, 3, 2, 200, 32))
    v = t(normal(rng, 3, 2, 200, 32))
    lens = torch.tensor([200, 5, 0], dtype=torch.int32)
    outs = [
        flash_decode.flash_attention_decode(q, k, v, kv_length=lens, num_splits=s)
        for s in (1, 3, 8, 200)
    ]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-6, rtol=0)
    assert (outs[0][2] == 0).all()  # a row of length 0 emits exact zeros
    ref = attention_reference(q, k, v, kv_length=lens)
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_decode_partials_dead_split_and_combine_weights():
    """A split past the length has m = -inf, l = 0, acc = 0 and weight 0."""
    rng = np.random.default_rng(5)
    q = t(normal(rng, 1, 4, 1, 16))
    k = t(normal(rng, 1, 1, 64, 16))
    v = t(normal(rng, 1, 1, 64, 16))
    lens = torch.tensor([20], dtype=torch.int32)
    acc, m, l = flash_decode.decode_partials(q, k, v, lens, 0.25, 4)
    assert acc.shape == (1, 1, 4, 4, 16) and m.shape == (1, 1, 4, 4)
    assert torch.isfinite(m[:, :, :2]).all()
    assert (m[:, :, 2:] == float("-inf")).all() and (l[:, :, 2:] == 0).all()
    assert (acc[:, :, 2:] == 0).all()
    out = flash_decode.decode_combine(acc, m, l, torch.float32)
    ref = attention_reference(q, k, v, softmax_scale=0.25, kv_length=lens)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_decode_window_softcap_plain_match_jax_reference():
    rng = np.random.default_rng(6)
    q, k, v = normal(rng, 2, 4, 1, 16), normal(rng, 2, 2, 96, 16), normal(rng, 2, 2, 96, 16)
    lens = np.array([90, 33], np.int32)
    want = jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_length=jnp.asarray(lens),
        window=10, logit_softcap=3.0, precision=jax.lax.Precision.HIGHEST,
    )
    got = flash_decode.flash_attention_decode(
        t(q), t(k), t(v), kv_length=t(lens), window=10, logit_softcap=3.0, num_splits=3
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "route", ["prefill", "decode", "extend"], ids=["prefill", "decode", "extend"]
)
def test_api_routes_match_jax_reference(route):
    sq, lens, off = {"prefill": (16, None, None), "decode": (1, [21, 9], None),
                     "extend": (4, [30, 12], [26, 8])}[route]
    q, k, v = qkv(7, 2, 4, 2, sq, 32, 16)
    kw_j, kw_t = {}, {}
    if lens is not None:
        kw_j["kv_length"] = jnp.asarray(lens, jnp.int32)
        kw_t["kv_length"] = torch.tensor(lens, dtype=torch.int32)
    if off is not None:
        kw_j["q_offset"] = jnp.asarray(off, jnp.int32)
        kw_t["q_offset"] = torch.tensor(off, dtype=torch.int32)
    causal = route != "decode"
    want = jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        precision=jax.lax.Precision.HIGHEST, **kw_j,
    )
    got = api.flash_attn_func(t(q), t(k), t(v), causal=causal, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_non_cpu_tensors_take_the_kernel_route_and_never_fall_back():
    """A tensor off the CPU goes to the kernel wrapper, which checks it and
    raises: there is no silent move to the plain version."""
    q = torch.empty(1, 4, 64, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.flash_attention_fwd(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_decode.flash_attention_decode(q[:, :, :1], k, k)
    q32 = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):  # a group of 32, one chunk
        flash_decode.flash_attention_decode(q32, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):  # a group of 33, two chunks
        flash_decode.flash_attention_decode(torch.cat([q32, q32[:, :2]], 1), k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        api.flash_attn_func(q, k, k, causal=True, kv_length=torch.ones(1, dtype=torch.int32))
    # P takes a soft cap: a capped call reaches the CUDA-tensor check; under
    # autograd it raises (no backward kernel takes the cap).
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.flash_attention_fwd(q, k, k, causal=True, logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10b"):
        api.flash_attn_func(q.detach().requires_grad_(), k, k, causal=True, logit_softcap=30.0)
    with pytest.raises(NotImplementedError):
        flash_fwd.flash_attention_fwd(q.float(), k.float(), k.float())
    # int8 scores (K8, then P-i8 / B2-i8) reach the same check, K8 alone
    # too; under autograd they and a non-default `stable` raise (forward
    # only, as in the JAX package).
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.flash_attention_fwd(q, k, k, causal=True, score_dtype="int8")
    with pytest.raises(ValueError, match="CUDA tensor"):
        api.flash_attn_func(q, k, k, causal=True, window=16, score_dtype="int8",
                            logit_softcap=50.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.quantize_k_rows(k)
    with pytest.raises(NotImplementedError, match="forward-only"):
        api.flash_attn_func(q.detach().requires_grad_(), k, k, causal=True, score_dtype="int8")
    with pytest.raises(NotImplementedError, match="forward-only"):
        api.flash_attn_func(q.detach().requires_grad_(), k, k, causal=True, stable="strict")
    with pytest.raises(NotImplementedError):
        flash_fwd.flash_attention_fwd(q.float(), k.float(), k.float(), score_dtype="int8")
    # The training and varlen wrappers (B13a / B13b, B12) and the autograd op.
    lse = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.flash_attention_fwd(q, k, k, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd.flash_attention_bwd(q, k, k, q, q, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        autodiff.flash_attention(q.requires_grad_(), k, k, causal=True)
    # D 256, D 96, D 100 and D 264 under autograd: the backward kernels take
    # them (D 96 and D 100 in D 128's layout, D 100's rows at a pitch of 104,
    # D 264 in the layout of 512), so the op reaches the forward's
    # CUDA-tensor check; D 520, which no backward layout takes, is refused
    # before the forward.
    q256 = torch.empty(1, 4, 64, 256, dtype=torch.bfloat16, device="meta")
    k256 = torch.empty(1, 2, 64, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd.flash_attention_fwd(q256, k256, k256, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        autodiff.flash_attention(q256.detach().requires_grad_(), k256, k256, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd.flash_attention_bwd(q256, k256, k256, q256, q256,
                                      torch.empty(1, 4, 64, device="meta"), causal=True)
    q96 = torch.empty(1, 4, 64, 96, dtype=torch.bfloat16, device="meta")
    k96 = torch.empty(1, 2, 64, 96, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        autodiff.flash_attention(q96.detach().requires_grad_(), k96, k96, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd.flash_attention_bwd(q96, k96, k96, q96, q96,
                                      torch.empty(1, 4, 64, device="meta"), causal=True)
    q100 = torch.empty(1, 4, 64, 100, dtype=torch.bfloat16, device="meta")
    k100 = torch.empty(1, 2, 64, 100, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        autodiff.flash_attention(q100.requires_grad_(), k100, k100, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd.flash_attention_bwd(q100, k100, k100, q100, q100,
                                      torch.empty(1, 4, 64, device="meta"), causal=True)
    q264 = torch.empty(1, 4, 64, 264, dtype=torch.bfloat16, device="meta")
    k264 = torch.empty(1, 2, 64, 264, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        autodiff.flash_attention(q264.requires_grad_(), k264, k264, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd.flash_attention_bwd(q264.detach(), k264, k264, q264.detach(), q264.detach(),
                                      torch.empty(1, 4, 64, device="meta"), causal=True)
    q520 = torch.empty(1, 4, 64, 520, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):
        autodiff.flash_attention(q520.detach().requires_grad_(), q520[:, :2], q520[:, :2],
                                 causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):
        flash_bwd.flash_attention_bwd(q520, q520[:, :2], q520[:, :2], q520, q520,
                                      torch.empty(1, 4, 64, device="meta"), causal=True)
    cu = torch.tensor([0, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):  # B12 at D 96
        flash_varlen.flash_attention_varlen(q96[0].transpose(0, 1), k96[0].transpose(0, 1),
                                            k96[0].transpose(0, 1), cu, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):  # B12 at D 100
        flash_varlen.flash_attention_varlen(q100[0].transpose(0, 1), k100[0].transpose(0, 1),
                                            k100[0].transpose(0, 1), cu, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):  # B12 at D 264, in the wide layout
        flash_varlen.flash_attention_varlen(q264[0].transpose(0, 1), k264[0].transpose(0, 1),
                                            k264[0].transpose(0, 1), cu, causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):  # above the wide layout
        flash_varlen.flash_attention_varlen(q520[0].transpose(0, 1), q520[0].transpose(0, 1),
                                            q520[0].transpose(0, 1), cu, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_varlen.flash_attention_varlen(q[0].transpose(0, 1), k[0].transpose(0, 1),
                                            k[0].transpose(0, 1), cu, causal=True)
    # B12 and B4 take the soft cap and D 256: such calls reach the
    # CUDA-tensor check of the kernel route.
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_varlen.flash_attention_varlen(q[0].transpose(0, 1), k[0].transpose(0, 1),
                                            k[0].transpose(0, 1), cu, logit_softcap=30.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_varlen.flash_attention_varlen(q256[0].transpose(0, 1), k256[0].transpose(0, 1),
                                            k256[0].transpose(0, 1), cu, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        api.flash_attn_func(q256.detach(), k256, k256, causal=True, logit_softcap=50.0,
                            kv_length=torch.ones(1, dtype=torch.int32))


def test_validate_inputs_and_split_heuristic():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        dispatch.validate_inputs(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        dispatch.validate_inputs(q, q.half(), q.half())
    # Llama-3-8B decode at batch 4: 32 (row, head) pairs x 8 splits = 256
    # blocks, one wave of the 264 slots (132 SMs x 2 blocks an SM below D 256).
    assert dispatch.decode_num_splits(4, 8, 576, 128) == 8
    assert 4 * 8 * dispatch.decode_num_splits(4, 8, 576, 128) >= dispatch.NUM_SMS
    assert dispatch.decode_num_splits(64, 8, 4096, 128) == 1
    assert dispatch.decode_num_splits(1, 1, 100, 64) == 1  # never below one tile (64 keys)
    assert dispatch.decode_num_splits(1, 1, 100, 128) == 3  # 34-key chunks of 32-key tiles
