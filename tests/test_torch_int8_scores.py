"""int8 scores in the port's dense prefill (`score_dtype="int8"`) against
the JAX package on identical inputs, on the CPU.

CPU tensors take the plain version (ops/flash_fwd.py `int8_attention_plain`:
per-row int8 q and K, the exact integer products, the fp32 softmax); the
JAX side runs its Pallas kernels' int8 branch in interpret mode. The two
quantize K alike (per row) but q differently: one scale a row in the port,
one scale a q tile in the TPU kernels. Where every q row has the same max
|q| the two coincide, and the outputs (and the lse) agree within 1e-5,
fp32 sums in another order. On random bf16 inputs each is held to the
fp32 oracle of bf16 scores at 5e-2, the JAX package's own envelope of int8
scores, and to the other at 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops.flash_fwd import _quantize_k_rows
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.ops.reference import attention_reference as jax_reference
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.ops import flash_fwd

ENVELOPE = 5e-2


def t(x):
    return torch.from_numpy(np.array(x))


def equal_row_max_qkv(seed, b, hq, hkv, sq, skv, d):
    """fp32 inputs whose q rows all have max |q| 6 (element 0 is +-6, the
    rest within +-3), so that a scale a row and a scale a tile agree."""
    rng = np.random.default_rng(seed)
    q = np.clip(rng.standard_normal((b, hq, sq, d), dtype=np.float32), -3, 3)
    q[..., 0] = np.where(rng.random((b, hq, sq)) < 0.5, 6.0, -6.0)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    return q, k, v


EXACT_CASES = {
    # name: (sq, skv, JAX kwargs: the diag route takes block_q == block_kv)
    "causal_diag": (128, 128, dict(causal=True, block_q=128, block_kv=128)),
    "noncausal": (128, 128, dict(causal=False)),
    "cap": (128, 128, dict(causal=True, logit_softcap=10.0)),
    "window": (128, 128, dict(causal=True, window=40)),
    "cross_lse": (64, 256, dict(causal=True, return_lse=True, block_q=64, block_kv=128)),
    # Head dims outside {64, 128, 256}: Phi-3-mini's 96 and 100 (whose
    # bf16 rows the card reads at a pitch of 104); JAX pads both to 128.
    "causal_diag_d96": (128, 128, dict(causal=True, block_q=128, block_kv=128)),
    "cross_lse_d100": (64, 256, dict(causal=True, return_lse=True, block_q=64, block_kv=128)),
}


@pytest.mark.parametrize("case", list(EXACT_CASES), ids=list(EXACT_CASES))
def test_plain_int8_route_equals_jax_kernels_at_equal_row_maxima(case):
    sq, skv, kw = EXACT_CASES[case]
    d = int(case.rsplit("_d", 1)[1]) if case.endswith(("_d96", "_d100")) else 64
    q, k, v = equal_row_max_qkv(7, 1, 4, 2, sq, skv, d)
    want = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), score_dtype="int8",
                   interpret=True, **kw)
    port_kw = {n: x for n, x in kw.items() if n not in ("block_q", "block_kv")}
    got = flash_fwd.flash_attention_fwd(t(q), t(k), t(v), score_dtype="int8", **port_kw)
    if kw.get("return_lse"):
        (want, want_lse), (got, got_lse) = want, got
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=100)],
                         ids=["causal", "window"])
def test_int8_routes_on_random_bf16_stay_in_the_envelope(kw):
    """Random bf16 q: the port's per-row q scale and JAX's per-tile one
    each within the envelope of the fp32 oracle and of each other; the
    port's int8 route moves the output off its bf16-score route."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s, dtype=np.float32).astype(jnp.bfloat16)
               for s in ((2, 4, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64)))
    want = np.asarray(jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), score_dtype="int8",
                              block_q=128, block_kv=128, interpret=True, **kw), np.float32)
    tq, tk, tv = (t(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (q, k, v))
    got = flash_fwd.flash_attention_fwd(tq, tk, tv, score_dtype="int8", **kw).float().numpy()
    oracle = np.asarray(jax_reference(jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
                                      jnp.asarray(v, jnp.float32), **kw))
    for name, x in (("port", got), ("JAX", want)):
        assert np.abs(x - oracle).max() <= ENVELOPE, name
    assert np.abs(got - want).max() <= ENVELOPE
    bf16_scores = flash_fwd.flash_attention_fwd(tq, tk, tv, **kw).float().numpy()
    assert np.abs(got - bf16_scores).max() > 1e-4


@pytest.mark.parametrize("d", [64, 128, 256, 4, 40, 96, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k_row_quantizer_is_bit_identical_to_jax(dtype, d):
    """K8's plain version against JAX `_quantize_k_rows`: values and scales
    bit for bit, over a zero row and a row of ties (max 127: the values
    0.5, 1.5, 2.5, -0.5 and -1.5 round half to even)."""
    rng = np.random.default_rng(d)
    k = 3 * rng.standard_normal((300, d), dtype=np.float32)
    k[5] = 0
    k[6, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5][:d]  # D 4 takes the first four
    k[6, 6:] = 0.25
    kj = jnp.asarray(k).astype(getattr(jnp, dtype))
    want_v, want_s = _quantize_k_rows(kj)
    got_v, got_s = flash_fwd.quantize_k_rows(t(np.asarray(kj.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert got_v.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[:, 0])
    assert got_s[5] == 1 and (got_v[5] == 0).all()
    assert got_v[6, :6].tolist() == [127, 0, 2, 2, 0, -2][:d]


def test_api_score_dtype_and_stable_follow_jax():
    """JAX's tests/test_api.py call forms on the port: the int8 route within
    the envelope, the decode and extend routes refuse score_dtype, a bad
    score_dtype or stable raises; every stable mode gives the default's
    output exactly."""
    rng = np.random.default_rng(3)
    q, k, v = (t(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
               for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    out = api.flash_attention_forward(q, k, v, causal=True, score_dtype="int8")
    ref = jax_reference(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), causal=True)
    assert np.abs(out.float().numpy() - np.asarray(ref)).max() <= ENVELOPE
    with pytest.raises(ValueError, match="dense prefill"):
        api.flash_attention_forward(q[:, :, :1], k, v, score_dtype="int8")
    with pytest.raises(ValueError, match="dense prefill"):
        api.flash_attention_forward(q, k, v, causal=True, score_dtype="int8",
                                    kv_length=torch.full((1,), 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="dense prefill"):
        api.flash_attention_forward(q, k, v, causal=True, score_dtype="int8",
                                    q_offset=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="score_dtype must be 'int8' or None"):
        api.flash_attention_forward(q, k, v, causal=True, score_dtype="fp8")
    with pytest.raises(ValueError, match="score_dtype must be 'int8' or None"):
        flash_fwd.flash_attention_fwd(q, k, v, score_dtype="int4")
    with pytest.raises(ValueError, match="stable must be"):
        api.flash_attention_forward(q, k, v, causal=True, stable="lazy")
    default = api.flash_attention_forward(q, k, v, causal=True)
    for stable in (True, "strict", False):
        same = api.flash_attention_forward(q, k, v, causal=True, stable=stable)
        assert torch.equal(same, default), stable
        assert torch.equal(flash_fwd.flash_attention_fwd(q, k, v, causal=True, stable=stable),
                           default), stable


def test_forward_only_knobs_differentiate_on_the_cpu():
    """Under autograd a non-default knob keeps prefill off the autograd op;
    CPU tensors take the plain version, which autograd differentiates (a
    CUDA tensor raises: tests/test_torch_attention.py)."""
    rng = np.random.default_rng(5)
    q = t(rng.standard_normal((1, 4, 32, 16), dtype=np.float32)).requires_grad_()
    k, v = (t(rng.standard_normal((1, 2, 32, 16), dtype=np.float32)).requires_grad_()
            for _ in "kv")
    for kw in (dict(score_dtype="int8"), dict(stable="strict")):
        q.grad = k.grad = v.grad = None
        api.flash_attention_forward(q, k, v, causal=True, **kw).sum().backward()
        assert v.grad is not None and torch.isfinite(v.grad).all()
    assert torch.isfinite(q.grad).all() and bool((q.grad != 0).any())
