"""Sliding windows in the port's attention ops against the JAX kernels, on
the CPU.

The plain versions of B2 (windowed prefill), D1 (decode partials, merged by
D2), B4 (contiguous extend), B5 / B6 (paged decode / extend) and B7 / B8 /
B9 (their quantized twins) take windows of 1 key, a mid-tile value and one
at least the length, at a GQA group of 7 (Qwen2-7B's 28 / 4 heads), and are
held to the JAX kernels in interpret mode (the route of the JAX package's
own CPU tests) on the same numpy-seeded inputs. Tolerance: atol 1e-5 at
fp32 (the same scores summed in another order). The CUDA kernels are held
to these plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.ops import flash_chunked, flash_decode, flash_fwd
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.ops import quantized as quant
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

ATOL = 1e-5
HQ, HKV = 14, 2  # GQA group 7
# A window of one key (only the diagonal), one whose edge falls inside a
# 64-key tile, and one at least every length below (it never binds).
WINDOWS = {"w1": 1, "w45_mid_tile": 45, "w400_ge_length": 400}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def t(*arrays):
    """Torch copies (JAX on the CPU may alias a numpy buffer)."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


PREFILL = {
    # name: (sq, skv, causal): square, a shorter query block (bottom-right
    # offset 96), and non-causal (the window alone bounds a row).
    "square_s160": (160, 160, True),
    "offset_sq64_skv160": (64, 160, True),
    "noncausal_s96": (96, 96, False),
}


# Every window on the square prefill; the binding ones on the others.
PREFILL_CASES = [(c, w) for c in PREFILL for w in WINDOWS
                 if c == "square_s160" or w != "w400_ge_length"]


@pytest.mark.parametrize("case,window", PREFILL_CASES)
def test_prefill_window_plain_matches_jax_kernel(case, window):
    """B2's plain version against JAX's windowed prefill (the fused kernel;
    a window of at least Skv is dropped by both wrappers)."""
    sq, skv, causal = PREFILL[case]
    w = WINDOWS[window]
    rng = np.random.default_rng(sq + w)
    q, k, v = normal(rng, 1, HQ, sq, 32), normal(rng, 1, HKV, skv, 32), normal(rng, 1, HKV, skv, 32)
    want = jax_fwd(*j(q, k, v), causal=causal, window=w, interpret=True)
    got = flash_fwd.flash_attention_fwd(*t(q, k, v), causal=causal, window=w)
    assert got.shape == q.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_prefill_window_per_head_kernel_and_group_packing_agree():
    """JAX's per-head fallback `_flash_fwd_kernel` (fuse_group=False) and
    its fused kernel compute one function, which B2's plain version is."""
    rng = np.random.default_rng(1)
    q, k, v = normal(rng, 2, HQ, 130, 64), normal(rng, 2, HKV, 130, 64), normal(rng, 2, HKV, 130, 64)
    got = flash_fwd.flash_attention_fwd(*t(q, k, v), causal=True, window=45).numpy()
    for fuse in (False, True):
        want = jax_fwd(*j(q, k, v), causal=True, window=45, fuse_group=fuse, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=str(fuse))


DECODE_LENS = [0, 1, 45, 46, 300]  # a window edge at the length, one past it


@pytest.mark.parametrize("window", list(WINDOWS))
def test_decode_window_plain_matches_jax_kernel(window):
    """D1 + D2's plain version over a stacked cache whose tail past every
    length is NaN (uninitialised memory; JAX's holds zeros)."""
    w = WINDOWS[window]
    rng = np.random.default_rng(w)
    b, cap = len(DECODE_LENS), 320
    q = normal(rng, b, HQ, 1, 32)
    kc, vc = normal(rng, 2, b, HKV, cap, 32), normal(rng, 2, b, HKV, cap, 32)
    lens = np.asarray(DECODE_LENS, np.int32)
    for i, n in enumerate(lens):
        kc[:, i, :, n:] = vc[:, i, :, n:] = 0.0
    want = jax_decode(*j(q, kc, vc), kv_length=jnp.asarray(lens), window=w, num_splits=4,
                      block_kv=64, layer=jnp.asarray(1, jnp.int32), interpret=True)
    kp, vp = t(kc, vc)
    for i, n in enumerate(lens):
        kp[:, i, :, n:] = vp[:, i, :, n:] = float("nan")
    got = flash_decode.flash_attention_decode(t(q)[0], kp, vp, kv_length=t(lens)[0], window=w,
                                              num_splits=4, layer=1)
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_decode_partials_window_marks_splits_below_it_dead():
    """The contract D1 keeps on the card: a split wholly below the window
    writes m = -inf, l = 0, acc = 0 (weight 0 in D2), one it cuts holds the
    visible keys only, and a window at least the length is no window."""
    rng = np.random.default_rng(2)
    q, k, v = t(normal(rng, 2, HQ, 1, 16), normal(rng, 2, HKV, 256, 16),
                normal(rng, 2, HKV, 256, 16))
    lens = torch.tensor([256, 150], dtype=torch.int32)
    acc, m, l = flash_decode.decode_partials(q, k, v, lens, 0.25, 4, window=100)
    # Row 0 sees [156, 256): splits 0-1 ([0, 128)) dead; row 1 sees [50,
    # 150): split 0 cut to [50, 64), split 3 ([192, 256)) past the length.
    assert (m[0, :, :2] == float("-inf")).all() and (l[0, :, :2] == 0).all()
    assert (acc[0, :, :2] == 0).all() and (m[1, :, 3] == float("-inf")).all()
    assert torch.isfinite(m[0, :, 2:]).all() and torch.isfinite(m[1, :, :3]).all()
    out = flash_decode.decode_combine(acc, m, l, torch.float32)
    ref = attention_reference(q, k, v, softmax_scale=0.25, kv_length=lens, window=100)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    for splits in (1, 4):
        np.testing.assert_array_equal(
            flash_decode.flash_attention_decode(q, k, v, lens, window=256, num_splits=splits),
            flash_decode.flash_attention_decode(q, k, v, lens, num_splits=splits))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_chunked_window_plain_matches_jax_kernel(window):
    """B4's plain version: chunks of 40 at q_offset 0, 37 and 200 (the
    window's lower edge inside the chunk and below it)."""
    w = WINDOWS[window]
    rng = np.random.default_rng(10 + w)
    s, cap = 40, 256
    q, k, v = normal(rng, 3, HQ, s, 32), normal(rng, 3, HKV, cap, 32), normal(rng, 3, HKV, cap, 32)
    offs = np.asarray([0, 37, 200], np.int32)
    kvl = offs + s
    want = jax_chunked(*j(q, k, v, offs, kvl), window=w, interpret=True)
    got = flash_chunked.flash_attention_chunked(*t(q, k, v, offs, kvl), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def paged_inputs(seed, b, sq, ps, pps, d=32):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    q = normal(rng, b, HQ, sq, d)
    kp, vp = normal(rng, HKV, num_pages, ps, d), normal(rng, HKV, num_pages, ps, d)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return q, kp, vp, table, rng


@pytest.mark.parametrize("window", list(WINDOWS))
def test_paged_decode_window_plain_matches_jax_kernel(window):
    """B5 + D2's plain version, lengths crossing pages of 16."""
    w = WINDOWS[window]
    q, kp, vp, table, _ = paged_inputs(20 + w, 4, 1, 16, 12)
    lens = np.asarray([0, 47, 100, 192], np.int32)
    want = jax_pa.paged_attention_decode(*j(q, kp, vp, lens, table), window=w,
                                         pages_per_compute_block=2, interpret=True)
    got = pa.paged_attention_decode(*t(q, kp, vp, lens, table), window=w)
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_paged_extend_window_plain_matches_jax_kernel(window):
    """B6's plain version: chunks of 24 at q_offset 0, 70 and 150, and an
    inactive row (kv_length 0)."""
    w = WINDOWS[window]
    q, kp, vp, table, _ = paged_inputs(30 + w, 4, 24, 8, 24)
    offs = np.asarray([0, 70, 150, 0], np.int32)
    kvl = np.asarray([24, 94, 174, 0], np.int32)
    want = jax_pa.paged_attention_extend(*j(q, kp, vp, offs, kvl, table), window=w,
                                         pages_per_compute_block=2, interpret=True)
    got = pa.paged_attention_extend(*t(q, kp, vp, offs, kvl, table), window=w)
    assert (got[3] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


QDTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
# The window does not depend on the value type: every window over int8, the
# mid-tile one over e4m3 too.
QUANT_CASES = [("int8", w) for w in WINDOWS] + [("e4m3", "w45_mid_tile")]


def quantized_pair(x, name):
    """One fp32 array quantized by the port (bit-identical to JAX's,
    tests/test_torch_quantized.py), as (JAX QuantizedKV, port QuantizedKV)."""
    tdtype, jdtype = QDTYPES[name]
    tq = quant.quantize_kv(torch.from_numpy(x), tdtype)
    vals = tq.values.view(torch.uint8).numpy().view(jdtype) if name == "e4m3" else tq.values.numpy()
    return jax_q.QuantizedKV(jnp.asarray(vals), jnp.asarray(tq.scales.numpy())), tq


@pytest.mark.parametrize("name,window", QUANT_CASES)
def test_quant_decode_window_plain_matches_jax_kernel(name, window):
    """B7 + D2's plain version over the contiguous cache. Its capacity is a
    multiple of the JAX kernel's block_kv: over e4m3 values that kernel
    returns NaN in interpret mode for a row whose length reaches a ragged
    last block (ROADMAP.md section C)."""
    w = WINDOWS[window]
    rng = np.random.default_rng(40 + w)
    lens = np.asarray([0, 46, 250], np.int32)
    q = normal(rng, 3, HQ, 1, 32)
    (jk, tk), (jv, tv) = (quantized_pair(normal(rng, 3, HKV, 256, 32), name) for _ in "kv")
    want = jax_q.flash_attention_decode_quantized(jnp.asarray(q), jk, jv,
                                                  kv_length=jnp.asarray(lens), window=w,
                                                  block_kv=128, interpret=True)
    got = quant.flash_attention_decode_quantized(t(q)[0], tk, tv, t(lens)[0], window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def quant_pools(seed, b, pps, ps, name, d=32):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    (jk, tk), (jv, tv) = (quantized_pair(normal(rng, HKV, num_pages, ps, d), name)
                          for _ in "kv")
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return (jk, jv), (tk, tv), table, rng


@pytest.mark.parametrize("name,window", QUANT_CASES)
def test_quant_paged_decode_window_plain_matches_jax_kernel(name, window):
    """B8 + D2's plain version."""
    w = WINDOWS[window]
    (jk, jv), (tk, tv), table, rng = quant_pools(50 + w, 3, 12, 16, name)
    q = normal(rng, 3, HQ, 1, 32)
    lens = np.asarray([1, 47, 190], np.int32)
    want = jax_q.paged_attention_decode_quantized(jnp.asarray(q), jk, jv, *j(lens, table),
                                                  window=w, pages_per_compute_block=2,
                                                  interpret=True)
    got = quant.paged_attention_decode_quantized(t(q)[0], tk, tv, *t(lens, table), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,window", QUANT_CASES)
def test_quant_paged_extend_window_plain_matches_jax_kernel(name, window):
    """B9's plain version: chunks of 16 at q_offset 0, 60 and 130."""
    w = WINDOWS[window]
    (jk, jv), (tk, tv), table, rng = quant_pools(60 + w, 3, 20, 8, name)
    q = normal(rng, 3, HQ, 16, 32)
    offs = np.asarray([0, 60, 130], np.int32)
    kvl = offs + 16
    want = jax_q.paged_attention_extend_quantized(jnp.asarray(q), jk, jv, *j(offs, kvl, table),
                                                  window=w, pages_per_compute_block=2,
                                                  interpret=True)
    got = quant.paged_attention_extend_quantized(t(q)[0], tk, tv, *t(offs, kvl, table),
                                                 window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", ["prefill", "decode", "extend"])
def test_api_routes_take_the_window(route):
    """`flash_attn_func(window=)` reaches each route with its window."""
    sq, lens, off = {"prefill": (48, None, None), "decode": (1, [40, 9], None),
                     "extend": (8, [60, 20], [52, 12])}[route]
    rng = np.random.default_rng(7)
    q, k, v = t(normal(rng, 2, HQ, sq, 16), normal(rng, 2, HKV, 64, 16), normal(rng, 2, HKV, 64, 16))
    kw = {}
    if lens is not None:
        kw["kv_length"] = torch.tensor(lens, dtype=torch.int32)
    if off is not None:
        kw["q_offset"] = torch.tensor(off, dtype=torch.int32)
    causal = route != "decode"
    if route == "prefill":
        q, k, v = q, k[:, :, :sq], v[:, :, :sq]
    got = api.flash_attn_func(q, k, v, causal=causal, window=10, **kw)
    want = attention_reference(q, k, v, causal=causal, window=10, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert (got - api.flash_attn_func(q, k, v, causal=causal, **kw)).abs().max() > 1e-3


def test_window_must_be_positive_on_the_kernel_route():
    """Window 0 would mean "none" to the kernels: the wrappers refuse it
    (and anything below 1) before the device check."""
    q = torch.empty(1, 4, 64, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="window"):
        flash_fwd.flash_attention_fwd(q, k, k, causal=True, window=0)
    with pytest.raises(ValueError, match="window"):
        flash_decode.flash_attention_decode(q[:, :, :1], k, k, window=-3)
