"""Head dims from 257 to 512 in the dense prefill P / B2 (with its lse), the
varlen B12, the chunked extend B4 (with its (o, m, l) partials) and the
paged extend B6, against the JAX package, on the CPU (sequence-parallel
attention at d 320: tests/test_torch_sequence_parallel.py).

On the card P / B2, B4, B6 and B12 run a d from 257 to 512 in the wide
layout of 512 (csrc/attention_wgmma.cuh: each block computes 256 of O's
columns and recomputes S over the whole d), rows at `_build.row_pitch(d)`
(d 260 at a pitch of 264); every other kernel still refuses a head dim
above 256, naming ROADMAP.md A14, and so do the port's API
(`dispatch.validate_inputs`, JAX `dispatch.py`'s own refusal) and the
autograd op. Here the plain versions, which those kernels are held to on
the card, are held to the JAX kernels in interpret mode (which keep a D
above 128 native, or pad it to 128 lanes in the varlen front end), in fp32
at atol 1e-5, as tests/test_torch_head_dims.py does:

  * `flash_attention_fwd` at d 260, 320 and 512: causal; a window with the
    soft cap; and the lse of a causal call with rows of no key (Sq > Skv:
    zeros, lse +inf), at atol 1e-5 / 1e-4;
  * `flash_attention_varlen` at d 320 and 512, causal and windowed;
  * `flash_attention_chunked` at d 320 and 512 (causal GQA, a window of 40
    with a cap of 5, a verify-size chunk of 5 rows, rows of kv_length 0),
    its output and its partials (o unnormalised, m in log2 units, l);
  * `paged_attention_extend` at d 320 and 512 over pages of 16 tokens in a
    shuffled table, NaN past every kv_length on the port's side;

The inputs are standard normal, so every score stays far inside the lazy
softmax's envelope of JAX's default `stable=True` (ROADMAP.md §C, "To
watch").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops import flash_varlen as jax_varlen
from flash_attention_cute_tpu.ops import paged_attention as jax_paged
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu_torch import api, flash_attention_varlen
from flash_attention_cute_tpu_torch.ops import (
    _build,
    autodiff,
    flash_bwd,
    flash_chunked,
    flash_decode,
    flash_fwd,
    paged_attention,
)
from flash_attention_cute_tpu_torch.ops import quantized as quant
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import paged_cache

WIDE_DIMS = (260, 320, 512)

PREFILL = {
    # name: (hq, hkv, sq, skv, causal, window, cap, return_lse)
    "causal_gqa": (4, 2, 96, 96, True, None, None, False),
    "window_cap": (4, 1, 96, 96, True, 40, 5.0, False),
    "lse_rows_of_no_key": (2, 2, 96, 64, True, None, None, True),
}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("case", list(PREFILL), ids=list(PREFILL))
def test_prefill_matches_jax_kernel(case, d):
    hq, hkv, sq, skv, causal, window, cap, with_lse = PREFILL[case]
    rng = np.random.default_rng(d)
    q, k, v = normal(rng, 1, hq, sq, d), normal(rng, 1, hkv, skv, d), normal(rng, 1, hkv, skv, d)
    kw = dict(causal=causal, window=window, logit_softcap=cap, return_lse=with_lse)
    want = jax_fwd(*map(jnp.asarray, (q, k, v)), interpret=True, **kw)
    got = flash_fwd.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    if not with_lse:
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        return
    (out, lse), (want_out, want_lse) = got, want
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    want_lse = np.asarray(want_lse)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], atol=1e-4, rtol=0)
    dead = sq - skv  # rows with no key: exact zeros, lse +inf
    assert (out[:, :, :dead] == 0).all() and torch.isinf(lse[:, :, :dead]).all()


VARLEN = {
    # name: (q lengths, kv lengths (None: q's), hq, hkv, causal, window)
    "causal_gqa": ([50, 1, 77], None, 4, 2, True, None),
    "cross_window": ([24, 60], [40, 30], 2, 1, True, 16),
}


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", list(VARLEN), ids=list(VARLEN))
def test_varlen_matches_jax_kernel(case, d):
    lens_q, lens_kv, hq, hkv, causal, window = VARLEN[case]
    lens_kv = lens_kv or lens_q
    rng = np.random.default_rng(200 + d)
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


CHUNKED = {
    # name: (b, hq, hkv, s, capacity, q_offset, kv_length (None: q_offset
    #        + s), window, cap), every case causal
    "causal_gqa": (2, 4, 2, 24, 96, [0, 50], None, None, None),
    "window40_cap5": (2, 4, 1, 24, 96, [10, 60], None, 40, 5.0),
    "verify_chunk": (2, 8, 1, 5, 96, [40, 90], None, None, None),
    "kv_length_zero": (3, 4, 2, 8, 64, [0, 0, 20], [0, 8, 28], None, None),
}


@pytest.mark.parametrize("partials", [False, True], ids=["output", "partials"])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", list(CHUNKED), ids=list(CHUNKED))
def test_chunked_matches_jax_kernel(case, d, partials):
    """B4's plain version (and its partials: o unnormalised, m in log2
    units, l) against JAX's `flash_attention_chunked` in interpret mode,
    fp32 at atol 1e-5, and the partials' unnormalised o and l (sums that
    grow with the visible keys) also at rtol 1e-5; a row
    of kv_length 0 is exact zeros (m = l = 0)."""
    b, hq, hkv, s, cap, offs, kvl, window, softcap = CHUNKED[case]
    rng = np.random.default_rng(300 + d)
    q, k, v = normal(rng, b, hq, s, d), normal(rng, b, hkv, cap, d), normal(rng, b, hkv, cap, d)
    offs = np.asarray(offs, np.int32)
    kvl = offs + s if kvl is None else np.asarray(kvl, np.int32)
    kw = dict(causal=True, window=window, logit_softcap=softcap, return_partials=partials)
    want = jax_chunked(*map(jnp.asarray, (q, k, v, offs, kvl)), interpret=True, **kw)
    got = flash_chunked.flash_attention_chunked(*map(torch.from_numpy, (q, k, v, offs, kvl)),
                                                **kw)
    if not partials:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # o (or o_unnorm), then m, then l
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5 if partials else 0)
    for i, n in enumerate(kvl):
        if n == 0:
            assert all((x[i] == 0).all() for x in got)


@pytest.mark.parametrize("window", [None, 40], ids=["causal", "window40"])
@pytest.mark.parametrize("d", [320, 512])
def test_paged_extend_matches_jax_kernel(d, window):
    """B6's plain version against JAX's `paged_attention_extend` in
    interpret mode over pages of 16 tokens in a shuffled table, fp32 at
    atol 1e-5; the port's pools hold NaN past every kv_length (JAX's
    zeros), and the inactive row is exact zeros."""
    ps, pps = 16, 6
    rng = np.random.default_rng(400 + d)
    q = normal(rng, 3, 4, 24, d)
    kp, vp = normal(rng, 2, 3 * pps + 1, ps, d), normal(rng, 2, 3 * pps + 1, ps, d)
    table = (rng.permutation(3 * pps) + 1).astype(np.int32).reshape(3, pps)
    off, kvl = np.asarray([0, 60, 30], np.int32), np.asarray([24, 84, 0], np.int32)
    want = jax_paged.paged_attention_extend(*map(jnp.asarray, (q, kp, vp, off, kvl, table)),
                                            window=window, pages_per_compute_block=2,
                                            interpret=True)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for row, n in enumerate(kvl):  # positions at and past kv_length hold NaN on the port's side
        for slot, page in enumerate(table[row]):
            dead = max(0, min(ps, (slot + 1) * ps - n))
            if dead:
                kt[:, page, ps - dead:] = vt[:, page, ps - dead:] = float("nan")
    got = paged_attention.paged_attention_extend(
        torch.from_numpy(q), kt, vt, *map(torch.from_numpy, (off, kvl, table)), window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d", [257, 260, 264, 320, 384, 500, 512])
def test_rule_takes_257_to_512_in_the_slice_kernels_only(d):
    """P / B2, B4 (and its partials), B6 and B12 (`wide`) run d in the
    layout of 512, rows at a whole 16 bytes, B6 over 32-key tiles; every
    other kernel of the rule still raises above 256, and the wide layout
    above 512, naming ROADMAP.md A14."""
    assert _build.padded_head_dim(d, "prefill", wide=True) == 512
    assert paged_attention.extend_plan(d, 16) == (32, 16)
    assert paged_attention.extend_plan(d, 64) == (32, 32)
    pitch = _build.row_pitch(d)
    assert pitch * 2 % 16 == 0 and d <= pitch < d + 8
    for elem in (2, 1):
        with pytest.raises(NotImplementedError, match=r"from 1 to 256.*ROADMAP\.md A14"):
            _build.padded_head_dim(d, "decode", elem)
    with pytest.raises(NotImplementedError, match=r"from 1 to 512.*ROADMAP\.md A14"):
        _build.padded_head_dim(d + 256, "prefill", wide=True)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def slice_calls(d):
    """The entry points of the wide layout's kernels at head dim d on the
    `meta` device, where no kernel runs: a d they take reaches the kernel
    route's CUDA-tensor check."""
    q, k = meta(1, 4, 64, d), meta(1, 1, 64, d)
    cu = torch.tensor([0, 64], dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    qx, kx, pool = meta(2, 4, 5, d), meta(2, 2, 64, d), meta(2, 9, 16, d)
    return {
        "P": lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True),
        "P lse": lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True, return_lse=True),
        "B2 cap": lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True, window=8,
                                                        logit_softcap=50.0),
        "B12": lambda: flash_attention_varlen(q[0].transpose(0, 1), k[0].transpose(0, 1),
                                              k[0].transpose(0, 1), cu, causal=True),
        "B4": lambda: flash_chunked.flash_attention_chunked(qx, kx, kx, rows, rows),
        "B4 partials": lambda: flash_chunked.flash_attention_chunked(qx, kx, kx, rows, rows,
                                                                     return_partials=True),
        "B6": lambda: paged_attention.paged_attention_extend(qx, pool, pool, rows, rows + 5,
                                                             table),
    }


def other_calls(d):
    """Every other kernel's entry point at head dim d on the `meta` device."""
    q, k = meta(2, 4, 5, d), meta(2, 2, 64, d)
    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    pool = meta(2, 9, 16, d)
    qpool = QuantizedKV(meta(2, 9, 16, d, dtype=torch.int8), meta(2, 9, 16, dtype=torch.float32))
    qcache = QuantizedKV(meta(2, 2, 64, d, dtype=torch.int8), meta(2, 2, 64, dtype=torch.float32))
    lse = meta(2, 4, 5, dtype=torch.float32)
    return {
        "P-i8": lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True, score_dtype="int8"),
        "K8": lambda: flash_fwd.quantize_k_rows(k),
        "D1 + D2": lambda: flash_decode.flash_attention_decode(q[:, :, :1], k, k, rows),
        "B5": lambda: paged_attention.paged_attention_decode(q[:, :, :1], pool, pool, rows,
                                                             table),
        "append": lambda: paged_cache.paged_append_layer(pool, pool, k[:, :, :1], k[:, :, :1],
                                                         table, rows),
        "B7": lambda: quant.flash_attention_decode_quantized(q[:, :, :1], qcache, qcache, rows),
        "B8": lambda: quant.paged_attention_decode_quantized(q[:, :, :1], qpool, qpool, rows,
                                                             table),
        "B9": lambda: quant.paged_attention_extend_quantized(q, qpool, qpool, rows, rows + 5,
                                                             table),
        "QA": lambda: quant.quantize_append(q[:, :2, :1], q[:, :2, :1], qcache, qcache, rows),
        "B13a / B13b": lambda: flash_bwd.flash_attention_bwd(q, k, k, q, q, lse, causal=True),
        "autograd op": lambda: autodiff.flash_attention(q.requires_grad_(), k, k, causal=True),
    }


@pytest.mark.parametrize("d", [264, 512])
def test_entry_points_take_or_refuse_each_kernel(d):
    """Off the CPU the wide layout's entry points (P / B2, B12, and since
    B4 with its partials and B6 took it, theirs) take d 264 and 512 (up to
    the CUDA-tensor check) and refuse 520; every other kernel's entry
    point (B9 among them) raises at d 264 and 512, naming ROADMAP.md A14,
    before any launch; the API keeps JAX's own refusal above 256 on every
    device."""
    for name, call in slice_calls(d).items():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    for name, call in slice_calls(520).items():
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
            call()
    for name, call in other_calls(d).items():
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
            call()
    for device in ("meta", "cpu"):
        q = torch.zeros(1, 4, 8, d, device=device)
        with pytest.raises(ValueError, match=f"head_dim {d} > 256 unsupported"):
            api.flash_attn_func(q, q[:, :1], q[:, :1], causal=True)
