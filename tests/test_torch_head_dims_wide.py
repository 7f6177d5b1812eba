"""Head dims from 257 to 512 in the dense prefill P / B2 (with its lse), the
varlen B12, the chunked extend B4 (with its (o, m, l) partials), the paged
extends B6 and B9, the decodes D1 + D2, B5, B7 and B8, the paged append and
QA, against the JAX package, on the CPU (sequence-parallel attention at d
320: tests/test_torch_sequence_parallel.py).

On the card P / B2, B4, B6, B9 and B12 run a d from 257 to 512 in the wide
layout of 512 (csrc/attention_wgmma.cuh: each block computes 256 of O's
columns and recomputes S over the whole d), the decodes D1, B5, B7 and B8
in the wide layout of csrc/paged_decode.cuh (O's columns split across the
consumer warps of a block, 16-key tiles), the backward B13a / B13b (and
so the autograd op) in the layout of 512 of csrc/flash_bwd.cu
(tests/test_torch_head_dims_wide_backward.py), D2, the append and QA at
any row; rows at `_build.row_pitch(d)` (d 260 at a pitch of 264). The
int8 scores (P-i8 / B2-i8, K8) still refuse a head dim above 256, naming
ROADMAP.md A14, and so does the port's API (`dispatch.validate_inputs`,
JAX `dispatch.py`'s own refusal).
Here the plain versions, which those kernels are held to on the card, are
held to the JAX kernels in interpret mode (which keep a D above 128 native,
or pad it to 128 lanes in the varlen front end), in fp32 at atol 1e-5, as
tests/test_torch_head_dims.py does:

  * `flash_attention_fwd` at d 260, 320 and 512: causal; a window with the
    soft cap; and the lse of a causal call with rows of no key (Sq > Skv:
    zeros, lse +inf), at atol 1e-5 / 1e-4;
  * `flash_attention_varlen` at d 320 and 512, causal and windowed;
  * `flash_attention_chunked` at d 320 and 512 (causal GQA, a window of 40
    with a cap of 5, a verify-size chunk of 5 rows, rows of kv_length 0),
    its output and its partials (o unnormalised, m in log2 units, l);
  * `paged_attention_extend` at d 320 and 512 over pages of 16 tokens in a
    shuffled table, NaN past every kv_length on the port's side;
  * `flash_attention_decode` (D1 + D2) at d 320 and 512: a plain decode
    over ragged lengths, a window of 40 with a cap of 5, and a GQA group of
    64 over 1 kv head (which the kernel cuts into two chunks of 32 rows);
  * `paged_attention_decode` (B5 + D2) at d 320 and 512 over a shuffled
    table of 16-token pages, NaN past every length on the port's side;
  * `flash_attention_decode_quantized` (B7 + D2), `paged_attention_decode_
    quantized` (B8 + D2) and `paged_attention_extend_quantized` (B9) over
    int8 and e4m3 at d 320 and 512, the contiguous capacity a multiple of
    JAX's `block_kv` (its interpret mode gives NaN on a ragged e4m3 tail
    block, ROADMAP.md C), B9 over a shuffled table of 16-token pages, NaN
    scales (and e4m3 NaN values) past every length on the port's side;
  * `paged_append_layer` and QA (`quantize_append`, paged and contiguous)
    at d 320 and 512, bit-identical to JAX's `paged_append_layer`,
    `paged_append_layer_quantized` and `quantize_kv` + `_kv_write`;

The inputs are standard normal, so every score stays far inside the lazy
softmax's envelope of JAX's default `stable=True` (ROADMAP.md §C, "To
watch").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.transformer import _kv_write as jax_kv_write
from flash_attention_cute_tpu.ops import flash_varlen as jax_varlen
from flash_attention_cute_tpu.ops import paged_attention as jax_paged
from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu_torch import api, dispatch, flash_attention_varlen
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


def nan_past(pool, table, lengths, nan_byte=None):
    """NaN at and past every row's length in a pool [Hkv, P, ps, ...] (the
    port's side: uninitialised tails): fp32 values, or with `nan_byte` the
    e4m3 NaN byte into uint8 values."""
    ps = pool.shape[2]
    for row, n in enumerate(lengths):
        for slot, page in enumerate(table[row]):
            dead = max(0, min(ps, (slot + 1) * ps - n))
            if dead:
                pool[:, page, ps - dead:] = float("nan") if nan_byte is None else nan_byte


DECODE = {
    # name: (hq, hkv, window, cap)
    "plain": (4, 2, None, None),
    "window40_cap5": (4, 1, 40, 5.0),
    "group64": (64, 1, None, None),
}


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", list(DECODE), ids=list(DECODE))
def test_decode_matches_jax_kernel(case, d):
    """D1 + D2's plain version over a cache [3, Hkv, 96, d] with lengths
    96, 41 and 0 (an exact zero row) against JAX's `flash_attention_decode`
    in interpret mode, fp32 at atol 1e-5; the port's cache holds NaN past
    every length (JAX's keeps the values)."""
    hq, hkv, window, cap = DECODE[case]
    rng = np.random.default_rng(500 + d)
    q, k, v = normal(rng, 3, hq, 1, d), normal(rng, 3, hkv, 96, d), normal(rng, 3, hkv, 96, d)
    lens = np.asarray([96, 41, 0], np.int32)
    want = jax_decode(*map(jnp.asarray, (q, k, v)), kv_length=jnp.asarray(lens), window=window,
                      logit_softcap=cap, block_kv=32, interpret=True)
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    for row, n in enumerate(lens):
        kt[row, :, n:] = vt[row, :, n:] = float("nan")
    got = flash_decode.flash_attention_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
                                              window=window, logit_softcap=cap, num_splits=3)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


def shuffled_table(rng, b, pps):
    """A table of b x pps distinct pages in shuffled order, page 0 in none."""
    return (rng.permutation(b * pps) + 1).astype(np.int32).reshape(b, pps)


@pytest.mark.parametrize("d", [320, 512])
def test_paged_decode_matches_jax_kernel(d):
    """B5 + D2's plain version over pages of 16 tokens behind a shuffled
    table, lengths 64 (the whole table), 17 and 0, NaN past every length on
    the port's side, against JAX's `paged_attention_decode`."""
    ps, pps = 16, 4
    rng = np.random.default_rng(510 + d)
    q = normal(rng, 3, 4, 1, d)
    kp, vp = normal(rng, 2, 3 * pps + 1, ps, d), normal(rng, 2, 3 * pps + 1, ps, d)
    table, lens = shuffled_table(rng, 3, pps), np.asarray([64, 17, 0], np.int32)
    want = jax_paged.paged_attention_decode(*map(jnp.asarray, (q, kp, vp, lens, table)),
                                            pages_per_compute_block=2, interpret=True)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for pool in (kt, vt):
        nan_past(pool, table, lens)
    got = paged_attention.paged_attention_decode(torch.from_numpy(q), kt, vt,
                                                 *map(torch.from_numpy, (lens, table)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


QDTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
QUANT_CASES = [(d, name) for d in (320, 512) for name in QDTYPES]
QUANT_IDS = [f"d{d}_{name}" for d, name in QUANT_CASES]
# B7 and the contiguous QA, which share B8's and the paged QA's handling of
# the head dim: one value type at each d.
QUANT_HALF = [(320, "int8"), (512, "e4m3")]
QUANT_HALF_IDS = [f"d{d}_{name}" for d, name in QUANT_HALF]


def to_numpy(t):
    """A copy of t's values (JAX's arrays may share a numpy buffer, read
    after the call returns)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn).copy()
    return t.numpy().copy()


def quantized_pair(x, name):
    """One fp32 array quantized by the port (bit-identical to JAX's,
    tests/test_torch_quantized.py), as (JAX QuantizedKV, port QuantizedKV)."""
    tq = quant.quantize_kv(torch.from_numpy(x), QDTYPES[name][0])
    return jax_q.QuantizedKV(jnp.asarray(to_numpy(tq.values)), jnp.asarray(to_numpy(tq.scales))), tq


def poison_quantized(kv, table, lengths):
    """NaN scales past every length of a quantized pool, and the e4m3 NaN
    byte in its values there (int8 has no NaN)."""
    nan_past(kv.scales, table, lengths)
    if kv.values.dtype == torch.float8_e4m3fn:
        nan_past(kv.values.view(torch.uint8), table, lengths, 0x7F)


@pytest.mark.parametrize("d, name", QUANT_HALF, ids=QUANT_HALF_IDS)
def test_quant_decode_matches_jax_kernel(d, name):
    """B7 + D2's plain version over a contiguous cache of capacity 128 (one
    of JAX's block_kv), lengths 128, 41 and 0, a window of 100, against
    JAX's `flash_attention_decode_quantized`."""
    rng = np.random.default_rng(520 + d)
    q = normal(rng, 3, 4, 1, d)
    jk, tk = quantized_pair(normal(rng, 3, 2, 128, d), name)
    jv, tv = quantized_pair(normal(rng, 3, 2, 128, d), name)
    lens = np.asarray([128, 41, 0], np.int32)
    want = jax_q.flash_attention_decode_quantized(jnp.asarray(q), jk, jv,
                                                  kv_length=jnp.asarray(lens), window=100,
                                                  block_kv=128, interpret=True)
    got = quant.flash_attention_decode_quantized(torch.from_numpy(q), tk, tv,
                                                 torch.from_numpy(lens), window=100)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


def quant_pools(rng, d, b, ps, pps, name):
    """Quantized pools [2, b pps + 1, ps, d] (JAX and port) behind a
    shuffled table."""
    pools = [quantized_pair(normal(rng, 2, b * pps + 1, ps, d), name) for _ in "kv"]
    return pools, shuffled_table(rng, b, pps)


@pytest.mark.parametrize("d, name", QUANT_CASES, ids=QUANT_IDS)
def test_quant_paged_decode_matches_jax_kernel(d, name):
    """B8 + D2's plain version over pages of 16 tokens, lengths 64, 17 and
    0, the cap 5, NaN past every length on the port's side, against JAX's
    `paged_attention_decode_quantized`."""
    rng = np.random.default_rng(530 + d)
    ((jk, tk), (jv, tv)), table = quant_pools(rng, d, 3, 16, 4, name)
    q, lens = normal(rng, 3, 4, 1, d), np.asarray([64, 17, 0], np.int32)
    want = jax_q.paged_attention_decode_quantized(
        jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.asarray(table), logit_softcap=5.0,
        pages_per_compute_block=2, interpret=True)
    for kv in (tk, tv):
        poison_quantized(kv, table, lens)
    got = quant.paged_attention_decode_quantized(torch.from_numpy(q), tk, tv,
                                                 *map(torch.from_numpy, (lens, table)),
                                                 logit_softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d, name", QUANT_CASES, ids=QUANT_IDS)
def test_quant_paged_extend_matches_jax_kernel(d, name):
    """B9's plain version: chunks of 24 rows at offsets 0 and 60 and an
    inactive row over pages of 16 tokens behind a shuffled table, NaN past
    every kv_length on the port's side, against JAX's
    `paged_attention_extend_quantized`."""
    rng = np.random.default_rng(540 + d)
    ((jk, tk), (jv, tv)), table = quant_pools(rng, d, 3, 16, 6, name)
    q = normal(rng, 3, 4, 24, d)
    off, kvl = np.asarray([0, 60, 30], np.int32), np.asarray([24, 84, 0], np.int32)
    want = jax_q.paged_attention_extend_quantized(
        jnp.asarray(q), jk, jv, *map(jnp.asarray, (off, kvl, table)),
        pages_per_compute_block=2, interpret=True)
    for kv in (tk, tv):
        poison_quantized(kv, table, kvl)
    got = quant.paged_attention_extend_quantized(torch.from_numpy(q), tk, tv,
                                                 *map(torch.from_numpy, (off, kvl, table)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


# The appends: a row at its table's start, one mid-page, one across the end
# of its table (positions past it are dropped) and an inactive row.
APPEND_TABLE = np.array([[5, 9, 2, 14], [1, 7, 11, 3], [16, 4, 6, 8], [10, 12, 13, 15]], np.int32)
APPEND_LENGTHS = np.asarray([0, 9, 62, 30], np.int32)
APPEND_ACTIVE = np.asarray([True, True, True, False])


@pytest.mark.parametrize("d", [320, 512])
def test_paged_append_bit_identical_to_jax(d):
    """`paged_append_layer` of 3 tokens a row through pages of 16 writes
    the pools JAX's `paged_append_layer` writes, bit for bit."""
    rng = np.random.default_rng(550 + d)
    kp, vp = normal(rng, 2, 17, 16, d), normal(rng, 2, 17, 16, d)
    k_new, v_new = normal(rng, 4, 2, 3, d), normal(rng, 4, 2, 3, d)
    want = jax_cache.paged_append_layer(*map(jnp.asarray, (kp, vp, k_new, v_new, APPEND_TABLE,
                                                           APPEND_LENGTHS, APPEND_ACTIVE)))
    got = paged_cache.paged_append_layer(*map(torch.from_numpy, (
        kp.copy(), vp.copy(), k_new, v_new, APPEND_TABLE, APPEND_LENGTHS, APPEND_ACTIVE)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def assert_same_bytes(got: torch.Tensor, want):
    want = np.asarray(want)
    if got.dtype == torch.float8_e4m3fn:
        got, want = got.view(torch.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d, name, paged", [(d, n, True) for d, n in QUANT_CASES]
                         + [(d, n, False) for d, n in QUANT_HALF],
                         ids=[f"{i}-paged" for i in QUANT_IDS]
                         + [f"{i}-contiguous" for i in QUANT_HALF_IDS])
def test_quantize_append_bit_identical_to_jax(d, name, paged):
    """QA of 3 tokens a row writes the values and scales JAX writes, bit
    for bit: through pages of 16 (`paged_append_layer_quantized`), or into
    a contiguous cache [4, 2, 72, d] (`quantize_kv` + `_kv_write`, the
    transformer's write)."""
    rng = np.random.default_rng(560 + d)
    shape = (2, 17, 16, d) if paged else (4, 2, 72, d)
    (jk, tk), (jv, tv) = (quantized_pair(normal(rng, *shape), name) for _ in "kv")
    k_new, v_new = normal(rng, 4, 2, 3, d), normal(rng, 4, 2, 3, d)
    if paged:
        want = [jax_cache.paged_append_layer_quantized(
            (slab.values, slab.scales), jnp.asarray(new), jnp.asarray(APPEND_TABLE),
            jnp.asarray(APPEND_LENGTHS), jnp.asarray(APPEND_ACTIVE))
            for slab, new in ((jk, k_new), (jv, v_new))]
        quant.quantize_append(torch.from_numpy(k_new), torch.from_numpy(v_new), tk, tv,
                              *map(torch.from_numpy, (APPEND_LENGTHS, APPEND_TABLE,
                                                      APPEND_ACTIVE)))
    else:
        lens = jnp.asarray(APPEND_LENGTHS)
        want = []
        for slab, new in ((jk, k_new), (jv, v_new)):
            nq = jax_q.quantize_kv(jnp.asarray(new), QDTYPES[name][1])
            want.append((jax_kv_write(slab.values[None], nq.values, 0, lens)[0],
                         jax_kv_write(slab.scales[None], nq.scales, 0, lens)[0]))
        quant.quantize_append(torch.from_numpy(k_new), torch.from_numpy(v_new), tk, tv,
                              torch.from_numpy(APPEND_LENGTHS))
    for got, (vals, scales) in zip((tk, tv), want):
        assert_same_bytes(got.values, vals)
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(scales))


@pytest.mark.parametrize("d", [257, 260, 264, 320, 384, 500, 512])
def test_rule_takes_257_to_512_in_the_slice_kernels_only(d):
    """P / B2, B4 (and its partials), B6, B9, B12, the decodes D1 + D2, B5,
    B7 and B8, the append and QA (`wide`) run d in the layout of 512, rows
    at a whole 16 bytes (one-byte rows too), B6 / B9 over 32-key tiles, the
    decodes over 16-key tiles copied in parts of 16 keys; every other
    kernel of the rule (`wide` False) still raises above 256, and the wide
    layout above 512, naming ROADMAP.md A14."""
    for elem in (2, 1):
        assert _build.padded_head_dim(d, "decode", elem, wide=True) == 512
        pitch = _build.row_pitch(d, elem)
        assert pitch * elem % 16 == 0 and d <= pitch < d + 16 // elem
    assert paged_attention.extend_plan(d, 16) == (32, 16)
    assert paged_attention.extend_plan(d, 64) == (32, 32)
    assert dispatch.decode_tile(d) == 16
    for ps in (8, 16, 64):
        assert paged_attention.decode_plan(d, ps) == (16, min(ps, 16))
    for elem in (2, 1):
        with pytest.raises(NotImplementedError, match=r"from 1 to 256.*ROADMAP\.md A14"):
            _build.padded_head_dim(d, "K8", elem)
    with pytest.raises(NotImplementedError, match=r"from 1 to 512.*ROADMAP\.md A14"):
        _build.padded_head_dim(d + 256, "prefill", wide=True)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def slice_calls(d):
    """The entry points of the wide layouts' kernels at head dim d on the
    `meta` device, where no kernel runs: a d they take reaches the kernel
    route's CUDA-tensor check."""
    q, k = meta(1, 4, 64, d), meta(1, 1, 64, d)
    cu = torch.tensor([0, 64], dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    qx, kx, pool = meta(2, 4, 5, d), meta(2, 2, 64, d), meta(2, 9, 16, d)
    qd = qx[:, :, :1]
    qpool = QuantizedKV(meta(2, 9, 16, d, dtype=torch.int8), meta(2, 9, 16, dtype=torch.float32))
    qcache = QuantizedKV(meta(2, 2, 64, d, dtype=torch.int8), meta(2, 2, 64, dtype=torch.float32))
    lse = meta(1, 4, 64, dtype=torch.float32)
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
        "B9": lambda: quant.paged_attention_extend_quantized(qx, qpool, qpool, rows, rows + 5,
                                                             table),
        "D1 + D2": lambda: flash_decode.flash_attention_decode(qd, kx, kx, rows),
        "B5": lambda: paged_attention.paged_attention_decode(qd, pool, pool, rows, table),
        "B7": lambda: quant.flash_attention_decode_quantized(qd, qcache, qcache, rows),
        "B8": lambda: quant.paged_attention_decode_quantized(qd, qpool, qpool, rows, table),
        "append": lambda: paged_cache.paged_append_layer(pool, pool, kx[:, :, :1], kx[:, :, :1],
                                                         table, rows),
        "QA": lambda: quant.quantize_append(qx[:, :2, :1], qx[:, :2, :1], qcache, qcache, rows),
        "B13a / B13b": lambda: flash_bwd.flash_attention_bwd(q, k, k, q, q, lse, causal=True),
        "autograd op": lambda: autodiff.flash_attention(q.requires_grad_(), k, k, causal=True),
    }


def other_calls(d):
    """Every other kernel's entry point at head dim d on the `meta` device."""
    q, k = meta(2, 4, 5, d), meta(2, 2, 64, d)
    return {
        "P-i8": lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True, score_dtype="int8"),
        "K8": lambda: flash_fwd.quantize_k_rows(k),
    }


@pytest.mark.parametrize("d", [264, 512])
def test_entry_points_take_or_refuse_each_kernel(d):
    """Off the CPU the wide layouts' entry points (P / B2, B12, B4 with its
    partials and B6, and since the decodes and B9 took it, D1 + D2, B5, B7,
    B8, B9, the append and QA, and since the backward took it B13a / B13b
    and the autograd op) take d 264 and 512 (up to the CUDA-tensor check)
    and refuse 520; every other kernel's entry point (the int8 scores)
    raises at d 264 and 512, naming ROADMAP.md A14, before any launch; the
    API keeps JAX's own refusal above 256 on every device."""
    for name, call in slice_calls(d).items():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    for name, call in slice_calls(520).items():
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
            call()
    for name, call in other_calls(d).items():
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
            call()
    # D2 alone, which checks no device itself: d 264 and 512 reach the
    # launch's device, 520 is refused.
    def combine(dd):
        m = meta(2, 2, 3, 2, dtype=torch.float32)
        return flash_decode.decode_combine(meta(2, 2, 3, 2, dd, dtype=torch.float32), m, m,
                                           torch.bfloat16)

    with pytest.raises(ValueError, match="cuda device"):
        combine(d)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        combine(520)
    for device in ("meta", "cpu"):
        q = torch.zeros(1, 4, 8, d, device=device)
        with pytest.raises(ValueError, match=f"head_dim {d} > 256 unsupported"):
            api.flash_attn_func(q, q[:, :1], q[:, :1], causal=True)
