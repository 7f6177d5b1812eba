"""The port's quantized-KV ops against the JAX package, on the CPU.

Inputs come from numpy seeds and reach both sides as the same arrays; e4m3
values cross as bytes (torch.from_numpy takes no float8 array). The JAX
kernels run in interpret mode (its own tests' CPU route); the port's CPU
tensors take the plain versions of kernels B7, B8, B9 and QA. Tolerances:
`quantize_kv` and the appends must be bit-identical to JAX's; attention
agrees to 2e-5 absolute at fp32 (the same scores summed in another order).
The CUDA kernels take the window, the soft cap (QA has none to take) and
head dim 256; B7 and B8 GQA groups up to 32. The plain versions take them
too and are held to the JAX kernels with them (B7 also at a group of 24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu_torch.ops import quantized as q
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import paged_cache

ATOL = 2e-5
DTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
TORCH_OF = {j: t for t, j in DTYPES.values()}


def to_numpy(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


def quantized_pair(x, jdtype):
    """One fp32 array quantized (by the port: bit-identical to JAX's, see
    the first test), as (JAX QuantizedKV, port QuantizedKV)."""
    tq = q.quantize_kv(torch.from_numpy(x), TORCH_OF[jdtype])
    jq = jax_q.QuantizedKV(jnp.asarray(to_numpy(tq.values)), jnp.asarray(tq.scales.numpy()))
    return jq, tq


def assert_same_bytes(got: torch.Tensor, want):
    want = np.asarray(want)
    if got.dtype == torch.float8_e4m3fn:
        got, want = got.view(torch.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(DTYPES))
def test_quantize_kv_bit_identical_to_jax(name):
    tdtype, jdtype = DTYPES[name]
    x = 3.0 * np.random.default_rng(0).standard_normal((2, 4, 64, 32), dtype=np.float32)
    x[0, 1, :5] = 0.0  # all-zero rows: scale 1, values 0
    x[1, 2, 7] = -0.0
    x[1, 3, 9, ::2] = 0.5  # exact halves of a quantum: round half to even
    want = jax_q.quantize_kv(jnp.asarray(x), jdtype)
    got = q.quantize_kv(torch.from_numpy(x), tdtype)
    assert got.values.dtype == tdtype and got.scales.dtype == torch.float32
    assert_same_bytes(got.values, want.values)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert (got.scales[0, 1, :5] == 1).all()
    np.testing.assert_array_equal(q.dequantize_kv(got).numpy(),
                                  np.asarray(jax_q.dequantize_kv(want)))
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        q.quantize_kv(torch.from_numpy(x), torch.float8_e5m2)


DECODE = {
    # name: (dtype, b, hq, hkv, cap, lengths, window, softcap, layers, head_dim). The
    # e4m3 capacities at D 256 are multiples of block_kv (ROADMAP.md C: the
    # JAX kernel's interpret mode gives NaN on an e4m3 tail block).
    "e4m3_len0_len1": ("e4m3", 3, 8, 2, 256, [0, 1, 200], None, None, 0, 64),
    "int8_stacked_layer1": ("int8", 2, 8, 2, 192, [150, 192], None, None, 3, 64),
    "int8_window_softcap": ("int8", 2, 8, 2, 256, [200, 77], 50, 10.0, 0, 64),
    "int8_d256_cap50": ("int8", 2, 4, 2, 200, [200, 77], None, 50.0, 0, 256),
    "int8_d256_cap1_window_stacked": ("int8", 2, 4, 2, 160, [150, 33], 24, 1.0, 2, 256),
    "e4m3_d256_cap50": ("e4m3", 2, 4, 2, 256, [250, 0], None, 50.0, 0, 256),
    "e4m3_d256_cap1_window": ("e4m3", 2, 4, 2, 256, [256, 90], 40, 1.0, 0, 256),
    "int8_group24": ("int8", 2, 48, 2, 192, [192, 50], None, None, 0, 64),
}


@pytest.mark.parametrize("case", list(DECODE))
def test_quant_decode_plain_matches_jax_kernel(case):
    name, b, hq, hkv, cap, lens, window, softcap, layers, d = DECODE[case]
    rng = np.random.default_rng(len(case))
    lead = (layers,) if layers else ()
    qa = rng.standard_normal((b, hq, 1, d), dtype=np.float32)
    jk, tk = quantized_pair(rng.standard_normal(lead + (b, hkv, cap, d), dtype=np.float32),
                            DTYPES[name][1])
    jv, tv = quantized_pair(rng.standard_normal(lead + (b, hkv, cap, d), dtype=np.float32),
                            DTYPES[name][1])
    lengths = np.asarray(lens, np.int32)
    layer = 1 if layers else None
    want = jax_q.flash_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, kv_length=jnp.asarray(lengths), window=window,
        logit_softcap=softcap, block_kv=128, layer=None if layer is None else jnp.int32(layer),
        interpret=True,
    )
    got = q.flash_attention_decode_quantized(torch.from_numpy(qa), tk, tv,
                                             torch.from_numpy(lengths), window=window,
                                             logit_softcap=softcap, layer=layer)
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert (got[i] == 0).all()


def paged_pools(seed, b, hkv, pps, ps, jdtype, d=64):
    """Quantized pools [Hkv, P, ps, D] (JAX and port) behind a table of
    distinct shuffled pages, page 0 in no table."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    jk, tk = quantized_pair(rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32), jdtype)
    jv, tv = quantized_pair(rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32), jdtype)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return (jk, jv), (tk, tv), table, rng


PAGED_DECODE = {
    # name: (dtype, hq, hkv, ps, pps, lengths, window, softcap)
    "int8_ragged": ("int8", 8, 2, 16, 4, [40, 17], None, None),
    "e4m3_len0": ("e4m3", 8, 2, 16, 4, [33, 0], None, None),
    "int8_window_softcap": ("int8", 8, 2, 16, 6, [90, 33], 40, 10.0),
}


@pytest.mark.parametrize("case", list(PAGED_DECODE))
def test_quant_paged_decode_plain_matches_jax_kernel(case):
    name, hq, hkv, ps, pps, lens, window, softcap = PAGED_DECODE[case]
    b = len(lens)
    (jk, jv), (tk, tv), table, rng = paged_pools(len(case), b, hkv, pps, ps, DTYPES[name][1])
    qa = rng.standard_normal((b, hq, 1, 64), dtype=np.float32)
    lengths = np.asarray(lens, np.int32)
    want = jax_q.paged_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(lengths), jnp.asarray(table), window=window,
        logit_softcap=softcap, pages_per_compute_block=2, interpret=True,
    )
    got = q.paged_attention_decode_quantized(torch.from_numpy(qa), tk, tv,
                                             torch.from_numpy(lengths), torch.from_numpy(table),
                                             window=window, logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert (got[i] == 0).all()


def poisoned_copy(kv: QuantizedKV, table, lens) -> QuantizedKV:
    """A copy of one pool with NaN scales (and the e4m3 NaN byte 0x7F) at
    and past each row's length and in page 0, which no table holds."""
    out = QuantizedKV(kv.values.clone(), kv.scales.clone())
    hkv, num_pages, ps, d = out.values.shape
    pps = table.shape[1]
    dead = np.concatenate([table[b, np.arange(n, pps * ps) // ps] * ps + np.arange(n, pps * ps) % ps
                           for b, n in enumerate(lens)] + [np.arange(ps)])
    out.scales.view(hkv, -1)[:, dead] = float("nan")
    if out.values.dtype == torch.float8_e4m3fn:
        out.values.view(torch.uint8).view(hkv, -1, d)[:, dead] = 0x7F
    return out


@pytest.mark.parametrize("name", list(DTYPES))
def test_quant_paged_decode_plain_at_d256_with_cap_matches_jax_kernel(name):
    """B8's plain version at Gemma-2-9B's head dim 256 with a cap of 1.0,
    which binds on every score, at GQA group 2 (the twin of the bf16 test in
    tests/test_torch_gemma2.py). The port's pools are NaN at and past every
    length and in page 0; JAX's are not (its kernel multiplies a dead key's
    zero probability by the key's V scale). Lengths 64 (the full table), 17
    and 0; the pool's 4 pages a row are two of JAX's compute blocks."""
    (jk, jv), (tk, tv), table, rng = paged_pools(40, 3, 2, 4, 16, DTYPES[name][1], d=256)
    lens = np.asarray([64, 17, 0], np.int32)
    qa = rng.standard_normal((3, 4, 1, 256), dtype=np.float32)
    want = jax_q.paged_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(lens), jnp.asarray(table), logit_softcap=1.0,
        pages_per_compute_block=2, interpret=True)
    args = (torch.from_numpy(qa), poisoned_copy(tk, table, lens), poisoned_copy(tv, table, lens),
            torch.from_numpy(lens), torch.from_numpy(table))
    got = q.paged_attention_decode_quantized(*args, logit_softcap=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()
    assert (got - q.paged_attention_decode_quantized(*args)).abs().max() > 1e-2


@pytest.mark.parametrize("name", list(DTYPES))
def test_quantize_append_paged_at_d256_bit_identical_to_jax(name):
    """QA's plain version at head dim 256 through a page table (a row past
    its table's end, an inactive row): the bytes and scales JAX's
    `quantize_kv` + scatter write."""
    jdtype = DTYPES[name][1]
    rng = np.random.default_rng(14)
    hkv, ps, s = 2, 8, 3
    (jk, jv), (tk, tv), _, _ = paged_pools(15, 4, hkv, 4, ps, jdtype, d=256)
    table = np.array([[5, 9, 2, 14], [1, 7, 11, 3], [16, 4, 6, 8], [10, 12, 13, 15]], np.int32)
    k_new = rng.standard_normal((4, hkv, s, 256), dtype=np.float32)
    v_new = rng.standard_normal((4, hkv, s, 256), dtype=np.float32)
    lengths, active = np.asarray([3, 0, 31, 9], np.int32), np.asarray([True, True, True, False])
    want = [jax_cache.paged_append_layer_quantized(
        (slab.values, slab.scales), jnp.asarray(new), jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(active)) for slab, new in ((jk, k_new), (jv, v_new))]
    q.quantize_append(torch.from_numpy(k_new), torch.from_numpy(v_new), tk, tv,
                      torch.from_numpy(lengths), torch.from_numpy(table),
                      torch.from_numpy(active))
    for got, (vals, scales) in zip((tk, tv), want):
        assert_same_bytes(got.values, vals)
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(scales))


PAGED_EXTEND = {
    # name: (dtype, hq, sq, ps, pps, q_offset, kv_length, window, softcap, head_dim)
    "int8_offsets": ("int8", 4, 16, 8, 16, [50, 17], [66, 33], None, None, 64),
    "e4m3_offsets": ("e4m3", 4, 16, 8, 16, [0, 40], [16, 56], None, None, 64),
    "int8_window_softcap_inactive": ("int8", 8, 8, 8, 16, [60, 0, 4], [68, 0, 12], 24, 10.0, 64),
    "int8_d256_window_softcap": ("int8", 4, 16, 16, 8, [60, 3], [76, 19], 24, 50.0, 256),
    "e4m3_d256_softcap_inactive": ("e4m3", 4, 8, 16, 8, [17, 0, 40], [25, 0, 48], None, 1.0,
                                   256),
}


@pytest.mark.parametrize("case", list(PAGED_EXTEND))
def test_quant_paged_extend_plain_matches_jax_kernel(case):
    name, hq, sq, ps, pps, offs, kvl, window, softcap, d = PAGED_EXTEND[case]
    b = len(offs)
    (jk, jv), (tk, tv), table, rng = paged_pools(len(case) + 100, b, 2, pps, ps,
                                                 DTYPES[name][1], d)
    qa = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    off, kvl = np.asarray(offs, np.int32), np.asarray(kvl, np.int32)
    want = jax_q.paged_attention_extend_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(off), jnp.asarray(kvl), jnp.asarray(table),
        window=window, logit_softcap=softcap, pages_per_compute_block=2, interpret=True,
    )
    got, clamps = q.paged_attention_extend_quantized(
        torch.from_numpy(qa), tk, tv, torch.from_numpy(off), torch.from_numpy(kvl),
        torch.from_numpy(table), window=window, logit_softcap=softcap, return_clamps=True)
    assert clamps == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i, n in enumerate(kvl):
        if n == 0:
            assert (got[i] == 0).all()


def test_cuda_routes_take_or_refuse_the_cap_and_d256():
    """Off the CPU (here the `meta` device, on which no kernel runs) B7, B8
    and B9 take the soft cap, head dim 256 and B7 / B8 groups of 32 and
    above (34: two chunks of 17 q rows), and stop only at the CUDA-tensor
    check."""
    meta = torch.device("meta")
    qm = torch.empty(2, 16, 8, 256, dtype=torch.bfloat16, device=meta)
    kv = QuantizedKV(torch.empty(8, 9, 16, 256, dtype=torch.int8, device=meta),
                     torch.empty(8, 9, 16, device=meta))
    rows = torch.zeros(2, dtype=torch.int32, device=meta)
    table = torch.zeros(2, 4, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        q.paged_attention_extend_quantized(qm, kv, kv, rows, rows, table, window=45,
                                           logit_softcap=50.0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        q.paged_attention_decode_quantized(qm[:, :, :1], kv, kv, rows, table, logit_softcap=50.0)
    q32 = torch.empty(2, 8 * 32, 1, 256, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # D 256, group 32
        q.paged_attention_decode_quantized(q32, kv, kv, rows, table, window=4096)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # group 34
        q.paged_attention_decode_quantized(torch.cat([q32, q32[:, :8]], 1), kv, kv, rows, table)
    cache = QuantizedKV(torch.empty(2, 8, 64, 256, dtype=torch.int8, device=meta),
                        torch.empty(2, 8, 64, device=meta))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # the cap at D 256
        q.flash_attention_decode_quantized(qm[:, :, :1], cache, cache, rows, logit_softcap=50.0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # D 256, group 32
        q.flash_attention_decode_quantized(q32, cache, cache, rows, window=4096)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):  # group 34
        q.flash_attention_decode_quantized(torch.cat([q32, q32[:, :8]], 1), cache, cache, rows)


def test_quant_plain_versions_never_read_past_the_lengths():
    """NaN in every scale at or past a row's length (and in page 0), and the
    e4m3 NaN byte 0x7F in the values there, must not reach the output."""
    (_, _), (tk, tv), table, rng = paged_pools(7, 3, 2, 6, 8, jnp.float8_e4m3fn)
    lens = [0, 9, 48]
    qa = torch.from_numpy(rng.standard_normal((3, 8, 1, 64), dtype=np.float32))
    lengths = torch.tensor(lens, dtype=torch.int32)
    tbl = torch.from_numpy(table)
    clean = q.paged_attention_decode_quantized(qa, tk, tv, lengths, tbl)
    dead = np.concatenate([table[b, np.arange(n, 48) // 8] * 8 + np.arange(n, 48) % 8
                           for b, n in enumerate(lens)] + [np.arange(8)])  # + page 0
    for kv in (tk, tv):
        kv.scales.view(2, -1)[:, dead] = float("nan")
        kv.values.view(torch.uint8).view(2, -1, 64)[:, dead] = 0x7F
    assert torch.equal(q.paged_attention_decode_quantized(qa, tk, tv, lengths, tbl), clean)
    qe = torch.from_numpy(rng.standard_normal((3, 8, 5, 64), dtype=np.float32))
    out = q.paged_attention_extend_quantized(qe, tk, tv, torch.tensor([0, 4, 43], dtype=torch.int32),
                                             lengths, tbl)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    # The contiguous cache: NaN scales past each length.
    _, ck = quantized_pair(rng.standard_normal((3, 2, 32, 64), dtype=np.float32), jnp.int8)
    _, cv = quantized_pair(rng.standard_normal((3, 2, 32, 64), dtype=np.float32), jnp.int8)
    lengths = torch.tensor([0, 7, 32], dtype=torch.int32)
    clean = q.flash_attention_decode_quantized(qa, ck, cv, lengths)
    for b, n in enumerate(lens[:2]):
        ck.scales[b, :, [0, 7][b]:] = float("nan")
        cv.scales[b, :, [0, 7][b]:] = float("nan")
    assert torch.equal(q.flash_attention_decode_quantized(qa, ck, cv, lengths), clean)


APPEND = {
    # name: (dtype, s, lengths before the append, active): table row 1 holds
    # the real page 0; row 2 runs past the end of its table.
    "int8_decode_s1": ("int8", 1, [3, 2, 32, 0], [True, True, True, False]),
    "e4m3_decode_s1": ("e4m3", 1, [7, 0, 31, 4], [True, True, True, False]),
    "e4m3_chunk_s11": ("e4m3", 11, [4, 0, 23, 2], [True, True, True, False]),
}


@pytest.mark.parametrize("case", list(APPEND))
def test_paged_append_layer_quantized_matches_jax_exactly(case):
    name, s, lens, act = APPEND[case]
    jdtype = DTYPES[name][1]
    rng = np.random.default_rng(11)
    hkv, num_pages, ps, d = 2, 17, 8, 16
    (jk, jv), (tk, tv), _, _ = paged_pools(12, 4, hkv, 4, ps, jdtype, d=d)
    table = np.array([[5, 9, 2, 14], [0, 7, 11, 3], [1, 4, 6, 8], [10, 12, 13, 15]], np.int32)
    k_new = rng.standard_normal((4, hkv, s, d), dtype=np.float32)
    v_new = rng.standard_normal((4, hkv, s, d), dtype=np.float32)
    lengths, active = np.asarray(lens, np.int32), np.asarray(act)
    want = [jax_cache.paged_append_layer_quantized(
        (slab.values, slab.scales), jnp.asarray(new), jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(active)) for slab, new in ((jk, k_new), (jv, v_new))]
    before = tk.values.clone()
    k_slab, v_slab = (tk.values, tk.scales), (tv.values, tv.scales)
    out = paged_cache.paged_append_layer_quantized(
        k_slab, v_slab, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(table), torch.from_numpy(lengths), torch.from_numpy(active))
    assert out[0][0] is tk.values and out[1][1] is tv.scales  # in place
    for got, (vals, scales) in zip((tk, tv), want):
        assert_same_bytes(got.values, vals)
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(scales))
    assert not torch.equal(tk.values.view(torch.uint8), before.view(torch.uint8))


@pytest.mark.parametrize("name", list(DTYPES))
def test_quantize_append_contiguous_writes_quantize_kv_at_each_length(name):
    tdtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(13)
    b, hkv, cap, d, s = 3, 2, 16, 32, 4
    cache_k = QuantizedKV(torch.zeros((b, hkv, cap, d), dtype=tdtype), torch.ones((b, hkv, cap)))
    cache_v = QuantizedKV(torch.zeros((b, hkv, cap, d), dtype=tdtype), torch.ones((b, hkv, cap)))
    k_new = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v_new = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lens = [0, 5, 12]
    q.quantize_append(torch.from_numpy(k_new), torch.from_numpy(v_new), cache_k, cache_v,
                      torch.tensor(lens, dtype=torch.int32))
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        want = jax_q.quantize_kv(jnp.asarray(new), jdtype)
        for i, n in enumerate(lens):
            assert_same_bytes(cache.values[i, :, n:n + s], np.asarray(want.values)[i])
            np.testing.assert_array_equal(cache.scales[i, :, n:n + s].numpy(),
                                          np.asarray(want.scales)[i])
            rest = torch.ones(cap, dtype=torch.bool)
            rest[n:n + s] = False
            assert (cache.scales[i][:, rest] == 1).all()
            assert (cache.values[i][:, rest].float() == 0).all()
