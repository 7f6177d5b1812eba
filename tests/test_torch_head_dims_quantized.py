"""Head dims outside {64, 128, 256} over quantized caches and in the
extend kernel, in the port against the JAX package, on the CPU.

The kernels B7, B8, B9 and QA take every head dim whose one-byte (int8 /
e4m3) row is a multiple of 16 bytes, B4 every multiple of 8, each run on the
card in the layout of the next of 64, 128 and 256 (`_build.padded_head_dim`
with the row's element size). Here the plain versions, which those kernels
are held to on the card, are held to the JAX kernels in interpret mode
(which pad D to 128 lanes) at D 40 (with a window) over int8, D 48 over
e4m3 and D 96 (with a soft cap of 1.0, which binds: scores here reach about
10) over both, at atol 1e-5 (fp32 sums in other orders); the head dim's
handling does not depend on the value type, and each JAX case costs about
a second of compilation; e4m3 capacities stay multiples of
JAX's `block_kv` (its interpret mode gives NaN on a ragged e4m3 tail block,
ROADMAP.md C). QA writes exactly the bytes and scales of JAX's
`quantize_kv` + scatter, contiguous and paged, at D 40 and 96. A tiny
2-layer Llama of head dim 48 (48 takes the one-byte rule on the card too)
with JAX's weights gives JAX's tokens, the JAX side on its kernel route
(`interpret=True`): greedy over int8 and e4m3 caches, the engine over int8
pages whole and chunked, self-draft `speculative_generate` and
`prompt_lookup_generate` (at their default capacities, above prompt + new +
gamma - 1). The JAX engine runs once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import _kv_write as jax_kv_write
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu.runtime import prompt_lookup as jax_pl
from flash_attention_cute_tpu.runtime import speculative as jax_spec
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.ops import _build, flash_chunked
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.ops import quantized as q
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate
from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate

ATOL = 1e-5
HQ, HKV = 4, 2
DTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
# (head dim, window, soft cap, values): D 40 with a window, D 48 plain, D
# 96 with a cap of 1.0.
KERNEL_CASES = [(40, 20, None, "int8"), (48, None, None, "e4m3"), (96, None, 1.0, "int8"),
                (96, None, 1.0, "e4m3")]
KERNEL_IDS = [f"d{d}_{name}" for d, _, _, name in KERNEL_CASES]


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def to_numpy(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


def quantized_pair(x, name):
    """One fp32 array quantized by the port (bit-identical to JAX's,
    tests/test_torch_quantized.py), as (JAX QuantizedKV, port QuantizedKV)."""
    tq = q.quantize_kv(torch.from_numpy(x), DTYPES[name][0])
    return jax_q.QuantizedKV(jnp.asarray(to_numpy(tq.values)), jnp.asarray(tq.scales.numpy())), tq


def assert_same_bytes(got: torch.Tensor, want):
    want = np.asarray(want)
    if got.dtype == torch.float8_e4m3fn:
        got, want = got.view(torch.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d, window, cap, name", KERNEL_CASES, ids=KERNEL_IDS)
def test_quant_decode_plain_matches_jax_kernel(d, window, cap, name):
    """B7 + D2 over a contiguous cache of capacity 128 (one of JAX's
    block_kv), lengths 128, 41 and 0."""
    rng = np.random.default_rng(200 + d)
    qa = normal(rng, 3, HQ, 1, d)
    jk, tk = quantized_pair(normal(rng, 3, HKV, 128, d), name)
    jv, tv = quantized_pair(normal(rng, 3, HKV, 128, d), name)
    lens = np.asarray([128, 41, 0], np.int32)
    want = jax_q.flash_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, kv_length=jnp.asarray(lens), window=window, logit_softcap=cap,
        block_kv=128, interpret=True)
    got = q.flash_attention_decode_quantized(torch.from_numpy(qa), tk, tv, torch.from_numpy(lens),
                                             window=window, logit_softcap=cap)
    assert got.shape == (3, HQ, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def paged_pools(seed, d, b, ps, pps, name):
    """Quantized pools [Hkv, P, ps, D] (JAX and port) behind a table of
    distinct shuffled pages, page 0 in no table."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    jk, tk = quantized_pair(normal(rng, HKV, num_pages, ps, d), name)
    jv, tv = quantized_pair(normal(rng, HKV, num_pages, ps, d), name)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return (jk, jv), (tk, tv), table, rng


@pytest.mark.parametrize("d, window, cap, name", KERNEL_CASES, ids=KERNEL_IDS)
def test_quant_paged_decode_plain_matches_jax_kernel(d, window, cap, name):
    """B8 + D2 through a page table (page_size 16), lengths 64 (the whole
    table), 17 and 0."""
    (jk, jv), (tk, tv), table, rng = paged_pools(210 + d, d, 3, 16, 4, name)
    qa = normal(rng, 3, HQ, 1, d)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_q.paged_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(lens), jnp.asarray(table), window=window,
        logit_softcap=cap, pages_per_compute_block=2, interpret=True)
    got = q.paged_attention_decode_quantized(torch.from_numpy(qa), tk, tv, torch.from_numpy(lens),
                                             torch.from_numpy(table), window=window,
                                             logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d, window, cap, name", KERNEL_CASES, ids=KERNEL_IDS)
def test_quant_paged_extend_plain_matches_jax_kernel(d, window, cap, name):
    """B9: chunks of 16 rows at offsets 0 and 40 (page_size 8), and an
    inactive row."""
    (jk, jv), (tk, tv), table, rng = paged_pools(220 + d, d, 3, 8, 8, name)
    qa = normal(rng, 3, HQ, 16, d)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_q.paged_attention_extend_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(off), jnp.asarray(kvl), jnp.asarray(table),
        window=window, logit_softcap=cap, pages_per_compute_block=2, interpret=True)
    got = q.paged_attention_extend_quantized(
        torch.from_numpy(qa), tk, tv, torch.from_numpy(off), torch.from_numpy(kvl),
        torch.from_numpy(table), window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d, window, cap", [(40, 20, None), (96, None, 1.0)],
                         ids=["d40_window", "d96_cap"])
def test_chunked_plain_matches_jax_kernel(d, window, cap):
    """B4 over a contiguous cache of capacity 200: chunks of 16 rows at
    offsets 0, 37 and 150, one row of kv_length 0, GQA group 2."""
    rng = np.random.default_rng(230 + d)
    qa, k, v = normal(rng, 3, HQ, 16, d), normal(rng, 3, HKV, 200, d), normal(rng, 3, HKV, 200, d)
    off, kvl = np.asarray([0, 37, 150], np.int32), np.asarray([16, 53, 0], np.int32)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    want = jax_chunked(*(jnp.asarray(x) for x in (qa, k, v, off, kvl)), interpret=True, **kw)
    got = flash_chunked.flash_attention_chunked(
        *(torch.from_numpy(x) for x in (qa, k, v, off, kvl)), **kw)
    assert got.shape == (3, HQ, 16, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


QA_CASES = [(d, name) for d in (40, 96) for name in DTYPES]
QA_IDS = [f"d{d}_{name}" for d, name in QA_CASES]


@pytest.mark.parametrize("d, name", QA_CASES, ids=QA_IDS)
def test_quantize_append_contiguous_bit_identical_to_jax(d, name):
    """QA into a contiguous cache [B, Hkv, 32, D] at lengths 0, 5 and 26:
    the bytes and scales of JAX's `quantize_kv` + `_kv_write` (the
    transformer's scatter); rows of other positions keep what they held."""
    rng = np.random.default_rng(240 + d)
    (jk, jv), (tk, tv) = zip(*(quantized_pair(normal(rng, 3, HKV, 32, d), name) for _ in "kv"))
    k_new, v_new = normal(rng, 3, HKV, 6, d), normal(rng, 3, HKV, 6, d)
    lens = np.asarray([0, 5, 26], np.int32)
    q.quantize_append(torch.from_numpy(k_new), torch.from_numpy(v_new), tk, tv,
                      torch.from_numpy(lens))
    for got, cache, new in ((tk, jk, k_new), (tv, jv, v_new)):
        nq = jax_q.quantize_kv(jnp.asarray(new), DTYPES[name][1])
        vals = jax_kv_write(cache.values[None], nq.values, 0, jnp.asarray(lens))[0]
        scales = jax_kv_write(cache.scales[None], nq.scales, 0, jnp.asarray(lens))[0]
        assert_same_bytes(got.values, vals)
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(scales))


@pytest.mark.parametrize("d, name", QA_CASES, ids=QA_IDS)
def test_quantize_append_paged_bit_identical_to_jax(d, name):
    """QA through a page table (page_size 8; a row past its table's end,
    an inactive row): JAX's `paged_append_layer_quantized`."""
    rng = np.random.default_rng(250 + d)
    (jk, jv), (tk, tv), _, _ = paged_pools(251 + d, d, 4, 8, 4, name)
    table = np.array([[5, 9, 2, 14], [1, 7, 11, 3], [16, 4, 6, 8], [10, 12, 13, 15]], np.int32)
    k_new, v_new = normal(rng, 4, HKV, 3, d), normal(rng, 4, HKV, 3, d)
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


# A tiny Llama of head dim 48 (4 / 2 heads, two layers).
D48 = dict(head_dim=48, num_q_heads=4, num_kv_heads=2)
POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)
ENGINE_RUNS = {"whole int8": {}, "chunked int8": {"prefill_chunk": 8}}


@pytest.fixture(scope="module")
def tiny_d48():
    jcfg = jax_tiny(**D48)
    jparams = jax_init(jcfg, jax.random.key(5))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(**D48), params


def engine_prompts():
    rng = np.random.default_rng(48)
    return {rid: rng.integers(0, 256, n).tolist() for rid, n in ((0, 13), (1, 6))}


@pytest.fixture(scope="module")
def jax_engine_tokens(tiny_d48):
    """The JAX engine's tokens over int8 pages for each run of ENGINE_RUNS,
    once."""
    jcfg, jparams, _, _ = tiny_d48
    out = {}
    for name, kw in ENGINE_RUNS.items():
        eng = JaxServingEngine(jparams, jcfg, **POOL, **kw, kv_dtype=jnp.int8, interpret=True)
        for rid, prompt in engine_prompts().items():
            eng.submit(rid, prompt, 4)
        out[name] = eng.run()
    return out


def prompt_ids(seed, b=2, s=11):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", list(DTYPES))
def test_greedy_generate_over_quantized_cache_at_d48_token_identical_to_jax(tiny_d48, name):
    """QA, then B7 + D2 at every step; capacity 128, one of JAX's block_kv."""
    jcfg, jparams, cfg, params = tiny_d48
    ids = prompt_ids(49)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 8, cache_capacity=128,
                                 cache_dtype=DTYPES[name][1], interpret=True))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 8, cache_capacity=128,
                          cache_dtype=DTYPES[name][0])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_over_int8_pages_at_d48_token_identical_to_jax_engine(name, tiny_d48,
                                                                    jax_engine_tokens):
    """QA, B8 + D2 and (chunked) B9 over int8 pages."""
    _, _, cfg, params = tiny_d48
    eng = ServingEngine(params, cfg, **POOL, **ENGINE_RUNS[name], kv_dtype=torch.int8)
    for rid, prompt in engine_prompts().items():
        eng.submit(rid, prompt, 4)
    got = eng.run()
    assert not eng.failed and sorted(got) == [0, 1]
    assert got == jax_engine_tokens[name]


def test_speculative_generate_at_d48_token_identical_to_jax(tiny_d48):
    """The model as its own draft (B4 verifies, D1 + D2 drafts): JAX's
    tokens, rounds and accepted drafts, and greedy's tokens."""
    jcfg, jparams, cfg, params = tiny_d48
    ids = prompt_ids(50)
    want, jst = jax_spec.speculative_generate(jparams, jcfg, jparams, jcfg, jnp.asarray(ids), 10,
                                              gamma=3, return_stats=True, interpret=True)
    got, st = speculative_generate(params, cfg, params, cfg, torch.from_numpy(ids), 10, gamma=3,
                                   return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  greedy_generate(params, cfg, torch.from_numpy(ids), 10).numpy())
    assert st == jst


def test_prompt_lookup_at_d48_token_identical_to_jax(tiny_d48):
    """Prompt lookup on a repeating prompt (B4 verifies): JAX's tokens,
    rounds and accepted drafts, and greedy's tokens."""
    jcfg, jparams, cfg, params = tiny_d48
    ids = np.tile(prompt_ids(51, s=4), (1, 3))
    want, jst = jax_pl.prompt_lookup_generate(jparams, jcfg, jnp.asarray(ids), 10, gamma=3,
                                              ngram=2, return_stats=True, interpret=True)
    got, st = prompt_lookup_generate(params, cfg, torch.from_numpy(ids), 10, gamma=3, ngram=2,
                                     return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  greedy_generate(params, cfg, torch.from_numpy(ids), 10).numpy())
    assert st == jst


@pytest.mark.parametrize("d, layout", [(16, 64), (48, 64), (96, 128), (160, 256), (256, 256)])
def test_one_byte_rule_takes_multiples_of_16_up_to_256(d, layout):
    """One-byte rows: the layout a taken head dim runs in, and the decode
    and extend tiles that follow it."""
    assert _build.padded_head_dim(d, "quantized decode", 1) == layout
    assert dispatch.decode_tile(d) == (64 if layout == 64 else 32)
    assert pa.extend_plan(d, 16) == (64 if layout == 256 else 128, 16)


@pytest.mark.parametrize("d", [24, 40, 264, 8, 0])
def test_one_byte_rule_refuses_the_rest_naming_the_roadmap_item(d):
    """One-byte rows of d 24, 40 and 8, refused before the pitched rows,
    now run in D 64's layout at a pitch of 32, 48 and 16 bytes; d 264 and 0
    still raise, naming the item of the head dims above 256."""
    if 1 <= d <= 256:
        assert _build.padded_head_dim(d, "quantized paged decode", 1) == 64
        assert _build.row_pitch(d, 1) == {24: 32, 40: 48, 8: 16}[d]
        return
    with pytest.raises(NotImplementedError, match=r"from 1 to 256.*ROADMAP\.md A14"):
        _build.padded_head_dim(d, "quantized paged decode", 1)


@pytest.mark.parametrize("d, layout", [(8, 64), (24, 64), (40, 64), (96, 128), (136, 256),
                                       (256, 256), (100, None), (264, None)])
def test_two_byte_rule_keeps_its_answers(d, layout):
    """bf16 / f16 rows (the default element size) keep the rule of P / B2,
    D1 + D2, B5, B6 and the append, which B4 now follows too; D 100 runs
    in D 128's layout at rows of 104, and D 264 stays refused by the rule
    up to 256, while the wide rule of B4 and B6 (`wide`) runs it in the
    layout of 512."""
    if d == 100:
        assert _build.padded_head_dim(d, "extend") == 128 and _build.row_pitch(d) == 104
    elif layout is None:
        with pytest.raises(NotImplementedError, match=r"from 1 to 256.*ROADMAP\.md A14"):
            _build.padded_head_dim(d, "extend")
        assert _build.padded_head_dim(d, "extend", wide=True) == 512
    else:
        assert _build.padded_head_dim(d, "extend") == _build.padded_head_dim(d, "extend", 2) \
            == layout


def test_cuda_routes_refuse_a_one_byte_row_of_d_mod_16_8_before_the_device_check():
    """Off the CPU (the `meta` device, on which no kernel runs) D 40 over
    int8 values, refused before the pitched rows, now reaches the
    CUDA-tensor check in B7, B8, B9 and QA, as D 48 does; B4 takes D 40
    over bf16 rows."""
    meta = torch.device("meta")
    for d, err in ((40, ValueError), (48, ValueError)):
        qm = torch.empty(2, 4, 1, d, dtype=torch.bfloat16, device=meta)
        pool = QuantizedKV(torch.empty(2, 9, 16, d, dtype=torch.int8, device=meta),
                           torch.empty(2, 9, 16, device=meta))
        cache = QuantizedKV(torch.empty(2, 2, 64, d, dtype=torch.int8, device=meta),
                            torch.empty(2, 2, 64, device=meta))
        rows = torch.zeros(2, dtype=torch.int32, device=meta)
        table = torch.zeros(2, 4, dtype=torch.int32, device=meta)
        calls = [
            lambda: q.flash_attention_decode_quantized(qm, cache, cache, rows),
            lambda: q.paged_attention_decode_quantized(qm, pool, pool, rows, table),
            lambda: q.paged_attention_extend_quantized(qm, pool, pool, rows, rows, table),
            lambda: q.quantize_append(qm[:, :2], qm[:, :2], cache, cache, rows),
        ]
        for call in calls:
            with pytest.raises(err, match="CUDA tensor"):
                call()
    qb = torch.empty(2, 4, 5, 40, dtype=torch.bfloat16, device=meta)
    kb = torch.empty(2, 2, 64, 40, dtype=torch.bfloat16, device=meta)
    rows = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_chunked.flash_attention_chunked(qb, kb, kb, rows, rows)
