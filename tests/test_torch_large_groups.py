"""GQA groups above 8 (the paged extends B6 / B9) and above 32 (the decodes
D1, B5, B7, B8) in the port against the JAX package, on the CPU.

On the card the decodes cut a group above 32 q heads a kv head into
chunks of at most 32 rows, a block each (`dispatch.decode_group_chunks`);
the extends run one q head a block, so any group. Here the plain versions,
which those kernels are held to on the card, are held to the JAX kernels
in interpret mode (which pad the group to a multiple of 8) at groups 12,
16, 48 and 71 and tiny widths, at atol 1e-5 (fp32 sums in other orders):
the contiguous decode (D1 + D2), the paged one (B5 + D2), over int8 (B7 +
D2) and over e4m3 pages (B8 + D2; capacities multiples of JAX's `block_kv`,
ROADMAP.md C), and the extends over bf16-free fp32 pages (B6) and int8
pages (B9). Inputs are standard normal at D <= 64, so scores stay far
inside the 75-nat envelope of the JAX extend's lazy max. The chunk plan
and the split count that counts its blocks are pure functions. A tiny fp32
Llama with 32 q / 2 kv heads (group 16) and llama3 rope scaling at
Llama-3.1-405B's settings gives JAX's greedy tokens and JAX's engine
tokens: JAX's greedy (on its CPU route, XLA attention) for the batch and
for each request of the whole-prompt engine over fp32 pages, JAX's engine
(its paged kernels in interpret mode, once, in a module fixture) for the
engine chunked over int8 pages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import RopeScaling as JaxRopeScaling
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.models.config import RopeScaling, tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.ops import flash_decode
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.ops import quantized as q
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

ATOL = 1e-5
DTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def t(*arrays):
    """Torch copies (JAX on the CPU may alias a numpy buffer)."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def quantized_pair(x, name):
    """One fp32 array quantized by the port (bit-identical to JAX's,
    tests/test_torch_quantized.py), as (JAX QuantizedKV, port QuantizedKV)."""
    tq = q.quantize_kv(torch.from_numpy(x), DTYPES[name][0])
    vals = tq.values.view(torch.uint8).numpy().view(jnp.float8_e4m3fn) \
        if name == "e4m3" else tq.values.numpy()
    return jax_q.QuantizedKV(jnp.asarray(vals), jnp.asarray(tq.scales.numpy())), tq


def pools(rng, hkv, d, b, ps, pps, name=None):
    """Pools [Hkv, P, ps, D] (fp32, or quantized to `name` as (JAX, port)
    pairs) behind a table of distinct shuffled pages, page 0 in no table."""
    num_pages = b * pps + 1
    k, v = normal(rng, hkv, num_pages, ps, d), normal(rng, hkv, num_pages, ps, d)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    if name is None:
        return (k, v), table
    return (quantized_pair(k, name), quantized_pair(v, name)), table


# (group, Hkv, D, window, cap): Falcon-7B's MQA group of 71 with a window,
# StarCoder's 48 with a cap of 1.0 (it binds: scores reach about 10).
@pytest.mark.parametrize("group, hkv, d, window, cap",
                         [(71, 1, 16, 20, None), (48, 2, 32, None, 1.0)],
                         ids=["g71_window", "g48_cap"])
def test_decode_plain_matches_jax_kernel(group, hkv, d, window, cap):
    """D1 + D2 over a cache [B, Hkv, 96, D], lengths 96, 41 and 0."""
    rng = np.random.default_rng(300 + group)
    qa = normal(rng, 3, group * hkv, 1, d)
    k, v = normal(rng, 3, hkv, 96, d), normal(rng, 3, hkv, 96, d)
    lens = np.asarray([96, 41, 0], np.int32)
    want = jax_decode(*j(qa, k, v), kv_length=jnp.asarray(lens), window=window,
                      logit_softcap=cap, block_kv=32, interpret=True)
    got = flash_decode.flash_attention_decode(*t(qa, k, v), kv_length=torch.from_numpy(lens),
                                              window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("group, hkv, d", [(16, 2, 32), (71, 1, 64)], ids=["g16", "g71"])
def test_paged_decode_plain_matches_jax_kernel(group, hkv, d):
    """B5 + D2 through a page table (page_size 16), lengths 64, 17 and 0."""
    rng = np.random.default_rng(310 + group)
    (kp, vp), table = pools(rng, hkv, d, 3, 16, 4)
    qa = normal(rng, 3, group * hkv, 1, d)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_pa.paged_attention_decode(*j(qa, kp, vp, lens, table),
                                         pages_per_compute_block=2, interpret=True)
    got = pa.paged_attention_decode(*t(qa, kp, vp, lens, table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def test_quant_decode_plain_matches_jax_kernel_at_group_12():
    """B7 + D2 over an int8 cache of capacity 128 (one of JAX's block_kv),
    Mistral-Large-2's group of 12, lengths 128, 41 and 0."""
    rng = np.random.default_rng(320)
    qa = normal(rng, 3, 24, 1, 32)
    jk, tk = quantized_pair(normal(rng, 3, 2, 128, 32), "int8")
    jv, tv = quantized_pair(normal(rng, 3, 2, 128, 32), "int8")
    lens = np.asarray([128, 41, 0], np.int32)
    want = jax_q.flash_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, kv_length=jnp.asarray(lens), block_kv=128, interpret=True)
    got = q.flash_attention_decode_quantized(torch.from_numpy(qa), tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def test_quant_paged_decode_plain_matches_jax_kernel_at_group_48():
    """B8 + D2 over e4m3 pages (page_size 16, StarCoder's MQA group of 48),
    lengths 64, 17 and 0."""
    rng = np.random.default_rng(330)
    ((jk, tk), (jv, tv)), table = pools(rng, 1, 32, 3, 16, 4, "e4m3")
    qa = normal(rng, 3, 48, 1, 32)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_q.paged_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, jnp.asarray(lens), jnp.asarray(table),
        pages_per_compute_block=2, interpret=True)
    got = q.paged_attention_decode_quantized(torch.from_numpy(qa), tk, tv, torch.from_numpy(lens),
                                             torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


# (group, Hkv, D, window): Mistral-Large-2's 12 with a window, Falcon's 71.
@pytest.mark.parametrize("group, hkv, d, window", [(12, 2, 32, 20), (71, 1, 16, None)],
                         ids=["g12_window", "g71"])
def test_paged_extend_plain_matches_jax_kernel(group, hkv, d, window):
    """B6: chunks of 16 rows at offsets 0 and 40 (page_size 8), and an
    inactive row."""
    rng = np.random.default_rng(340 + group)
    (kp, vp), table = pools(rng, hkv, d, 3, 8, 8)
    qa = normal(rng, 3, group * hkv, 16, d)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_pa.paged_attention_extend(*j(qa, kp, vp, off, kvl, table), window=window,
                                         pages_per_compute_block=2, interpret=True)
    got = pa.paged_attention_extend(*t(qa, kp, vp, off, kvl, table), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def test_quant_paged_extend_plain_matches_jax_kernel_at_group_16():
    """B9 over int8 pages at Llama-3.1-405B's group of 16 (32 / 2 heads)."""
    rng = np.random.default_rng(350)
    ((jk, tk), (jv, tv)), table = pools(rng, 2, 32, 3, 8, 8, "int8")
    qa = normal(rng, 3, 32, 16, 32)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_q.paged_attention_extend_quantized(
        jnp.asarray(qa), jk, jv, *j(off, kvl, table), pages_per_compute_block=2, interpret=True)
    got = q.paged_attention_extend_quantized(torch.from_numpy(qa), tk, tv,
                                             *t(off, kvl, table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("group, chunks, rows", [
    (1, 1, 1), (7, 1, 7), (32, 1, 32), (33, 2, 17), (48, 2, 24), (64, 2, 32), (71, 3, 24),
    (96, 3, 32), (128, 4, 32), (200, 7, 29)])
def test_decode_group_chunks(group, chunks, rows):
    """ceil(G / 32) chunks of ceil(G / chunks) rows: none above 32, none
    empty, together the group, the last at most chunks - 1 rows short."""
    assert dispatch.decode_group_chunks(group) == (chunks, rows)
    assert rows <= dispatch.DECODE_BLOCK_ROWS
    assert (chunks - 1) * rows < group <= chunks * rows


@pytest.mark.parametrize("batch, hkv, capacity, d, group", [
    (4, 8, 576, 128, 16), (8, 1, 2048, 64, 71), (4, 1, 1024, 128, 48), (1, 1, 4096, 256, 128)])
def test_decode_num_splits_counts_the_chunk_blocks(batch, hkv, capacity, d, group):
    """A group's chunks count as kv heads of their own in the split plan;
    up to 32 (one chunk) the plan is that of the group of 1."""
    chunks = dispatch.decode_group_chunks(group)[0]
    splits = dispatch.decode_num_splits(batch, hkv, capacity, d, group)
    assert splits == dispatch.decode_num_splits(batch, hkv * chunks, capacity, d)
    assert 1 <= splits <= capacity // dispatch.decode_tile(d)
    if chunks == 1:
        assert splits == dispatch.decode_num_splits(batch, hkv, capacity, d)


def test_cuda_routes_take_groups_above_8_and_32():
    """Off the CPU (the `meta` device, on which no kernel runs) D1, B5, B7
    and B8 at Falcon-7B's 71 / 1 heads and B6 / B9 at 128 / 8 heads reach
    the CUDA-tensor check: no group bound refuses them."""
    meta = torch.device("meta")
    q71 = torch.empty(2, 71, 1, 64, dtype=torch.bfloat16, device=meta)
    cache = torch.empty(2, 1, 64, 64, dtype=torch.bfloat16, device=meta)
    pool = torch.empty(1, 9, 16, 64, dtype=torch.bfloat16, device=meta)
    qcache = QuantizedKV(cache.to(torch.int8), torch.empty(2, 1, 64, device=meta))
    qpool = QuantizedKV(pool.to(torch.int8), torch.empty(1, 9, 16, device=meta))
    rows = torch.zeros(2, dtype=torch.int32, device=meta)
    table = torch.zeros(2, 4, dtype=torch.int32, device=meta)
    q128 = torch.empty(2, 128, 5, 64, dtype=torch.bfloat16, device=meta)
    pool8 = torch.empty(8, 9, 16, 64, dtype=torch.bfloat16, device=meta)
    qpool8 = QuantizedKV(pool8.to(torch.int8), torch.empty(8, 9, 16, device=meta))
    calls = [
        lambda: flash_decode.flash_attention_decode(q71, cache, cache, rows),
        lambda: pa.paged_attention_decode(q71, pool, pool, rows, table),
        lambda: q.flash_attention_decode_quantized(q71, qcache, qcache, rows),
        lambda: q.paged_attention_decode_quantized(q71, qpool, qpool, rows, table),
        lambda: pa.paged_attention_extend(q128, pool8, pool8, rows, rows, table),
        lambda: q.paged_attention_extend_quantized(q128, qpool8, qpool8, rows, rows, table),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


# A tiny fp32 Llama at a group of 16 (32 q / 2 kv heads, as Llama-3.1-405B's
# 128 / 8) with llama3 rope scaling at 405B's settings (theta 500000, factor
# 8, low / high frequency factors 1 / 4 over 8192 positions): at D 16 its
# frequencies fall in all three bands (kept, smoothed, divided by 8).
ROPE = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
            original_max_position_embeddings=8192)
G16 = dict(num_q_heads=32, num_kv_heads=2, head_dim=16, rope_theta=500000.0)
POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)
CHUNKED = {"prefill_chunk": 8}
NEW = 4


@pytest.fixture(scope="module")
def tiny_g16():
    jcfg = jax_tiny(**G16, rope_scaling=JaxRopeScaling(**ROPE))
    jparams = jax_init(jcfg, jax.random.key(16))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(**G16, rope_scaling=RopeScaling(**ROPE)), params


def engine_prompts():
    rng = np.random.default_rng(16)
    return {rid: rng.integers(0, 256, n).tolist() for rid, n in ((0, 13), (1, 6))}


def engine_tokens(engine):
    for rid, prompt in engine_prompts().items():
        engine.submit(rid, prompt, NEW)
    got = engine.run()
    assert not engine.failed and sorted(got) == [0, 1]
    return got


def test_greedy_generate_at_group_16_token_identical_to_jax(tiny_g16):
    """The prefill, then a decode at group 16 every step."""
    jcfg, jparams, cfg, params = tiny_g16
    ids = np.random.default_rng(17).integers(0, 256, (2, 11)).astype(np.int32)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 6))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_whole_prompt_engine_at_group_16_gives_jax_greedy_tokens(tiny_g16):
    """Whole-prompt admission over fp32 pages (the prefill, B5 + D2, the
    append): each request's tokens are JAX's greedy continuation of its
    prompt."""
    jcfg, jparams, cfg, params = tiny_g16
    want = {rid: np.asarray(jax_greedy(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                                       NEW))[0].tolist()
            for rid, prompt in engine_prompts().items()}
    assert engine_tokens(ServingEngine(params, cfg, **POOL)) == want


def test_chunked_int8_engine_at_group_16_token_identical_to_jax_engine(tiny_g16):
    """Chunked admission over int8 pages (B9, B8 + D2, QA): the JAX
    engine's tokens."""
    jcfg, jparams, cfg, params = tiny_g16
    want = engine_tokens(JaxServingEngine(jparams, jcfg, **POOL, **CHUNKED,
                                          kv_dtype=jnp.int8, interpret=True))
    got = engine_tokens(ServingEngine(params, cfg, **POOL, **CHUNKED, kv_dtype=torch.int8))
    assert got == want
