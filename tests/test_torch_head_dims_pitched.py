"""Head dims outside TMA's stride rule (every d from 1 to 256) in the port
against the JAX package, on the CPU.

On the card every attention kernel takes every head dim from 1 to 256,
each in the layout of the next of 64, 128 and 256 (`_build.padded_head_dim`),
its rows read at a 16-byte stride: the port allocates its caches, pools and
outputs at the row pitch `_build.row_pitch(d, element size)` (views of d
columns, zeros past d, `_build.empty_rows`), and copies once what a caller
hands in at another stride (`_build.pad_rows` into `_build.out_rows`,
counted by kind). Here:

  * the rule, the pitch and the allocators, on the CPU as on the card;
  * the copy helper and its counter;
  * the plain versions of P / B2, D1 + D2, B4, B5 and B6 at D 36 and 100
    (two-byte rows of 72 and 200 bytes), and of B7, B8, B9 at D 24 over
    int8 and D 72 over e4m3 (rows of 24 and 72 bytes, pitched to 32 and
    80), over pitched caches and pools, against the JAX kernels in
    interpret mode (which pad D to 128 lanes) at atol 1e-5 (each JAX case
    costs about a second of compilation, so the value type and the head
    dim vary together); QA's bytes and scales against JAX's quantize +
    scatter exactly, at D 24 over int8 and D 72 over e4m3;
  * a JAX cache carried into a pitched cache, decoding as JAX decodes;
  * a tiny 2-layer fp32 Llama at D 100 over fp32 caches and pages (rows of
    400 bytes, which need no pitch; the card's bf16 rows lie at 104) and
    at D 40 over int8 caches and pages (rows of 48 bytes): greedy and
    `ServingEngine` tokens (whole and chunked admission) equal JAX's, the
    JAX side on its CPU route (no interpret-mode kernel, so its lazy
    softmax plays no part).

e4m3 capacities stay multiples of JAX's `block_kv` (ROADMAP.md C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.cache import QuantizedKVCache as JaxQuantizedKVCache
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.ops import quantized as jax_q
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.ops import _build, flash_chunked, flash_decode, flash_fwd
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.ops import quantized as q
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime import paged_cache
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

ATOL = 1e-5
HQ, HKV = 4, 2
DTYPES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def pitched(a, elem_bytes=4):
    """A numpy array as a torch tensor at rows of `row_pitch(d, elem_bytes)`
    (the pitch of the pools the port allocates), pitch columns zero."""
    x = torch.from_numpy(np.array(a))
    out = _build.empty_rows(x.shape, x.dtype, "cpu", _build.row_pitch(x.shape[-1], elem_bytes))
    return out.copy_(x)


def assert_pitched(t, pitch):
    """`t` is a view of d columns of rows `pitch` apart, zeros past d."""
    d = t.shape[-1]
    assert t.stride(-1) == 1 and t.stride(-2) == pitch
    if pitch > d:
        whole = t.as_strided(t.shape[:-1] + (pitch,), t.stride())
        assert (whole[..., d:].float() == 0).all()


# ---- the rule, the pitch, the allocators and the copy helper ----

@pytest.mark.parametrize("elem", [2, 1])
def test_rule_takes_every_head_dim_from_1_to_256(elem):
    for d in range(1, 257):
        layout = 64 if d <= 64 else 128 if d <= 128 else 256
        assert _build.padded_head_dim(d, "x", elem) == layout
        pitch = _build.row_pitch(d, elem)
        assert pitch * elem % 16 == 0 and d <= pitch < d + 16 // elem and pitch <= layout
    for d in (0, 257, 264):
        with pytest.raises(NotImplementedError, match=r"from 1 to 256.*ROADMAP\.md A14"):
            _build.padded_head_dim(d, "x", elem)
        if d and elem == 2:  # P / B2 and B12 take them in the wide layout of 512
            assert _build.padded_head_dim(d, "x", elem, wide=True) == 512
    with pytest.raises(NotImplementedError, match=r"from 1 to 512.*ROADMAP\.md A14"):
        _build.padded_head_dim(513, "x", elem, wide=True)


def cfg_at(d, layers=2):
    return tiny_test_config(num_layers=layers, head_dim=d, num_q_heads=HQ, num_kv_heads=HKV)


@pytest.mark.parametrize("d", [100, 40, 4])
def test_allocators_lay_rows_at_the_pitch(d):
    """The contiguous caches (bf16 and quantized), the paged pools (bf16,
    int8, e4m3) and `empty_rows`: views of d columns, rows at
    `row_pitch(d, element size)`, zeros past d."""
    cfg = cfg_at(d)
    bf = KVCache.create(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    qc = QuantizedKVCache.create(cfg, 2, 32, dtype=torch.int8, device="cpu")
    pool = paged_cache.create_paged_state(cfg, 5, 8, 2, 2, dtype=torch.bfloat16, device="cpu")
    for dt in (torch.int8, torch.float8_e4m3fn):
        qp = paged_cache.create_quantized_paged_state(cfg, 5, 8, 2, 2, dtype=dt, device="cpu")
        for t in (qp.k_values, qp.v_values):
            assert t.shape[-1] == d and (t.float() == 0).all()
            assert_pitched(t, _build.row_pitch(d, 1))
    for t in (bf.k, bf.v, pool.k_pages, pool.v_pages):
        assert t.shape[-1] == d
        assert_pitched(t, _build.row_pitch(d, 2))
    for t in (qc.k_values, qc.v_values):
        assert_pitched(t, _build.row_pitch(d, 1))
    assert qc.k_scales.shape == qc.k_values.shape[:-1] and qc.k_scales.is_contiguous()
    out = _build.empty_rows((3, 5, d), torch.float32, "cpu", _build.row_pitch(d))
    assert_pitched(out, _build.row_pitch(d))
    full = _build.empty_rows((3, 64), torch.bfloat16, "cpu")
    assert full.is_contiguous()  # a d of whole 16-byte rows needs no pitch


def test_pad_rows_copies_once_what_breaks_the_rule_and_counts_it():
    """A view at rows of 16 bytes passes as it is; one at rows of 200 bytes
    (the projection's [B, S, H, D] transposed at D 100) is copied into
    rows of 104 (`out_rows`: the pitch columns are never read), counted by
    kind; the copy holds the same values."""
    x = torch.randn(2, 7, 4, 100).to(torch.bfloat16)
    before = dict(_build.copies)
    view = x.transpose(1, 2)
    got = _build.pad_rows(view, "activation")
    assert torch.equal(got, view) and got.data_ptr() != view.data_ptr()
    assert got.stride() == (4 * 7 * 104, 7 * 104, 104, 1)
    cache = _build.empty_rows((2, 4, 9, 100), torch.bfloat16, "cpu")
    assert _build.pad_rows(cache, "cache") is cache
    full = torch.randn(3, 5, 64).to(torch.bfloat16)
    assert _build.pad_rows(full, "cache") is full
    assert _build.copies == {**before, "activation": before["activation"] + 1}
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.rows("q", view, torch.bfloat16)


# ---- the plain versions against the JAX kernels ----

TWO_BYTE = [(36, 20, None), (100, None, 1.0)]  # (d, window, cap)
TWO_IDS = ["d36_window", "d100_cap"]


@pytest.mark.parametrize("d, window, cap", TWO_BYTE, ids=TWO_IDS)
def test_prefill_and_extend_plain_match_jax_kernels(d, window, cap):
    """P / B2 (causal, window or cap) and B4 (chunks at offsets 0 and 21,
    a row of kv_length 0) over a pitched cache."""
    rng = np.random.default_rng(300 + d)
    qa, ka, va = normal(rng, 2, HQ, 24, d), normal(rng, 2, HKV, 24, d), normal(rng, 2, HKV, 24, d)
    want = jax_fwd(*j(qa, ka, va), causal=True, window=window, logit_softcap=cap,
                   interpret=True)
    got = flash_fwd.flash_attention_fwd(pitched(qa), pitched(ka), pitched(va), causal=True,
                                        window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    qc, kc, vc = normal(rng, 3, HQ, 8, d), normal(rng, 3, HKV, 64, d), normal(rng, 3, HKV, 64, d)
    off, kvl = np.asarray([0, 21, 5], np.int32), np.asarray([8, 29, 0], np.int32)
    want = jax_chunked(*j(qc, kc, vc, off, kvl), window=window, logit_softcap=cap,
                       interpret=True)
    got = flash_chunked.flash_attention_chunked(
        torch.from_numpy(qc), pitched(kc), pitched(vc), torch.from_numpy(off),
        torch.from_numpy(kvl), window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def paged_inputs(seed, d, b, sq, ps, pps):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    qa = normal(rng, b, HQ, sq, d)
    kp, vp = normal(rng, HKV, num_pages, ps, d), normal(rng, HKV, num_pages, ps, d)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return qa, kp, vp, table


@pytest.mark.parametrize("d, window, cap", TWO_BYTE, ids=TWO_IDS)
def test_decodes_and_paged_extend_plain_match_jax_kernels(d, window, cap):
    """D1 + D2 over a pitched cache, B5 + D2 and B6 over pitched pools."""
    rng = np.random.default_rng(310 + d)
    qa, ka, va = normal(rng, 3, HQ, 1, d), normal(rng, 3, HKV, 96, d), normal(rng, 3, HKV, 96, d)
    lens = np.asarray([96, 41, 0], np.int32)
    want = jax_decode(*j(qa, ka, va), kv_length=jnp.asarray(lens), window=window,
                      logit_softcap=cap, block_kv=32, interpret=True)
    got = flash_decode.flash_attention_decode(torch.from_numpy(qa), pitched(ka), pitched(va),
                                              kv_length=torch.from_numpy(lens), window=window,
                                              logit_softcap=cap, num_splits=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    qa, kp, vp, table = paged_inputs(320 + d, d, 3, 1, 16, 4)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_pa.paged_attention_decode(*j(qa, kp, vp, lens, table), window=window,
                                         logit_softcap=cap, pages_per_compute_block=2,
                                         interpret=True)
    got = pa.paged_attention_decode(torch.from_numpy(qa), pitched(kp), pitched(vp),
                                    torch.from_numpy(lens), torch.from_numpy(table),
                                    window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    qa, kp, vp, table = paged_inputs(330 + d, d, 3, 16, 8, 8)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_pa.paged_attention_extend(*j(qa, kp, vp, off, kvl, table), window=window,
                                         logit_softcap=cap, pages_per_compute_block=2,
                                         interpret=True)
    got = pa.paged_attention_extend(torch.from_numpy(qa), pitched(kp), pitched(vp),
                                    *(torch.from_numpy(x) for x in (off, kvl, table)),
                                    window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def to_numpy(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


def quantized_pair(x, name):
    """One fp32 array quantized by the port (bit-identical to JAX's), as
    (JAX QuantizedKV, port QuantizedKV with values at one-byte pitched
    rows)."""
    tq = q.quantize_kv(torch.from_numpy(x), DTYPES[name][0])
    vals = _build.empty_rows(tq.values.shape, tq.values.dtype, "cpu").copy_(tq.values)
    jq = jax_q.QuantizedKV(jnp.asarray(to_numpy(tq.values)), jnp.asarray(tq.scales.numpy()))
    return jq, QuantizedKV(vals, tq.scales)


ONE_BYTE = [(24, 16, None, "int8"), (72, None, 1.0, "e4m3")]  # (d, window, cap, values)
ONE_IDS = [f"d{d}_{name}" for d, _, _, name in ONE_BYTE]


@pytest.mark.parametrize("d, window, cap, name", ONE_BYTE, ids=ONE_IDS)
def test_quantized_plain_match_jax_kernels(d, window, cap, name):
    """B7 + D2 over a contiguous cache of capacity 128 (one of JAX's
    block_kv), B8 + D2 and B9 through page tables, the values at rows of
    `row_pitch(d, 1)` bytes."""
    rng = np.random.default_rng(340 + d)
    qa = normal(rng, 3, HQ, 1, d)
    (jk, tk), (jv, tv) = (quantized_pair(normal(rng, 3, HKV, 128, d), name) for _ in "kv")
    lens = np.asarray([128, 41, 0], np.int32)
    want = jax_q.flash_attention_decode_quantized(
        jnp.asarray(qa), jk, jv, kv_length=jnp.asarray(lens), window=window, logit_softcap=cap,
        block_kv=128, interpret=True)
    got = q.flash_attention_decode_quantized(torch.from_numpy(qa), tk, tv, torch.from_numpy(lens),
                                             window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for sq, ps, pps, off, kvl in ((1, 16, 4, None, [64, 17, 0]),
                                  (16, 8, 8, [0, 40, 10], [16, 56, 0])):
        num_pages = 3 * pps + 1
        (jk, tk), (jv, tv) = (quantized_pair(normal(rng, HKV, num_pages, ps, d), name)
                              for _ in "kv")
        table = (rng.permutation(num_pages - 1)[: 3 * pps] + 1).reshape(3, pps).astype(np.int32)
        qa, kvl = normal(rng, 3, HQ, sq, d), np.asarray(kvl, np.int32)
        kw = dict(window=window, logit_softcap=cap)
        if off is None:
            want = jax_q.paged_attention_decode_quantized(
                jnp.asarray(qa), jk, jv, jnp.asarray(kvl), jnp.asarray(table),
                pages_per_compute_block=2, interpret=True, **kw)
            got = q.paged_attention_decode_quantized(torch.from_numpy(qa), tk, tv,
                                                     torch.from_numpy(kvl),
                                                     torch.from_numpy(table), **kw)
        else:
            off = np.asarray(off, np.int32)
            want = jax_q.paged_attention_extend_quantized(
                jnp.asarray(qa), jk, jv, *j(off, kvl, table), pages_per_compute_block=2,
                interpret=True, **kw)
            got = q.paged_attention_extend_quantized(
                torch.from_numpy(qa), tk, tv, *(torch.from_numpy(x) for x in (off, kvl, table)),
                **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        assert (got[2] == 0).all()


@pytest.mark.parametrize("d, name", [(24, "int8"), (72, "e4m3")], ids=["d24_int8", "d72_e4m3"])
def test_quantize_append_writes_jax_bytes_into_pitched_pools(d, name):
    """QA's plain version through a page table into pools of pitched rows:
    the bytes and scales of JAX's quantize + scatter, the pitch columns
    still zero."""
    tdt, jdt = DTYPES[name]
    rng = np.random.default_rng(350 + d)
    ps, pps, b, s = 8, 4, 2, 5
    kn, vn = normal(rng, b, HKV, s, d), normal(rng, b, HKV, s, d)
    table = (rng.permutation(b * pps)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    lens = np.asarray([3, 20], np.int32)
    pools = [QuantizedKV(_build.empty_rows((HKV, b * pps + 1, ps, d), tdt, "cpu", zero=True),
                         torch.ones(HKV, b * pps + 1, ps)) for _ in "kv"]
    q.quantize_append(torch.from_numpy(kn), torch.from_numpy(vn), *pools,
                      torch.from_numpy(lens), torch.from_numpy(table))
    for pool, new in zip(pools, (kn, vn)):
        want = jax_cache.paged_append_layer_quantized(
            (jnp.zeros((HKV, b * pps + 1, ps, d), jdt), jnp.ones((HKV, b * pps + 1, ps))),
            jnp.asarray(new), jnp.asarray(table), jnp.asarray(lens))
        want = jax_q.QuantizedKV(*want)
        got = pool.values.view(torch.uint8) if name == "e4m3" else pool.values
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.values).view(got.numpy().dtype))
        np.testing.assert_array_equal(pool.scales.numpy(), np.asarray(want.scales))
        assert_pitched(pool.values, _build.row_pitch(d, 1))


# ---- models ----

@pytest.fixture(scope="module")
def tiny():
    """2-layer fp32 Llamas at D 100 and D 40 with JAX's weights."""
    out = {}
    for d in (100, 40):
        jcfg = jax_tiny(num_layers=2, head_dim=d, num_q_heads=HQ, num_kv_heads=HKV)
        jparams = jax_init(jcfg, jax.random.key(7))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        out[d] = (jcfg, jparams, cfg_at(d), params)
    return out


def test_jax_cache_carried_into_a_pitched_cache_decodes_as_jax(tiny):
    """JAX's int8 prefill cache at D 40 copied into the port's
    QuantizedKVCache (values at rows of 48 bytes): the decode step's logits
    are JAX's at 1e-5, and the pitch columns stay zero."""
    jcfg, jparams, cfg, params = tiny[40]
    ids = np.random.default_rng(360).integers(0, 256, (2, 9)).astype(np.int32)
    jc = JaxQuantizedKVCache.create(jcfg, 2, 128)
    _, jc = jax_forward(jparams, jcfg, jnp.asarray(ids), jc, mode="extend")
    nxt = np.asarray([[5], [77]], np.int32)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc, mode="decode")
    cache = QuantizedKVCache.create(cfg, 2, 128, device="cpu")
    for name in ("k_values", "k_scales", "v_values", "v_scales", "lengths"):
        getattr(cache, name).copy_(torch.from_numpy(np.asarray(getattr(jc, name))))
    got, cache = forward(params, cfg, torch.from_numpy(nxt), cache, mode="decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert_pitched(cache.k_values, 48)
    assert_pitched(cache.v_values, 48)


MODELS = {"d100": (100, None), "d40_int8": (40, "int8")}


@pytest.mark.parametrize("model", list(MODELS))
def test_greedy_generate_at_pitched_head_dims_gives_jax_tokens(tiny, model):
    """Greedy over a pitched fp32 cache (D 100) and an int8 cache (D 40,
    rows of 48 bytes), capacity 128."""
    d, name = MODELS[model]
    jcfg, jparams, cfg, params = tiny[d]
    ids = np.random.default_rng(370 + d).integers(0, 256, (2, 11)).astype(np.int32)
    jkw, tkw = ({}, {}) if name is None else ({"cache_dtype": DTYPES[name][1]},
                                              {"cache_dtype": DTYPES[name][0]})
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 6, cache_capacity=128, **jkw))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 6, cache_capacity=128, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)
ENGINE_RUNS = {"whole": {}, "chunked": {"prefill_chunk": 8}}
NEW = 4


def engine_prompts():
    rng = np.random.default_rng(380)
    return {rid: rng.integers(0, 256, n).tolist() for rid, n in ((0, 13), (1, 6))}


def engine_tokens(eng):
    for rid, prompt in engine_prompts().items():
        eng.submit(rid, prompt, NEW)
    got = eng.run()
    assert not eng.failed
    return got


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
@pytest.mark.parametrize("model", list(MODELS))
def test_engine_at_pitched_head_dims_gives_jax_tokens(tiny, model, run):
    """The ServingEngine over fp32 pages (D 100) and int8 pages (D 40, rows
    of 48 bytes), whole-prompt and chunked admission: each request's tokens
    are JAX's greedy continuation of its prompt, over an int8 cache at D 40
    (JAX's CPU route; its engine has no CPU route but interpret mode, about
    16 s here)."""
    d, name = MODELS[model]
    jcfg, jparams, cfg, params = tiny[d]
    tkw, jkw = ({}, {}) if name is None else ({"kv_dtype": DTYPES[name][0]},
                                              {"cache_dtype": DTYPES[name][1]})
    got = engine_tokens(ServingEngine(params, cfg, **POOL, **ENGINE_RUNS[run], **tkw))
    want = {rid: np.asarray(jax_greedy(jparams, jcfg, jnp.asarray([prompt], jnp.int32), NEW,
                                       **jkw))[0].tolist()
            for rid, prompt in engine_prompts().items()}
    assert got == want
