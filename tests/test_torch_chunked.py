"""The port's chunked extend against the JAX package, on the CPU: the plain
version of kernel B4 against the JAX kernel `flash_attention_chunked` in
interpret mode (as tests/test_flash_chunked.py runs it), the API's extend
route against the JAX API's, and the model's extend mode against JAX
`forward(mode="extend")` over dense and quantized caches.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 attention outputs and partials at atol 1e-4 (sums in other
orders; JAX folds scale * log2(e) into q, the port into the scores); model
logits over a dense cache at 1e-4, over quantized caches at the JAX
package's own tolerances (tests/test_quantized_cache.py): 0.15 for int8 and
0.6 for e4m3, because K differs from JAX's by fp32 rounding and a value at
a rounding edge may move by one quantum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu import api as jax_api
from flash_attention_cute_tpu.models.cache import KVCache as JaxKVCache
from flash_attention_cute_tpu.models.cache import QuantizedKVCache as JaxQuantizedKVCache
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops.flash_chunked import flash_attention_chunked as jax_chunked
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.ops import flash_chunked

CASES = {
    # name: (b, hq, hkv, s, capacity, d, q_offset, kv_length (None: q_offset
    #        + s), causal, window, logit_softcap)
    "ragged_offsets": (3, 4, 2, 16, 200, 32, [0, 37, 150], None, True, None, None),
    "s70_not_a_block_multiple": (2, 4, 1, 70, 300, 64, [5, 200], None, True, None, None),
    "noncausal_length_mask": (2, 4, 2, 20, 160, 32, [0, 60], [50, 140], False, None, None),
    "window": (2, 4, 2, 24, 200, 32, [10, 120], None, True, 16, None),
    "softcap": (2, 4, 2, 24, 200, 32, [0, 90], None, True, None, 5.0),
    "kv_length_zero": (3, 4, 2, 8, 64, 32, [0, 0, 20], [0, 8, 28], True, None, None),
}


def chunk_inputs(b, hq, hkv, s, cap, d, offs, kvl, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, cap, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, cap, d), dtype=np.float32)
    offs = np.asarray(offs, np.int32)
    kvl = offs + s if kvl is None else np.asarray(kvl, np.int32)
    return q, k, v, offs, kvl


@pytest.mark.parametrize("partials", [False, True], ids=["output", "partials"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_chunked_plain_matches_jax_kernel(case, partials):
    b, hq, hkv, s, cap, d, offs, kvl, causal, window, softcap = CASES[case]
    q, k, v, offs, kvl = chunk_inputs(b, hq, hkv, s, cap, d, offs, kvl)
    kw = dict(causal=causal, window=window, logit_softcap=softcap, return_partials=partials)
    want = jax_chunked(*(jnp.asarray(x) for x in (q, k, v, offs, kvl)), interpret=True, **kw)
    got = flash_chunked.flash_attention_chunked(
        *(torch.from_numpy(x) for x in (q, k, v, offs, kvl)), **kw)
    if not partials:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # o (or o_unnorm), then m in log2 units, then l
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-6)
    out = got[0]
    for i, n in enumerate(kvl):
        if n == 0:  # an inactive row: exact zeros (and m = l = 0)
            assert all((x[i] == 0).all() for x in got)
    assert torch.isfinite(out).all()


# Gemma-2-9B's head dim and soft caps (its 50, and 1.0, which binds on every
# score), windowed and not, at Qwen2-7B's GQA group of 7: (q_offset,
# kv_length (None: q_offset + s), window, cap).
D256_CASES = {
    "cap50": ([0, 40], None, None, 50.0),
    "cap1": ([7, 60], [15, 68], None, 1.0),
    "cap50_window16": ([30, 70], None, 16, 50.0),
    "cap1_window16_inactive_row": ([0, 55], [0, 63], 16, 1.0),
}


@pytest.mark.parametrize("case", list(D256_CASES), ids=list(D256_CASES))
def test_chunked_plain_at_d256_with_cap_matches_jax_kernel(case):
    """B4's plain version at D 256 with the caps and windows, GQA group 7,
    against the JAX kernel in interpret mode at atol 1e-5 (fp32 sums in
    another order)."""
    offs, kvl, window, cap = D256_CASES[case]
    q, k, v, offs, kvl = chunk_inputs(2, 14, 2, 8, 96, 256, offs, kvl, seed=3)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    want = jax_chunked(*(jnp.asarray(x) for x in (q, k, v, offs, kvl)), interpret=True, **kw)
    got = flash_chunked.flash_attention_chunked(
        *(torch.from_numpy(x) for x in (q, k, v, offs, kvl)), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for i, n in enumerate(kvl):
        if n == 0:
            assert (got[i] == 0).all()


def test_chunked_plain_never_reads_past_kv_length():
    """The cache tail past kv_length is uninitialised memory: NaN there
    must not reach the output or the partials."""
    q, k, v, offs, kvl = chunk_inputs(2, 4, 2, 12, 96, 32, [3, 40], None, seed=1)
    args = [torch.from_numpy(x) for x in (q, k, v, offs, kvl)]
    clean = flash_chunked.flash_attention_chunked(*args)
    clean_parts = flash_chunked.flash_attention_chunked(*args, return_partials=True)
    for i, n in enumerate(kvl):
        args[1][i, :, n:] = float("nan")
        args[2][i, :, n:] = float("nan")
    assert torch.equal(flash_chunked.flash_attention_chunked(*args), clean)
    for a, b in zip(flash_chunked.flash_attention_chunked(*args, return_partials=True),
                    clean_parts):
        assert torch.equal(a, b)
    # kv_length past the capacity is clamped to it, as the JAX wrapper does.
    big = torch.tensor([200, 200], dtype=torch.int32)
    q_, k_, v_, off = args[:4]
    full = flash_chunked.flash_attention_chunked(q_, k_.nan_to_num(), v_.nan_to_num(), off, big)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(jax_chunked(*(jnp.asarray(x.numpy()) for x in (q_, k_.nan_to_num(),
                                                                   v_.nan_to_num(), off, big)),
                               interpret=True)),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("given", ["both", "kv_length_only", "q_offset_only"])
def test_api_extend_route_matches_jax_api(given):
    """kv_length None means the full Skv; q_offset None means kv_length - sq."""
    q, k, v, offs, kvl = chunk_inputs(2, 4, 2, 6, 48, 16, [10, 30], None, seed=2)
    kw_j, kw_t = {}, {}
    if given != "q_offset_only":
        kw_j["kv_length"], kw_t["kv_length"] = jnp.asarray(kvl), torch.from_numpy(kvl)
    if given != "kv_length_only":
        kw_j["q_offset"], kw_t["q_offset"] = jnp.asarray(offs), torch.from_numpy(offs)
    want = jax_api.flash_attention_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=True, interpret=True, **kw_j)
    got = api.flash_attn_func(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---- the model's extend mode ----


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny()
    jparams = jax_init(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(), params


def ids_of(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def prefill_then_rollback(jcfg, jparams, cfg, params, jcache, cache, ids, lengths):
    """Prefill both packages, then set ragged lengths (a speculative
    rollback) so the extend runs at per-row offsets."""
    _, jcache = jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jcache, mode="prefill")
    _, cache = forward(params, cfg, torch.from_numpy(ids), cache=cache, mode="prefill")
    lengths = np.asarray(lengths, np.int32)
    jcache = dataclasses.replace(jcache, lengths=jnp.asarray(lengths))
    cache = dataclasses.replace(cache, lengths=torch.from_numpy(lengths))
    return jcache, cache


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_forward_extend_logits_and_cache_match_jax(tiny, cache_dtype):
    jcfg, jparams, cfg, params = tiny
    jc = JaxKVCache.create(jcfg, 2, 32, dtype=getattr(jnp, cache_dtype))
    tc = KVCache.create(cfg, 2, 32, dtype=getattr(torch, cache_dtype), device="cpu")
    jc, tc = prefill_then_rollback(jcfg, jparams, cfg, params, jc, tc, ids_of(2, 10, 3), [10, 6])
    new = ids_of(2, 5, 4)
    j_logits, jc = jax_forward(jparams, jcfg, jnp.asarray(new), cache=jc, mode="extend")
    logits, tc = forward(params, cfg, torch.from_numpy(new), cache=tc, mode="extend")
    assert logits.shape == (2, 5, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [15, 11]
    # A bf16 cache may hold a value one bf16 step (at most 2**-7 of it) from
    # JAX's: K and V differ by fp32 rounding before they are rounded.
    rtol = 2.0 ** -7 if cache_dtype == "bfloat16" else 0
    for name in ("k", "v"):
        got, want = getattr(tc, name).float().numpy(), np.asarray(getattr(jc, name), np.float32)
        for i, n in enumerate([15, 11]):
            np.testing.assert_allclose(got[:, i, :, :n], want[:, i, :, :n], atol=1e-4, rtol=rtol)
    # One more token through extend equals the decode mode.
    tok = np.array([[7], [200]], np.int32)
    a, _ = forward(params, cfg, torch.from_numpy(tok), cache=tc, mode="extend")
    b, _ = forward(params, cfg, torch.from_numpy(tok), cache=tc, mode="decode")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_forward_extend_equals_one_prefill_and_plain_route(tiny):
    """Prefill 6, extend 5, extend 9: the logits of one 20-token prefill at
    the same positions, on the kernel route and on plain_attention."""
    _, _, cfg, params = tiny
    ids = torch.from_numpy(ids_of(2, 20, 5))
    full, _ = forward(params, cfg, ids)
    for plain in (False, True):
        cache = KVCache.create(cfg, 2, 24, device="cpu")
        cache.k.fill_(float("nan"))  # uninitialised memory past the lengths
        cache.v.fill_(float("nan"))
        parts = []
        for lo, hi, mode in ((0, 6, "prefill"), (6, 11, "extend"), (11, 20, "extend")):
            logits, cache = forward(params, cfg, ids[:, lo:hi], cache=cache, mode=mode,
                                    plain_attention=plain)
            parts.append(logits)
        np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("tdtype,jdtype,atol", [(torch.int8, jnp.int8, 0.15),
                                               (torch.float8_e4m3fn, jnp.float8_e4m3fn, 0.6)],
                         ids=["int8", "e4m3"])
def test_quantized_cache_extend_tracks_jax(tiny, tdtype, jdtype, atol):
    """Quantize-append of the chunk (kernel QA's plain version), then the
    dense extend over the dequantized layer slab, as JAX does."""
    jcfg, jparams, cfg, params = tiny
    jc = JaxQuantizedKVCache.create(jcfg, 2, 32, jdtype)
    tc = QuantizedKVCache.create(cfg, 2, 32, tdtype, device="cpu")
    jc, tc = prefill_then_rollback(jcfg, jparams, cfg, params, jc, tc, ids_of(2, 12, 6), [12, 9])
    for step, s in enumerate((4, 3)):
        new = ids_of(2, s, 7 + step)
        j_logits, jc = jax_forward(jparams, jcfg, jnp.asarray(new), cache=jc, mode="extend")
        logits, tc = forward(params, cfg, torch.from_numpy(new), cache=tc, mode="extend")
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=atol, rtol=0)
    assert tc.lengths.tolist() == [19, 16]
    for i, n in enumerate([19, 16]):
        np.testing.assert_allclose(tc.k_scales[:, i, :, :n].numpy(),
                                   np.asarray(jc.k_scales)[:, i, :, :n], rtol=1e-5, atol=0)
    # The plain route over the same quantized cache gives the same logits.
    twin = dataclasses.replace(tc, lengths=torch.tensor([19, 16], dtype=torch.int32))
    new = torch.from_numpy(ids_of(2, 3, 9))
    a, _ = forward(params, cfg, new, cache=dataclasses.replace(
        twin, **{f: getattr(twin, f).clone() for f in ("k_values", "k_scales", "v_values",
                                                       "v_scales")}), mode="extend")
    b, _ = forward(params, cfg, new, cache=twin, mode="extend", plain_attention=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_forward_extend_refuses_a_missing_cache(tiny):
    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="needs a cache"):
        forward(params, cfg, torch.zeros(1, 3, dtype=torch.long), mode="extend")
