"""Qwen2 and Mistral in the port against the JAX package and HuggingFace,
on the CPU.

Two tiny fp32 configurations carry what the families add to Llama:
Qwen2-style (4 layers, QKV biases, a window of 16 on layers >=
max_window_layers 2) and Mistral-style (a window of 8 on every layer).
Parameters come from the JAX `init_params` with random non-zero q/k/v
biases written in (JAX's init makes them zeros) and cross through
`params_from_jax`, so both packages hold identical weights; prompts are
longer than the windows. Tolerances: logits at atol 1e-4 (fp32 sums in
other orders), over int8 / e4m3 caches the JAX package's own 0.15 / 0.6
(tests/test_torch_model.py). A bf16 cache may hold a value one bf16 step
from JAX's (K and V differ by fp32 rounding before they are rounded; a
step moves the logits by up to 2e-4 here): it is held to JAX's at rtol
2**-7, then JAX's contents are copied in, so that the logits of the next
forward compare the computation at 1e-4. Greedy, speculative, prompt-lookup and
engine tokens identical; HF `Qwen2ForCausalLM` / `MistralForCausalLM`
logits (random weights, eager attention, built in process, converted
through the JAX package's `params_from_state_dict`) at atol 1e-4.
Each JAX engine runs once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from flash_attention_cute_tpu.models import presets as jax_presets
from flash_attention_cute_tpu.models.cache import KVCache as JaxKVCache
from flash_attention_cute_tpu.models.cache import QuantizedKVCache as JaxQuantizedKVCache
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.convert import params_from_state_dict
from flash_attention_cute_tpu.models.fuse import fuse_projections as jax_fuse
from flash_attention_cute_tpu.models.mistral import mistral_config_from_hf as jax_mistral_hf
from flash_attention_cute_tpu.models.qwen2 import qwen2_config_from_hf as jax_qwen2_hf
from flash_attention_cute_tpu.models.quantize import quantize_params as jax_quantize
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu.runtime import prompt_lookup as jax_pl
from flash_attention_cute_tpu.runtime import speculative as jax_spec
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu.runtime.paged_forward import forward_paged as jax_forward_paged
from flash_attention_cute_tpu_torch.models import presets
from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.fuse import fuse_projections
from flash_attention_cute_tpu_torch.models.mistral import mistral_config_from_hf
from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_config_from_hf
from flash_attention_cute_tpu_torch.models.quantize import dequantize_params, quantize_params
from flash_attention_cute_tpu_torch.models.transformer import BIAS_STD, forward, init_params
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
from flash_attention_cute_tpu_torch.runtime.paged_cache import (
    create_paged_state,
    create_quantized_paged_state,
)
from flash_attention_cute_tpu_torch.runtime.paged_forward import forward_paged
from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate
from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate

FAMILIES = {
    "qwen2": dict(num_layers=4, sliding_window=16, use_sliding_window=True, max_window_layers=2,
                  attention_bias=True),
    "mistral": dict(num_layers=2, sliding_window=8, use_sliding_window=True,
                    max_window_layers=0),
}
QUANT_ATOL = {"int8": 0.15, "float8_e4m3fn": 0.6}


def with_biases(jcfg, jparams, seed):
    """JAX parameters with random non-zero q/k/v biases written in."""
    if not jcfg.attention_bias:
        return jparams
    rng = np.random.default_rng(seed)
    layers = dict(jparams["layers"])
    for name in ("q_bias", "k_bias", "v_bias"):
        layers[name] = jnp.asarray(0.5 * rng.standard_normal(layers[name].shape), jnp.float32)
    return {**jparams, "layers": layers}


def build(family, key=0, **overrides):
    kw = {**FAMILIES[family], **overrides}
    jcfg = jax_tiny(**kw)
    jparams = with_biases(jcfg, jax_init(jcfg, jax.random.key(key)), key)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(**kw), params


@pytest.fixture(scope="module", params=list(FAMILIES))
def model(request):
    return (request.param, *build(request.param))


def ids_of(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def test_configs_presets_and_window_plan():
    hf = dict(vocab_size=1000, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
              num_attention_heads=4, num_key_value_heads=2, use_sliding_window=True,
              sliding_window=1024, max_window_layers=2, tie_word_embeddings=True)
    for got, want in ((qwen2_config_from_hf(hf), jax_qwen2_hf(hf)),
                      (mistral_config_from_hf(transformers.MistralConfig(sliding_window=4096)),
                       jax_mistral_hf(transformers.MistralConfig(sliding_window=4096)))):
        assert {**dataclasses.asdict(got), "dtype": None} == {**dataclasses.asdict(want),
                                                             "dtype": None}
    for name in ("qwen2-7b", "mistral-7b"):
        got, want = presets.get_preset(name), jax_presets.get_preset(name)
        assert got.dtype == torch.bfloat16
        assert {**dataclasses.asdict(got), "dtype": None} == {**dataclasses.asdict(want),
                                                             "dtype": None}
    # JAX's segment rule: the window on layers >= max_window_layers.
    assert [tiny_test_config(**FAMILIES["qwen2"]).layer_window(i) for i in range(4)] == \
        [None, None, 16, 16]
    assert [presets.get_preset("mistral-7b").layer_window(i) for i in (0, 31)] == [4096, 4096]
    assert presets.get_preset("qwen2-7b").layer_window(27) is None  # use_sliding_window false
    # A periodic pattern (Gemma2) gives each layer its window, and the
    # preset's alternate from layer 0.
    assert [tiny_test_config(num_layers=4, layer_window_pattern=(8, None)).layer_window(i)
            for i in range(4)] == [8, None, 8, None]
    gemma = presets.get_preset("gemma2-9b")
    assert [gemma.layer_window(i) for i in (0, 1, 40, 41)] == [4096, None, 4096, None]
    pcfg = tiny_test_config(num_layers=2, layer_window_pattern=(8, None))
    logits, _ = forward(init_params(pcfg, seed=0, device="cpu"), pcfg,
                        torch.from_numpy(ids_of(1, 20, 12)))
    assert logits.shape == (1, 20, 256) and torch.isfinite(logits).all()


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_forward_prefill_decode_extend_match_jax(model, cache_dtype):
    """Prefill 20 tokens (past both windows), two decode steps, then an
    extend of 5 at ragged lengths (a rollback): logits after each."""
    family, jcfg, jparams, cfg, params = model
    quant = cache_dtype != "bfloat16"
    if quant:
        jc = JaxQuantizedKVCache.create(jcfg, 2, 40, getattr(jnp, cache_dtype))
        tc = QuantizedKVCache.create(cfg, 2, 40, getattr(torch, cache_dtype), device="cpu")
    else:
        jc = JaxKVCache.create(jcfg, 2, 40, dtype=jnp.bfloat16)
        tc = KVCache.create(cfg, 2, 40, dtype=torch.bfloat16, device="cpu")
    atol = QUANT_ATOL.get(cache_dtype, 1e-4)

    def sync():
        if quant:
            return
        n = int(tc.lengths.max())
        for name in ("k", "v"):
            got, want = getattr(tc, name), np.asarray(getattr(jc, name), np.float32)
            np.testing.assert_allclose(got[:, :, :, :n].float().numpy(), want[:, :, :, :n],
                                       atol=1e-4, rtol=2.0 ** -7)
            got.copy_(torch.from_numpy(want).to(torch.bfloat16))

    ids = ids_of(2, 20, 1)
    want, jc = jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jc, mode="prefill")
    got, tc = forward(params, cfg, torch.from_numpy(ids), cache=tc, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(2):
        sync()
        want, jc = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=jc, mode="decode")
        got, tc = forward(params, cfg, torch.from_numpy(tok), cache=tc, mode="decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
        tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    sync()
    lengths = np.asarray([22, 17], np.int32)
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths))
    tc = dataclasses.replace(tc, lengths=torch.from_numpy(lengths))
    new = ids_of(2, 5, 2)
    want, jc = jax_forward(jparams, jcfg, jnp.asarray(new), cache=jc, mode="extend")
    got, tc = forward(params, cfg, torch.from_numpy(new), cache=tc, mode="extend")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    assert tc.lengths.tolist() == [27, 22]
    sync()


def test_window_changes_the_logits_and_the_plain_route_agrees(model):
    """The window binds (the same weights without it give other logits) and
    the plain_attention route gives the default route's logits."""
    family, _, _, cfg, params = model
    ids = torch.from_numpy(ids_of(2, 24, 3))
    got, _ = forward(params, cfg, ids)
    unwindowed, _ = forward(params, dataclasses.replace(cfg, use_sliding_window=False), ids)
    assert (got - unwindowed).abs().max() > 1e-2
    cache = KVCache.create(cfg, 2, 30, device="cpu")
    cache.k.fill_(float("nan"))  # uninitialised memory past the lengths
    cache.v.fill_(float("nan"))
    parts = []
    for lo, hi, mode in ((0, 10, "prefill"), (10, 23, "extend"), (23, 24, "decode")):
        logits, cache = forward(params, cfg, ids[:, lo:hi], cache=cache, mode=mode,
                                plain_attention=True)
        parts.append(logits)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), got.numpy(), atol=1e-4, rtol=0)


def test_forward_paged_matches_jax(model):
    """Prefill of two padded prompts (valid 20 and 13), a decode step and a
    6-token extend through one permuted page table: logits after each."""
    family, jcfg, jparams, cfg, params = model
    table = np.array([[3, 1, 4, 9], [5, 8, 2, 7]], np.int32)
    jstate = jax_cache.create_paged_state(jcfg, 10, 8, 2, 4)
    jstate = dataclasses.replace(jstate, page_table=jnp.asarray(table))
    state = create_paged_state(cfg, 10, 8, 2, 4, device="cpu")
    state.page_table = torch.from_numpy(table)
    steps = [("prefill", ids_of(2, 20, 4), np.array([20, 13], np.int32)),
             ("decode", ids_of(2, 1, 5), None), ("extend", ids_of(2, 6, 6), None)]
    for mode, ids, valid in steps:
        jv = None if valid is None else jnp.asarray(valid)
        want, jstate = jax_forward_paged(jparams, jcfg, jnp.asarray(ids), jstate, mode=mode,
                                         valid_len=jv, interpret=True)
        tv = None if valid is None else torch.from_numpy(valid)
        got, state = forward_paged(params, cfg, torch.from_numpy(ids), state, mode=mode,
                                   valid_len=tv)
        rows = [(0, 20), (1, 13)] if mode == "prefill" else [(0, ids.shape[1]), (1, ids.shape[1])]
        for r, n in rows:  # padded positions are garbage on both sides
            np.testing.assert_allclose(got[r, :n].numpy(), np.asarray(want)[r, :n], atol=1e-4,
                                       rtol=0, err_msg=mode)
    assert state.lengths.tolist() == [27, 20]


def test_greedy_generate_token_identical_to_jax(model):
    family, jcfg, jparams, cfg, params = model
    ids = ids_of(2, 18, 7)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 10))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    got8 = greedy_generate(params, cfg, torch.from_numpy(ids), 10, cache_dtype=torch.int8)
    assert got8.shape == (2, 10)


def test_speculative_and_prompt_lookup_token_identical_to_jax(model):
    """Greedy speculation with a 1-layer draft of the family, and prompt
    lookup on a repetitive prompt: JAX's tokens and counts, and the
    port's greedy chain."""
    family, jcfg, jparams, cfg, params = model
    djcfg, djparams, dcfg, dparams = build(family, key=9, num_layers=1, max_window_layers=0)
    ids = ids_of(2, 18, 8)
    got, st = speculative_generate(params, cfg, dparams, dcfg, torch.from_numpy(ids), 12,
                                   gamma=3, return_stats=True)
    want, jst = jax_spec.speculative_generate(jparams, jcfg, djparams, djcfg, jnp.asarray(ids),
                                              12, gamma=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st == jst
    greedy = greedy_generate(params, cfg, torch.from_numpy(ids), 12).numpy()
    np.testing.assert_array_equal(got.numpy(), greedy)
    rep = np.tile(ids_of(2, 6, 9), (1, 4))
    got, st = prompt_lookup_generate(params, cfg, torch.from_numpy(rep), 12, gamma=3, ngram=2,
                                     return_stats=True)
    want, jst = jax_pl.prompt_lookup_generate(jparams, jcfg, jnp.asarray(rep), 12, gamma=3,
                                              ngram=2, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st == jst
    np.testing.assert_array_equal(
        got.numpy(), greedy_generate(params, cfg, torch.from_numpy(rep), 12).numpy())


# The JAX engine tests' windowed configurations: a 4-layer model with a
# window of 12 on layers >= 2 (tests/test_engine.py,
# `test_engine_sliding_window_model`), and a 2-layer one with a window of 16
# on layers >= 1 over int8 pages with chunked admission
# (`test_engine_quantized_chunked_admission_with_window`).
ENGINE_CFGS = {
    "w12": dict(num_layers=4, sliding_window=12, use_sliding_window=True, max_window_layers=2),
    "w16_int8": dict(num_layers=2, sliding_window=16, use_sliding_window=True,
                     max_window_layers=1),
}
ENGINE_RUNS = {
    # name: (config, jax key, prompt (seed, length), new tokens, pool, extra options)
    "w12_whole": ("w12", 5, (3, 20), 5, {}),
    "w12_chunked": ("w12", 5, (3, 20), 5, {"prefill_chunk": 8}),
    "w16_int8_chunked": ("w16_int8", 3, (22, 21), 6, {"prefill_chunk": 8, "kv_dtype": "int8"}),
}
ENGINE_POOL = dict(slots=1, num_pages=9, page_size=8, pages_per_seq=8)


def engine_case(name):
    cfg_name, key, (seed, n), new, extra = ENGINE_RUNS[name]
    kw = ENGINE_CFGS[cfg_name]
    jcfg = jax_tiny(**kw)
    jparams = jax_init(jcfg, jax.random.key(key))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    prompt = [int(x) for x in np.random.default_rng(seed).integers(0, jcfg.vocab_size, n)]
    return jcfg, jparams, tiny_test_config(**kw), params, prompt, new, extra


@pytest.fixture(scope="module")
def jax_engine_tokens():
    """Each JAX engine run of ENGINE_RUNS, once."""
    out = {}
    for name in ENGINE_RUNS:
        jcfg, jparams, _, _, prompt, new, extra = engine_case(name)
        kw = dict(extra)
        if "kv_dtype" in kw:
            kw["kv_dtype"] = getattr(jnp, kw["kv_dtype"])
        eng = JaxServingEngine(jparams, jcfg, **ENGINE_POOL, **kw, interpret=True)
        eng.submit(0, prompt, new)
        out[name] = eng.run()
    return out


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_token_identical_to_jax_engine(name, jax_engine_tokens):
    _, _, cfg, params, prompt, new, extra = engine_case(name)
    kw = dict(extra)
    if "kv_dtype" in kw:
        kw["kv_dtype"] = getattr(torch, kw["kv_dtype"])
    eng = ServingEngine(params, cfg, **ENGINE_POOL, **kw)
    eng.submit(0, prompt, new)
    got = eng.run()
    assert not eng.failed and len(got[0]) == new
    assert got == jax_engine_tokens[name]
    if "kv_dtype" in kw:  # whole-prompt admission gives the chunked tokens (JAX's check)
        eng = ServingEngine(params, cfg, **ENGINE_POOL, kv_dtype=kw["kv_dtype"])
        eng.submit(0, prompt, new)
        assert eng.run() == got
    else:  # and the contiguous-cache greedy chain
        ref = greedy_generate(params, cfg, torch.tensor([prompt]), new)[0].tolist()
        assert got[0] == ref


def test_biases_fuse_and_quantize_as_in_jax():
    """A biased tree fuses as JAX's does (q/k/v biases into qkv_bias); a
    quantized Qwen2 tree keeps its biases in the model dtype, and its
    forward equals JAX's over the same quantized tree and the port's over
    the dequantized image."""
    jcfg, jparams, cfg, params = build("qwen2")
    jfused = jax.tree.map(np.asarray, jax_fuse(jparams))
    fused = fuse_projections(params)
    assert set(fused["layers"]) == set(jfused["layers"])
    np.testing.assert_array_equal(fused["layers"]["qkv_bias"].numpy(),
                                  jfused["layers"]["qkv_bias"])
    ids = ids_of(1, 20, 10)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(ids))
    got, _ = forward(fused, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for bits, tree in ((8, params), (4, fused)):
        q = quantize_params(tree, bits=bits)
        for name in ("q_bias", "k_bias", "v_bias", "qkv_bias"):
            if name in tree["layers"]:
                assert torch.equal(q["layers"][name], tree["layers"][name])
        got, _ = forward(q, cfg, torch.from_numpy(ids))
        dense, _ = forward(dequantize_params(q, torch.float32), cfg, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4, rtol=0)
    jq = jax.tree.map(np.asarray, jax_quantize(jparams))
    want, _ = jax_forward(jax_quantize(jparams), jcfg, jnp.asarray(ids))
    got, _ = forward(params_from_jax(jq, device="cpu"), cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_init_params_draws_nonzero_biases():
    cfg = tiny_test_config(**FAMILIES["qwen2"])
    p = init_params(cfg, seed=1, device="cpu")
    assert p["layers"]["q_bias"].shape == (4, 64) and p["layers"]["k_bias"].shape == (4, 32)
    assert 0.25 * BIAS_STD < p["layers"]["v_bias"].std() < 2 * BIAS_STD
    llama = init_params(tiny_test_config(num_layers=4), seed=1, device="cpu")
    for name, w in llama["layers"].items():  # the biases are drawn last
        assert torch.equal(w, p["layers"][name]), name
    logits, _ = forward(p, cfg, torch.from_numpy(ids_of(1, 20, 11)))
    assert torch.isfinite(logits).all()


def hf_model(family, window):
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  rms_norm_eps=1e-6, attn_implementation="eager")
    torch.manual_seed(8)
    if family == "qwen2":
        hf_cfg = transformers.Qwen2Config(**common, rope_theta=1000000.0,
                                          tie_word_embeddings=True, use_sliding_window=True,
                                          sliding_window=window, max_window_layers=1)
        with torch.device("cpu"):
            model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
        for name, p in model.named_parameters():  # HF initialises the biases to 0
            if name.endswith("proj.bias"):
                torch.nn.init.normal_(p, std=0.5)
        return hf_cfg, model, jax_qwen2_hf, qwen2_config_from_hf
    hf_cfg = transformers.MistralConfig(**common, rope_theta=10000.0, sliding_window=window)
    with torch.device("cpu"):
        model = transformers.MistralForCausalLM(hf_cfg).eval()
    return hf_cfg, model, jax_mistral_hf, mistral_config_from_hf


@pytest.mark.parametrize("window", [64, 8], ids=["window_inert", "window_binds"])
@pytest.mark.parametrize("family", ["qwen2", "mistral"])
def test_logits_match_hf(family, window):
    hf_cfg, model, jax_from_hf, from_hf = hf_model(family, window)
    cfg = from_hf(hf_cfg, dtype=torch.float32)
    jparams = params_from_state_dict(model.state_dict(), jax_from_hf(hf_cfg, dtype=jnp.float32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(24).integers(0, 128, (2, 24))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float().numpy()
    got, _ = forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
