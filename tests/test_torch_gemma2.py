"""Gemma 2 in the port against the JAX package and HuggingFace, on the CPU.

A tiny Gemma2 carries what the family adds to Llama: 4 layers, head dim 16,
alternating windows (pattern (8, None): even layers see 8 keys), an
attention scale from `query_pre_attn_scalar` 24, tanh soft caps on the
scores and the final logits, GeGLU, sandwich norms and scaled embeddings,
tied embeddings. Two cap settings: the model's 50 / 30, and 1.0 / 2.0,
which bind on every score and logit. Parameters come from the JAX
`init_params` with random norm weights written in (JAX's init makes them
ones) and cross through `params_from_jax`, so both packages hold identical
weights; prompts are longer than the window.

Tolerances: fp32 logits at atol 1e-4 (the same sums in other orders);
over a bf16 cache as tests/test_torch_qwen2_mistral.py does (the cache held
to JAX's at rtol 2**-7, then JAX's contents copied in). Greedy and engine
tokens identical. HF `Gemma2ForCausalLM` (random weights, eager attention,
built in process, converted through the JAX package's
`params_from_state_dict`, which folds the +1 of Gemma's norms) at atol
1e-4. Prompt-lookup and self-draft speculative tokens (the extend mode)
identical to JAX's, with JAX's round and acceptance counts; greedy tokens
over int8 and e4m3 contiguous caches identical to JAX's; engine tokens
identical to the JAX engine's over fp32, int8 and e4m3 pages. The plain versions of kernels P / B2, D1 + D2, B5 and B6 at head dim
256 with a binding cap against the JAX kernels in interpret mode at atol
1e-5. The JAX engine runs once, in a module fixture.
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
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.convert import params_from_state_dict
from flash_attention_cute_tpu.models.gemma2 import gemma2_9b_config as jax_gemma2_9b
from flash_attention_cute_tpu.models.gemma2 import gemma2_config_from_hf as jax_gemma2_hf
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime import prompt_lookup as jax_pl
from flash_attention_cute_tpu.runtime import speculative as jax_spec
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.models import gemma2_9b_config, gemma2_config_from_hf
from flash_attention_cute_tpu_torch.models import presets
from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params
from flash_attention_cute_tpu_torch.ops import flash_decode, flash_fwd
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate
from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate

GEMMA2 = dict(num_layers=4, head_dim=16, layer_window_pattern=(8, None),
              attention_scale=24 ** -0.5, hidden_activation="gelu_tanh", sandwich_norms=True,
              scale_embeddings=True, rms_norm_plus_one=True, tie_word_embeddings=True)
CAPS = {"caps_50_30": (50.0, 30.0), "caps_bind_1_2": (1.0, 2.0)}
NORMS = ("input_ln", "post_ln", "pre_ffw_ln", "post_ffw_ln")


def with_norms(jparams, seed):
    """JAX parameters with random norm weights (1 + 0.3 N(0, 1)) written in."""
    rng = np.random.default_rng(seed)
    layers = dict(jparams["layers"])
    for name in NORMS:
        layers[name] = jnp.asarray(1 + 0.3 * rng.standard_normal(layers[name].shape),
                                   jnp.float32)
    final = jnp.asarray(1 + 0.3 * rng.standard_normal(jparams["final_ln"].shape), jnp.float32)
    return {**jparams, "layers": layers, "final_ln": final}


def build(caps, key=0):
    attn_cap, final_cap = CAPS[caps]
    kw = dict(GEMMA2, logit_softcap=attn_cap, final_logit_softcap=final_cap)
    jcfg = jax_tiny(**kw)
    jparams = with_norms(jax_init(jcfg, jax.random.key(key)), key)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(**kw), params


@pytest.fixture(scope="module", params=list(CAPS))
def model(request):
    return build(request.param)


def ids_of(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def fields(cfg):
    return {**dataclasses.asdict(cfg), "dtype": None}


def test_configs_presets_and_window_plan():
    """The preset and the HF mapping equal JAX's field for field (dtype
    aside); windows follow the pattern per layer as JAX's scan does."""
    assert fields(gemma2_9b_config()) == fields(jax_gemma2_9b())
    got = presets.get_preset("gemma2-9b")
    assert got.dtype == torch.bfloat16
    assert fields(got) == fields(jax_presets.get_preset("gemma2-9b"))
    for window in (8, 4096):
        hf = tiny_hf_config(window)
        assert fields(gemma2_config_from_hf(hf)) == fields(jax_gemma2_hf(hf))
    cfg = jax_gemma2_9b()
    want = [cfg.layer_window_pattern[li % len(cfg.layer_window_pattern)]
            for li in range(cfg.num_layers)]
    assert [got.layer_window(li) for li in range(got.num_layers)] == want
    assert want[:3] == [4096, None, 4096]
    with pytest.raises(ValueError, match="tile"):
        tiny_test_config(num_layers=3, layer_window_pattern=(8, None))
    with pytest.raises(ValueError, match="exclusive"):
        tiny_test_config(layer_window_pattern=(8, None), use_sliding_window=True,
                         sliding_window=8)


def test_prefill_logits_match_jax_interpret(model):
    """fp32 prefill logits against JAX's forward with its Pallas kernels in
    interpret mode; the caps and the window bind (other logits without)."""
    jcfg, jparams, cfg, params = model
    ids = ids_of(2, 20, 1)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(ids), interpret=True)
    got, _ = forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert float(got.abs().max()) <= cfg.final_logit_softcap
    for change in (dict(layer_window_pattern=None), dict(logit_softcap=None)):
        other, _ = forward(params, dataclasses.replace(cfg, **change), torch.from_numpy(ids))
        assert (got - other).abs().max() > 1e-3, change


def test_prefill_decode_extend_over_bf16_cache_match_jax(model):
    """Prefill 20 tokens into a bf16 cache, two decode steps, then an extend
    of 5 at ragged lengths: logits after each, against JAX."""
    jcfg, jparams, cfg, params = model
    jc = JaxKVCache.create(jcfg, 2, 40, dtype=jnp.bfloat16)
    tc = KVCache.create(cfg, 2, 40, dtype=torch.bfloat16, device="cpu")

    def sync():
        n = int(tc.lengths.max())
        for name in ("k", "v"):
            got, want = getattr(tc, name), np.asarray(getattr(jc, name), np.float32)
            np.testing.assert_allclose(got[:, :, :, :n].float().numpy(), want[:, :, :, :n],
                                       atol=1e-4, rtol=2.0 ** -7)
            got.copy_(torch.from_numpy(want).to(torch.bfloat16))

    ids = ids_of(2, 20, 2)
    want, jc = jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jc, mode="prefill")
    got, tc = forward(params, cfg, torch.from_numpy(ids), cache=tc, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(2):
        sync()
        want, jc = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=jc, mode="decode")
        got, tc = forward(params, cfg, torch.from_numpy(tok), cache=tc, mode="decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    sync()
    lengths = np.asarray([22, 17], np.int32)
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths))
    tc = dataclasses.replace(tc, lengths=torch.from_numpy(lengths))
    new = ids_of(2, 5, 3)
    want, jc = jax_forward(jparams, jcfg, jnp.asarray(new), cache=jc, mode="extend")
    got, tc = forward(params, cfg, torch.from_numpy(new), cache=tc, mode="extend")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert tc.lengths.tolist() == [27, 22]
    sync()


def tiny_hf_config(window=8, caps=(50.0, 30.0)):
    """The JAX package's tiny HF Gemma2 (tests/test_models.py)."""
    return transformers.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False, tie_word_embeddings=True,
        sliding_window=window, query_pre_attn_scalar=24, attn_logit_softcapping=caps[0],
        final_logit_softcapping=caps[1], hidden_activation="gelu_pytorch_tanh",
        attn_implementation="eager")


@pytest.mark.parametrize("caps", list(CAPS))
def test_logits_match_hf(caps):
    hf_cfg = tiny_hf_config(caps=CAPS[caps])
    torch.manual_seed(4)
    with torch.device("cpu"):
        model = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    for name, p in model.named_parameters():  # HF initialises Gemma's norms to 0 (weight 1)
        if name.endswith("norm.weight"):
            torch.nn.init.normal_(p, std=0.3)
    cfg = gemma2_config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.layer_window_pattern == (8, None)
    jparams = params_from_state_dict(model.state_dict(), jax_gemma2_hf(hf_cfg, dtype=jnp.float32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(20).integers(0, 128, (2, 24))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float().numpy()
    got, _ = forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_greedy_generate_token_identical_to_jax(model):
    jcfg, jparams, cfg, params = model
    ids = ids_of(2, 18, 5)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 10))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache_dtype", ["int8", "float8_e4m3fn"])
def test_greedy_generate_over_quantized_cache_token_identical_to_jax(model, cache_dtype):
    """Greedy generation over an int8 / e4m3 contiguous cache (QA, then B7 +
    D2 with the soft cap and the windows) gives JAX's tokens. The capacity
    is one block_kv of JAX's kernel (ROADMAP.md C: its interpret mode gives
    NaN on a ragged e4m3 tail block)."""
    jcfg, jparams, cfg, params = model
    ids = ids_of(2, 18, 5)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 10, cache_capacity=128,
                                 cache_dtype=getattr(jnp, cache_dtype)))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 10, cache_capacity=128,
                          cache_dtype=getattr(torch, cache_dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prompt_lookup_token_identical_to_jax(model):
    """Prompt lookup (the extend mode, B4's route, with the soft cap and the
    windows) on a repeating prompt longer than the window: JAX's tokens,
    rounds and accepted drafts, and greedy's tokens."""
    jcfg, jparams, cfg, params = model
    ids = np.tile(ids_of(1, 6, 23), (2, 4))
    want, jst = jax_pl.prompt_lookup_generate(jparams, jcfg, jnp.asarray(ids), 10, gamma=4,
                                              ngram=2, return_stats=True)
    got, st = prompt_lookup_generate(params, cfg, torch.from_numpy(ids), 10, gamma=4, ngram=2,
                                     return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  greedy_generate(params, cfg, torch.from_numpy(ids), 10).numpy())
    assert st == jst


def test_self_draft_speculative_token_identical_to_jax(model):
    """Speculative generation with the model as its own draft (verify
    extends through B4's route, draft decodes through D1's): JAX's tokens,
    rounds and accepted drafts, and greedy's tokens."""
    jcfg, jparams, cfg, params = model
    ids = ids_of(2, 18, 6)
    want, jst = jax_spec.speculative_generate(jparams, jcfg, jparams, jcfg, jnp.asarray(ids), 12,
                                              gamma=3, return_stats=True)
    got, st = speculative_generate(params, cfg, params, cfg, torch.from_numpy(ids), 12, gamma=3,
                                   return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  greedy_generate(params, cfg, torch.from_numpy(ids), 12).numpy())
    assert st == jst


# Two requests (13 and 6 prompt tokens, the first past the window), 5 new
# tokens each, 2 slots: whole-prompt admission, and chunks of 4 tokens, over
# fp32 pages and over int8 / e4m3 pages (`kv_dtype`, by name).
ENGINE_RUNS = {"whole": {}, "chunked": {"prefill_chunk": 4},
               "whole int8": {"kv_dtype": "int8"},
               "chunked e4m3": {"prefill_chunk": 4, "kv_dtype": "float8_e4m3fn"}}
ENGINE_POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)


def engine_options(name, module):
    """ENGINE_RUNS[name] with its value dtype taken from `module` (jnp or
    torch)."""
    kw = dict(ENGINE_RUNS[name])
    if "kv_dtype" in kw:
        kw["kv_dtype"] = getattr(module, kw["kv_dtype"])
    return kw


def engine_prompts():
    rng = np.random.default_rng(22)
    return {0: rng.integers(0, 256, 13).tolist(), 1: rng.integers(0, 256, 6).tolist()}


@pytest.fixture(scope="module")
def jax_engine_tokens():
    """The JAX engine's tokens for each run of ENGINE_RUNS, once."""
    jcfg, jparams, _, _ = build("caps_bind_1_2", key=3)
    out = {}
    for name in ENGINE_RUNS:
        eng = JaxServingEngine(jparams, jcfg, **ENGINE_POOL, **engine_options(name, jnp),
                               interpret=True)
        for rid, prompt in engine_prompts().items():
            eng.submit(rid, prompt, 5)
        out[name] = eng.run()
    return out


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_token_identical_to_jax_engine(name, jax_engine_tokens):
    _, _, cfg, params = build("caps_bind_1_2", key=3)
    eng = ServingEngine(params, cfg, **ENGINE_POOL, **engine_options(name, torch))
    prompts = engine_prompts()
    for rid, prompt in prompts.items():
        eng.submit(rid, prompt, 5)
    got = eng.run()
    assert not eng.failed and sorted(got) == [0, 1]
    assert got == jax_engine_tokens[name]
    if "kv_dtype" in ENGINE_RUNS[name]:
        return  # quantized pages: their rows are not the fp32 cache's
    for rid, prompt in prompts.items():  # and the contiguous-cache greedy chain
        ref = greedy_generate(params, cfg, torch.tensor([prompt]), 5)[0].tolist()
        assert got[rid] == ref


# The kernels' plain versions at head dim 256 with a cap of 1.0, which binds
# on every score (scores of these inputs reach about 10), at Gemma-2-9B's
# scale 256 ** -0.5 and GQA group 2.
D, CAP, HQ, HKV = 256, 1.0, 4, 2


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def t(*arrays):
    """Torch copies (JAX on the CPU may alias a numpy buffer)."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 24], ids=["P", "B2_window24"])
def test_prefill_plain_at_d256_with_cap_matches_jax_kernel(window):
    rng = np.random.default_rng(30)
    q, k, v = normal(rng, 2, HQ, 70, D), normal(rng, 2, HKV, 70, D), normal(rng, 2, HKV, 70, D)
    want = jax_fwd(*j(q, k, v), causal=True, window=window, logit_softcap=CAP, interpret=True)
    got = flash_fwd.flash_attention_fwd(*t(q, k, v), causal=True, window=window,
                                        logit_softcap=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    uncapped = flash_fwd.flash_attention_fwd(*t(q, k, v), causal=True, window=window)
    assert (got - uncapped).abs().max() > 1e-2


@pytest.mark.parametrize("window", [None, 30], ids=["full", "window30"])
def test_decode_plain_at_d256_with_cap_matches_jax_kernel(window):
    """D1 + D2 over a cache [B, Hkv, C, D] with ragged lengths (one 0)."""
    rng = np.random.default_rng(31)
    q, k, v = normal(rng, 3, HQ, 1, D), normal(rng, 3, HKV, 96, D), normal(rng, 3, HKV, 96, D)
    lens = np.asarray([96, 41, 0], np.int32)
    want = jax_decode(*j(q, k, v), kv_length=jnp.asarray(lens), window=window,
                      logit_softcap=CAP, block_kv=32, interpret=True)
    got = flash_decode.flash_attention_decode(*t(q, k, v), kv_length=torch.from_numpy(lens),
                                              window=window, logit_softcap=CAP, num_splits=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


def paged_inputs(seed, b, sq, ps, pps):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    q = normal(rng, b, HQ, sq, D)
    kp, vp = normal(rng, HKV, num_pages, ps, D), normal(rng, HKV, num_pages, ps, D)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return q, kp, vp, table


def test_paged_decode_plain_at_d256_with_cap_matches_jax_kernel():
    q, kp, vp, table = paged_inputs(32, 3, 1, 16, 4)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_pa.paged_attention_decode(*j(q, kp, vp, lens, table), logit_softcap=CAP,
                                         pages_per_compute_block=2, interpret=True)
    got = pa.paged_attention_decode(*t(q, kp, vp, lens, table), logit_softcap=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


def test_paged_extend_plain_at_d256_with_cap_matches_jax_kernel():
    q, kp, vp, table = paged_inputs(33, 3, 16, 8, 8)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_pa.paged_attention_extend(*j(q, kp, vp, off, kvl, table), window=20,
                                         logit_softcap=CAP, pages_per_compute_block=2,
                                         interpret=True)
    got = pa.paged_attention_extend(*t(q, kp, vp, off, kvl, table), window=20,
                                    logit_softcap=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got[2] == 0).all()


def test_capped_prefill_under_autograd_raises_off_the_cpu_and_stays_differentiable_on_it():
    """No backward kernel takes the soft cap: a capped prefill under
    autograd on a device tensor raises (the kernel would return a result
    without a gradient). On the CPU the plain version is differentiated,
    and so is a whole Gemma2 forward."""
    q = torch.empty(1, 4, 64, D, dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty(1, 2, 64, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10b"):
        api.flash_attn_func(q, k, k, causal=True, logit_softcap=50.0)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        api.flash_attn_func(q, k, k, causal=True, logit_softcap=50.0)  # the kernel's route
    cfg = tiny_test_config(**GEMMA2, logit_softcap=1.0, final_logit_softcap=2.0)
    params = init_params(cfg, seed=0, device="cpu")
    assert {"pre_ffw_ln", "post_ffw_ln"} <= set(params["layers"])
    params["embed"].requires_grad_()
    logits, _ = forward(params, cfg, torch.from_numpy(ids_of(1, 12, 6)))
    logits.logsumexp(-1).sum().backward()
    assert params["embed"].grad is not None and torch.isfinite(params["embed"].grad).all()

