"""The port's model, sampling and generation against the JAX package, on
the CPU, plus the port's import boundary and device defaults.

Parameters come from the JAX `init_params` and cross through
`params_from_jax` as numpy arrays, so both sides hold identical weights.
Tolerances are fp32: 1e-4 on logits (two layers of matmuls summed in
different orders); greedy tokens must be identical. Over a quantized KV
cache the decode logits are held to the JAX package's own tolerances
(tests/test_quantized_cache.py): 0.15 for int8 and 0.6 for e4m3, because K
differs from JAX's by fp32 rounding and a value at a rounding edge may move
by one quantum.
"""

import ast
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models import layers as jax_layers
from flash_attention_cute_tpu.models.cache import KVCache as JaxKVCache
from flash_attention_cute_tpu.models.cache import QuantizedKVCache as JaxQuantizedKVCache
from flash_attention_cute_tpu.models.config import RopeScaling as JaxRopeScaling
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.runtime import sampling as jax_sampling
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch.models import layers, presets
from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import RopeScaling, tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.llama import llama3_8b_config, llama_config_from_hf
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params
from flash_attention_cute_tpu_torch.runtime import sampling
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate, prefill

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "flash_attention_cute_tpu_torch"


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny()
    jparams = jax_init(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(), params


def prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def test_forward_prefill_and_decode_match_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    ids = prompt(2, 9)
    j_logits, j_cache = jax_forward(
        jparams, jcfg, jnp.asarray(ids), cache=JaxKVCache.create(jcfg, 2, 16), mode="prefill"
    )
    logits, cache = forward(
        params, cfg, torch.from_numpy(ids), cache=KVCache.create(cfg, 2, 16, device="cpu"),
        mode="prefill",
    )
    assert logits.shape == (2, 9, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    assert cache.lengths.tolist() == [9, 9]

    tok = np.array([[3], [250]], np.int32)
    j_logits, _ = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=j_cache, mode="decode")
    logits, cache = forward(params, cfg, torch.from_numpy(tok), cache=cache, mode="decode")
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    assert cache.lengths.tolist() == [10, 10]
    np.testing.assert_allclose(
        cache.k[:, :, :, :10].numpy(), np.asarray(_jax_cache_after(jcfg, jparams, ids, tok))[:, :, :, :10],
        atol=1e-4, rtol=0,
    )


def _jax_cache_after(jcfg, jparams, ids, tok):
    _, c = jax_forward(jparams, jcfg, jnp.asarray(ids), cache=JaxKVCache.create(jcfg, 2, 16),
                       mode="prefill")
    _, c = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=c, mode="decode")
    return c.k


def test_tied_embeddings_forward_matches_jax():
    jcfg = jax_tiny(tie_word_embeddings=True)
    jparams = jax_init(jcfg, jax.random.key(1))
    assert "lm_head" not in jparams
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = prompt(1, 7, seed=1)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(ids))
    got, _ = forward(params, tiny_test_config(tie_word_embeddings=True), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_greedy_generate_token_identical_to_jax(tiny, interpret):
    jcfg, jparams, cfg, params = tiny
    ids = prompt(2, 9, seed=2)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 12, interpret=interpret))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 12)
    assert got.shape == (2, 12) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_eos_done_masking(tiny):
    _, _, cfg, params = tiny
    ids = torch.from_numpy(prompt(2, 5, seed=3))
    free = greedy_generate(params, cfg, ids, 8)
    eos = int(free[0, 2])
    got = greedy_generate(params, cfg, ids, 8, eos_token_id=eos)
    for row_free, row in zip(free.tolist(), got.tolist()):
        if eos in row_free:
            cut = row_free.index(eos)
            assert row[: cut + 1] == row_free[: cut + 1]
            assert all(x == eos for x in row[cut:])
        else:
            assert row == row_free


@pytest.mark.parametrize("tdtype,jdtype,atol", [(torch.int8, jnp.int8, 0.15),
                                               (torch.float8_e4m3fn, jnp.float8_e4m3fn, 0.6)],
                         ids=["int8", "e4m3"])
def test_quantized_cache_prefill_and_decode_track_jax(tiny, tdtype, jdtype, atol):
    """Prefill attends the fresh K/V (identical to the dense path), then
    three decode steps over the quantized cache (kernel B7's plain version
    here, JAX's dequantize-and-attend route)."""
    jcfg, jparams, cfg, params = tiny
    ids = prompt(2, 12, seed=8)
    j_logits, j_cache = jax_forward(jparams, jcfg, jnp.asarray(ids),
                                    cache=JaxQuantizedKVCache.create(jcfg, 2, 32, jdtype),
                                    mode="prefill")
    cache = QuantizedKVCache.create(cfg, 2, 32, tdtype, device="cpu")
    logits, cache = forward(params, cfg, torch.from_numpy(ids), cache=cache, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    assert cache.k_values.dtype == tdtype and cache.lengths.tolist() == [12, 12]
    tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1).astype(np.int32)[:, None]
    for _ in range(3):
        j_logits, j_cache = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=j_cache,
                                        mode="decode")
        logits, cache = forward(params, cfg, torch.from_numpy(tok), cache=cache, mode="decode")
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=atol, rtol=0)
        tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1).astype(np.int32)[:, None]
    assert cache.lengths.tolist() == [15, 15]
    np.testing.assert_allclose(cache.k_scales[:, :, :, :15].numpy(),
                               np.asarray(j_cache.k_scales)[:, :, :, :15], rtol=1e-5, atol=0)


def test_greedy_generate_with_quantized_cache(tiny):
    _, _, cfg, params = tiny
    ids = torch.from_numpy(prompt(1, 10, seed=9))
    last, cache = prefill(params, cfg, ids, cache_capacity=24, cache_dtype=torch.int8)
    assert isinstance(cache, QuantizedKVCache) and cache.lengths.tolist() == [10]
    out = greedy_generate(params, cfg, ids, 6, cache_capacity=24, cache_dtype=torch.int8)
    assert out.shape == (1, 6) and out.dtype == torch.int32
    # The same tokens as a hand-driven decode over the quantized cache.
    want, tok = [], last.argmax(-1)
    for _ in range(6):
        want.append(int(tok))
        logits, cache = forward(params, cfg, tok[:, None], cache=cache, mode="decode")
        tok = logits[:, 0].argmax(-1)
    assert out[0].tolist() == want
    _, dense = prefill(params, cfg, ids, cache_capacity=24, cache_dtype=torch.float32)
    assert isinstance(dense, KVCache)


def rope_cfgs():
    return {
        "default": None,
        "linear": (JaxRopeScaling("linear", 4.0), RopeScaling("linear", 4.0)),
        "dynamic": (JaxRopeScaling("dynamic", 2.0, original_max_position_embeddings=64),
                    RopeScaling("dynamic", 2.0, original_max_position_embeddings=64)),
        "llama3": (JaxRopeScaling("llama3", 8.0, 1.0, 4.0, 8192),
                   RopeScaling("llama3", 8.0, 1.0, 4.0, 8192)),
    }


@pytest.mark.parametrize("variant", list(rope_cfgs()))
def test_rope_inv_freq_variants_match_jax(variant):
    sc = rope_cfgs()[variant]
    jcfg = jax_tiny(head_dim=64, rope_theta=500000.0, rope_scaling=sc and sc[0])
    cfg = tiny_test_config(head_dim=64, rope_theta=500000.0, rope_scaling=sc and sc[1])
    np.testing.assert_allclose(
        layers.rope_inv_freq(cfg).numpy(), np.asarray(jax_layers.rope_inv_freq(jcfg)),
        rtol=1e-6, atol=0,
    )


def test_rms_norm_and_rope_bf16_cast_points_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    w = rng.standard_normal(64, dtype=np.float32)
    want = jax_layers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
    got = layers.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    pos = np.arange(10, dtype=np.int32)[None].repeat(2, 0)
    inv = jax_layers.rope_inv_freq(jax_tiny())
    jc, js = jax_layers.rope_cos_sin(jnp.asarray(pos), inv, jnp.bfloat16)
    tc, ts = layers.rope_cos_sin(torch.from_numpy(pos), layers.rope_inv_freq(tiny_test_config()),
                                 torch.bfloat16)
    np.testing.assert_allclose(tc.float().numpy(), np.asarray(jc, np.float32), atol=8e-3, rtol=0)
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32), atol=8e-3, rtol=0)


FILTERS = {
    "top_k": sampling.SamplingParams(temperature=0.7, top_k=5),
    "top_p": sampling.SamplingParams(temperature=1.3, top_p=0.8),
    "min_p": sampling.SamplingParams(temperature=1.0, min_p=0.1),
    "all": sampling.SamplingParams(temperature=0.9, top_k=40, top_p=0.9, min_p=0.05),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_logits_masks_match_jax(name):
    p = FILTERS[name]
    jp = jax_sampling.SamplingParams(p.temperature, p.top_k, p.top_p, p.min_p)
    logits = 3.0 * np.random.default_rng(5).standard_normal((4, 300), dtype=np.float32)
    want = np.asarray(jax_sampling.filter_logits(jnp.asarray(logits), jp))
    got = sampling.filter_logits(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


def test_penalties_and_greedy_sample_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 50), dtype=np.float32)
    pc = rng.integers(0, 2, (3, 50)).astype(np.float32)
    oc = rng.integers(0, 3, (3, 50)).astype(np.float32)
    rep, pres, freq = (np.array(a, np.float32) for a in ([1.2, 1.0, 2.0], [0.0, 0.5, 0.1],
                                                           [0.3, 0.0, 0.2]))
    want = jax_sampling.apply_penalties(*(jnp.asarray(a) for a in (logits, pc, oc, rep, pres, freq)))
    got = sampling.apply_penalties(*(torch.from_numpy(a) for a in (logits, pc, oc, rep, pres, freq)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        sampling.sample_token(got).numpy(), np.asarray(jax_sampling.sample_token(want, None))
    )


def test_temperature_sampling_draws_from_filtered_support():
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 100), dtype=np.float32))
    p = sampling.SamplingParams(temperature=1.0, top_k=3)
    gen = torch.Generator().manual_seed(0)
    allowed = torch.topk(logits, 3).indices
    for _ in range(20):
        tok = sampling.sample_token(logits, gen, p)
        assert tok.dtype == torch.int32
        assert all(int(tok[i]) in allowed[i].tolist() for i in range(2))
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample_token(logits, None, p)


def test_configs_and_presets():
    hf = {"vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
          "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
          "max_position_embeddings": 8192, "rms_norm_eps": 1e-5, "rope_theta": 500000.0}
    assert llama_config_from_hf(hf) == llama3_8b_config()
    assert presets.get_preset("llama3-8b").dtype == torch.bfloat16
    assert presets.get_preset("tiny", dtype=torch.float32) == tiny_test_config()
    gemma = presets.get_preset("gemma2-9b")  # builds: Gemma2 runs in the port
    assert (gemma.head_dim, gemma.logit_softcap, gemma.final_logit_softcap) == (256, 50.0, 30.0)
    # `forward` takes a soft cap: on the CPU the plain version applies it.
    cfg = tiny_test_config(logit_softcap=1.0)
    params = init_params(cfg, seed=0, device="cpu")
    ids = torch.arange(12).reshape(1, 12)
    capped, _ = forward(params, cfg, ids)
    plain, _ = forward(params, tiny_test_config(), ids)
    assert torch.isfinite(capped).all() and (capped - plain).abs().max() > 1e-4


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flash_attention_cute_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'flash_attention_cute_tpu'\n"
        "             or n.startswith('flash_attention_cute_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flash_attention_cute_tpu"), (f, mod)


def test_entry_points_default_to_cuda():
    for fn in (init_params, KVCache.create, QuantizedKVCache.create, params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg = tiny_test_config()
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
    else:  # the default reaches for the card and fails; nothing moves to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            init_params(cfg)
        with pytest.raises((RuntimeError, AssertionError)):
            KVCache.create(cfg, 1, 8)


def test_init_params_is_seeded_and_shaped():
    cfg = tiny_test_config(num_layers=3)
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert a["layers"]["gate_proj"].shape == (3, 64, 128)
    assert a["lm_head"].shape == (64, 256)
    for name, w in a["layers"].items():
        assert torch.equal(w, b["layers"][name]), name
    logits, _ = forward(a, cfg, torch.from_numpy(prompt(1, 4)))
    assert torch.isfinite(logits).all()
