"""Head dims outside {64, 128, 256} in the port against the JAX package, on
the CPU.

The kernels P / B2, D1 + D2, B5, B6 and the paged append take every head
dim that is a multiple of 8 from 8 to 256, each run on the card in the
layout of the next of 64, 128 and 256 (`_build.padded_head_dim`). Here the
plain versions, which those kernels are held to on the card, are held to
the JAX kernels in interpret mode (which pad D to 128 lanes) at D 24, 40
and 96, with a window in one case and a soft cap in another of each kernel,
at atol 1e-5 (fp32 sums in other orders). A tiny 2-layer Llama of head dim
24 (4 / 4 heads) with JAX's weights (`params_from_jax`) gives JAX's greedy
and engine tokens, whole-prompt and chunked. The rule itself is a pure
function of the head dim. The JAX engine runs once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.ops.flash_decode import flash_attention_decode as jax_decode
from flash_attention_cute_tpu.ops.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.ops import _build, flash_decode, flash_fwd
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.runtime import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

ATOL = 1e-5
HQ, HKV = 4, 2
# (head dim, window, soft cap): each kernel at D 24 plain, D 40 with a
# window, D 96 with a cap of 1.0 (it binds: scores here reach about 10).
CASES = [(24, None, None), (40, 20, None), (96, None, 1.0)]
IDS = ["d24", "d40_window", "d96_cap"]


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def t(*arrays):
    """Torch copies (JAX on the CPU may alias a numpy buffer)."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("d, window, cap", CASES, ids=IDS)
def test_prefill_plain_matches_jax_kernel(d, window, cap):
    rng = np.random.default_rng(40 + d)
    q, k, v = normal(rng, 2, HQ, 40, d), normal(rng, 2, HKV, 40, d), normal(rng, 2, HKV, 40, d)
    want = jax_fwd(*j(q, k, v), causal=True, window=window, logit_softcap=cap, interpret=True)
    got = flash_fwd.flash_attention_fwd(*t(q, k, v), causal=True, window=window,
                                        logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d, window, cap", CASES, ids=IDS)
def test_decode_plain_matches_jax_kernel(d, window, cap):
    """D1 + D2 over a cache [B, Hkv, C, D] with ragged lengths (one 0)."""
    rng = np.random.default_rng(50 + d)
    q, k, v = normal(rng, 3, HQ, 1, d), normal(rng, 3, HKV, 96, d), normal(rng, 3, HKV, 96, d)
    lens = np.asarray([96, 41, 0], np.int32)
    want = jax_decode(*j(q, k, v), kv_length=jnp.asarray(lens), window=window,
                      logit_softcap=cap, block_kv=32, interpret=True)
    got = flash_decode.flash_attention_decode(*t(q, k, v), kv_length=torch.from_numpy(lens),
                                              window=window, logit_softcap=cap, num_splits=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


def paged_inputs(seed, d, b, sq, ps, pps):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    q = normal(rng, b, HQ, sq, d)
    kp, vp = normal(rng, HKV, num_pages, ps, d), normal(rng, HKV, num_pages, ps, d)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("d, window, cap", CASES, ids=IDS)
def test_paged_decode_plain_matches_jax_kernel(d, window, cap):
    q, kp, vp, table = paged_inputs(60 + d, d, 3, 1, 16, 4)
    lens = np.asarray([64, 17, 0], np.int32)
    want = jax_pa.paged_attention_decode(*j(q, kp, vp, lens, table), window=window,
                                         logit_softcap=cap, pages_per_compute_block=2,
                                         interpret=True)
    got = pa.paged_attention_decode(*t(q, kp, vp, lens, table), window=window,
                                    logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d, window, cap", CASES, ids=IDS)
def test_paged_extend_plain_matches_jax_kernel(d, window, cap):
    q, kp, vp, table = paged_inputs(70 + d, d, 3, 16, 8, 8)
    off, kvl = np.asarray([0, 40, 10], np.int32), np.asarray([16, 56, 0], np.int32)
    want = jax_pa.paged_attention_extend(*j(q, kp, vp, off, kvl, table), window=window,
                                         logit_softcap=cap, pages_per_compute_block=2,
                                         interpret=True)
    got = pa.paged_attention_extend(*t(q, kp, vp, off, kvl, table), window=window,
                                    logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[2] == 0).all()


# A tiny Llama of head dim 24, multi-head (4 / 4), two layers.
D24 = dict(num_layers=2, head_dim=24, num_q_heads=4, num_kv_heads=4)
POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)
ENGINE_RUNS = {"whole": {}, "chunked": {"prefill_chunk": 8}}


@pytest.fixture(scope="module")
def tiny_d24():
    jcfg = jax_tiny(**D24)
    jparams = jax_init(jcfg, jax.random.key(5))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(**D24), params


def engine_prompts():
    rng = np.random.default_rng(24)
    return {rid: rng.integers(0, 256, n).tolist() for rid, n in ((0, 13), (1, 6))}


@pytest.fixture(scope="module")
def jax_engine_tokens(tiny_d24):
    """The JAX engine's tokens for each run of ENGINE_RUNS, once."""
    jcfg, jparams, _, _ = tiny_d24
    out = {}
    for name, kw in ENGINE_RUNS.items():
        eng = JaxServingEngine(jparams, jcfg, **POOL, **kw, interpret=True)
        for rid, prompt in engine_prompts().items():
            eng.submit(rid, prompt, 4)
        out[name] = eng.run()
    return out


def test_greedy_generate_at_d24_token_identical_to_jax(tiny_d24):
    jcfg, jparams, cfg, params = tiny_d24
    ids = np.random.default_rng(25).integers(0, 256, (2, 11)).astype(np.int32)
    want = np.asarray(jax_greedy(jparams, jcfg, jnp.asarray(ids), 6))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_at_d24_token_identical_to_jax_engine(name, tiny_d24, jax_engine_tokens):
    _, _, cfg, params = tiny_d24
    eng = ServingEngine(params, cfg, **POOL, **ENGINE_RUNS[name])
    for rid, prompt in engine_prompts().items():
        eng.submit(rid, prompt, 4)
    got = eng.run()
    assert not eng.failed and sorted(got) == [0, 1]
    assert got == jax_engine_tokens[name]


@pytest.mark.parametrize("d, layout", [(8, 64), (24, 64), (64, 64), (96, 128), (136, 256),
                                       (256, 256)])
def test_head_dim_rule_takes_multiples_of_8_up_to_256(d, layout):
    """The layout a taken head dim runs in, and the decode tiles and
    extend tiles that follow it (csrc/paged_decode.cuh `kN`, Tiles::kN)."""
    assert _build.padded_head_dim(d) == layout
    assert _build.row_pitch(d) == d  # a multiple of 8: rows need no pitch
    assert dispatch.decode_tile(d) == (64 if layout == 64 else 32)
    assert pa.extend_plan(d, 16) == (64 if layout == 256 else 128, 16)


@pytest.mark.parametrize("d", [100, 264, 0, 4, 250])
def test_head_dim_rule_refuses_the_rest_naming_the_roadmap_item(d):
    """Every d from 1 to 256 runs (d 100, 4 and 250, refused before the
    pitched rows, now take their layout and a 16-byte row pitch); d 264
    runs in the prefill's wide layout of 512 (P / B2 and B12 take d 257 to
    512), while the kernels without that layout still refuse it, as the
    wide layout refuses d 520; d 0 still raises, naming the item of the
    head dims above 256."""
    if 1 <= d <= 256:
        layout = 64 if d <= 64 else 128 if d <= 128 else 256
        assert _build.padded_head_dim(d, "prefill") == layout
        assert _build.row_pitch(d) == -(-d // 8) * 8 and _build.row_pitch(d) * 2 % 16 == 0
        return
    if d == 264:
        assert _build.padded_head_dim(d, "prefill", wide=True) == 512
        assert _build.row_pitch(d) == 264
        for what, kw in (("decode", {}), ("prefill", {"wide": True})):
            with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
                _build.padded_head_dim(d if what == "decode" else d + 256, what, **kw)
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        _build.padded_head_dim(d, "prefill", wide=True)
