"""The port's paged forward and continuous-batching serving engine against
the JAX package, on the CPU.

Parameters come from the JAX `init_params` (two layers of the tiny config)
and cross through `params_from_jax`, so both sides hold identical fp32
weights. `forward_paged` logits must match the JAX `forward_paged`
(Pallas kernels in interpret mode) to 2e-5; the engine must be
token-identical to the JAX `ServingEngine` and to the port's own
`greedy_generate`, and to itself across preemption, chunked admission and
grouped admission; over int8 pages (`kv_dtype=torch.int8`) to the JAX engine
over int8 pages. Each JAX engine runs once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.paged_forward import forward_paged as jax_forward_paged
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.runtime import (
    ServingEngine,
    engine,
    greedy_generate,
    paged_forward,
)
from flash_attention_cute_tpu_torch.runtime.paged_cache import (
    PagedKVState,
    QuantizedPagedKVState,
    create_paged_state,
    create_quantized_paged_state,
)
from flash_attention_cute_tpu_torch.runtime.paged_forward import forward_paged
from flash_attention_cute_tpu_torch.runtime.sampling import SamplingParams

ATOL = 2e-5
POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny(num_layers=2)
    jparams = jax_init(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(num_layers=2), params


def prompts_of(seed, lengths):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, 256, n).tolist() for rid, n in lengths.items()}


# The request mix of the JAX package's engine test: three prompts through
# two slots, so one request waits for a slot and reuses its pages.
PROMPTS = prompts_of(0, {10: 7, 11: 12, 12: 3})
N_NEW = {10: 5, 11: 4, 12: 6}


def run_engine(params, cfg, prompts, n_new, **kw):
    eng = ServingEngine(params, cfg, **{**POOL, **kw})
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new if isinstance(n_new, int) else n_new[rid])
    return eng.run(), eng


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    jcfg, jparams, _, _ = tiny
    eng = JaxServingEngine(jparams, jcfg, **POOL, interpret=True)
    for rid, p in PROMPTS.items():
        eng.submit(rid, p, N_NEW[rid])
    return eng.run(), eng.stats


@pytest.fixture(scope="module")
def jax_int8_tokens(tiny):
    jcfg, jparams, _, _ = tiny
    eng = JaxServingEngine(jparams, jcfg, **POOL, kv_dtype=jnp.int8, interpret=True)
    for rid, p in PROMPTS.items():
        eng.submit(rid, p, N_NEW[rid])
    return eng.run()


def test_forward_paged_prefill_decode_extend_match_jax(tiny):
    """Two rows through prefill (padded, valid lengths 7 and 5), one decode
    step and a 3-token extend; logits and pools match after each."""
    jcfg, jparams, cfg, params = tiny
    table = np.array([[3, 1, 4, 0], [5, 8, 2, 7]], np.int32)  # page 0 real in row 0
    jstate = jax_cache.create_paged_state(jcfg, 9, 8, 2, 4)
    jstate = dataclasses.replace(jstate, page_table=jnp.asarray(table))
    state = create_paged_state(cfg, 9, 8, 2, 4, device="cpu")
    state.page_table = torch.from_numpy(table)
    rng = np.random.default_rng(3)
    steps = [
        ("prefill", rng.integers(0, 256, (2, 7)).astype(np.int32), np.array([7, 5], np.int32)),
        ("decode", rng.integers(0, 256, (2, 1)).astype(np.int32), None),
        ("extend", rng.integers(0, 256, (2, 3)).astype(np.int32), None),
    ]
    for mode, ids, valid in steps:
        jv = None if valid is None else jnp.asarray(valid)
        want, jstate = jax_forward_paged(jparams, jcfg, jnp.asarray(ids), jstate, mode=mode,
                                         valid_len=jv, interpret=True)
        tv = None if valid is None else torch.from_numpy(valid)
        got, state = forward_paged(params, cfg, torch.from_numpy(ids), state, mode=mode,
                                   valid_len=tv)
        assert got.dtype == torch.float32 and got.shape == (2, ids.shape[1], 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=mode)
        assert state.lengths.tolist() == np.asarray(jstate.lengths).tolist(), mode
        np.testing.assert_allclose(state.k_pages.numpy(), np.asarray(jstate.k_pages),
                                   atol=ATOL, rtol=0, err_msg=mode)
    assert state.lengths.tolist() == [11, 9]


def test_forward_paged_plain_attention_is_the_same_on_the_cpu(tiny, monkeypatch):
    """plain_attention=True is the comparison path on the card: it must
    reach no kernel wrapper (each raises here when called) and give the
    logits of the default route, which a CPU tensor takes through the same
    plain versions."""
    _, _, cfg, params = tiny
    rng = np.random.default_rng(4)
    steps = [("prefill", 6), ("extend", 3), ("decode", 1)]
    steps = [(mode, torch.from_numpy(rng.integers(0, 256, (2, s)))) for mode, s in steps]

    def refuse(*args, **kwargs):
        raise AssertionError("plain_attention reached a kernel wrapper")

    outs = {}
    for plain in (False, True):
        if plain:
            for name in ("flash_attention_forward", "paged_attention_decode",
                         "paged_attention_extend"):
                monkeypatch.setattr(paged_forward, name, refuse)
        st = create_paged_state(cfg, 9, 8, 2, 4, device="cpu")
        st.page_table = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
        outs[plain] = []
        for mode, ids in steps:
            logits, st = forward_paged(params, cfg, ids, st, mode=mode, plain_attention=plain)
            outs[plain].append(logits)
    for mode_step, a, b in zip(steps, outs[False], outs[True]):
        assert torch.equal(a, b), mode_step[0]


def test_forward_paged_quantized_plain_attention_is_the_same_on_the_cpu(tiny, monkeypatch):
    """The quantized route's comparison path reaches none of B7-B9's
    wrappers (each raises here when called) and gives the default route's
    logits and pools."""
    _, _, cfg, params = tiny
    rng = np.random.default_rng(5)
    steps = [("prefill", 6), ("extend", 3), ("decode", 1)]
    steps = [(mode, torch.from_numpy(rng.integers(0, 256, (2, s)))) for mode, s in steps]

    def refuse(*args, **kwargs):
        raise AssertionError("plain_attention reached a kernel wrapper")

    outs, states = {}, {}
    for plain in (False, True):
        if plain:
            for name in ("flash_attention_forward", "paged_attention_decode_quantized",
                         "paged_attention_extend_quantized"):
                monkeypatch.setattr(paged_forward, name, refuse)
        st = create_quantized_paged_state(cfg, 9, 8, 2, 4, dtype=torch.float8_e4m3fn,
                                          device="cpu")
        st.page_table = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
        outs[plain] = []
        for mode, ids in steps:
            logits, st = forward_paged(params, cfg, ids, st, mode=mode, plain_attention=plain)
            outs[plain].append(logits)
        states[plain] = st
    assert isinstance(states[True], QuantizedPagedKVState)
    assert states[True].lengths.tolist() == [10, 10]
    for mode_step, a, b in zip(steps, outs[False], outs[True]):
        assert torch.equal(a, b), mode_step[0]
    assert torch.equal(states[False].k_scales, states[True].k_scales)


def test_engine_token_identical_to_jax_engine_and_greedy_generate(tiny, jax_tokens):
    _, _, cfg, params = tiny
    want, jstats = jax_tokens
    got, eng = run_engine(params, cfg, PROMPTS, N_NEW)
    assert eng.native and not eng.failed
    assert got == want
    for rid, p in PROMPTS.items():
        ref = greedy_generate(params, cfg, torch.tensor([p]), N_NEW[rid])[0].tolist()
        assert got[rid] == ref, rid
    assert set(eng.stats) == set(jstats)
    for key in ("prefills", "preemptions", "tokens_generated", "requests_finished",
                "requests_failed", "softmax_clamps"):
        assert eng.stats[key] == jstats[key], key
    assert eng.state.k_pages.device.type == "cpu"
    assert [m["req_id"] for m in eng.request_metrics] == list(eng._done)
    assert all(m["ttft_s"] is not None and m["e2e_s"] >= m["ttft_s"]
               for m in eng.request_metrics)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4), dict(prefill_chunk=5, decode_chunk=3),
                                dict(prefill_group=4), dict(decode_chunk=1)],
                         ids=["chunk4", "chunk5_decode3", "group4", "decode1"])
def test_engine_admission_modes_give_the_same_tokens(tiny, jax_tokens, kw):
    _, _, cfg, params = tiny
    got, eng = run_engine(params, cfg, PROMPTS, N_NEW, **kw)
    assert got == jax_tokens[0]
    if "prefill_chunk" in kw:
        assert eng.forwards["extend"] > 0 and eng.forwards["prefill"] == 0
    if "prefill_group" in kw:
        assert eng.forwards["prefill"] < len(PROMPTS)


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=4)], ids=["whole", "chunked"])
def test_engine_int8_pages_token_identical_to_jax_engine(tiny, jax_int8_tokens, kw):
    """Whole-prompt admission runs prefill + decode over int8 pages (the
    quantized append, then B8's plain version here); chunked admission the
    quantized extend (B9's plain version)."""
    _, _, cfg, params = tiny
    got, eng = run_engine(params, cfg, PROMPTS, N_NEW, kv_dtype=torch.int8, **kw)
    assert isinstance(eng.state, QuantizedPagedKVState) and eng.state.k_values.dtype == torch.int8
    assert not eng.failed and got == jax_int8_tokens
    if kw:
        assert eng.forwards["extend"] > 0 and eng.forwards["prefill"] == 0


def test_engine_quantized_chunked_admission_matches_whole_prompt(tiny):
    """Chunked admission quantizes each token as whole-prompt admission
    does, so the two generate the same tokens (the JAX engine's test, here
    over e4m3 pages)."""
    _, _, cfg, params = tiny
    prompt = np.random.default_rng(21).integers(0, 256, 21).tolist()
    pool = dict(slots=1, num_pages=9, page_size=8, pages_per_seq=8,
                kv_dtype=torch.float8_e4m3fn)
    whole, _ = run_engine(params, cfg, {0: prompt}, 8, **pool)
    chunked, eng = run_engine(params, cfg, {0: prompt}, 8, prefill_chunk=8, **pool)
    assert not eng.failed and len(chunked[0]) == 8 and chunked == whole
    # A kv_dtype that is not 1 byte wide selects the dense pool, as in JAX.
    dense = ServingEngine(params, cfg, **{**POOL, "kv_dtype": torch.float32})
    assert isinstance(dense.state, PagedKVState)


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=4)], ids=["whole", "chunked"])
def test_engine_preemption_gives_the_same_tokens(tiny, kw):
    """Five usable pages of 8 tokens cannot hold both requests' 17 tokens:
    preemption and recompute must replay exactly what a roomy pool gives."""
    _, _, cfg, params = tiny
    prompts = prompts_of(1, {0: 9, 1: 9})
    tight, eng_tight = run_engine(params, cfg, prompts, 8, num_pages=6, **kw)
    roomy, eng_roomy = run_engine(params, cfg, prompts, 8, **kw)
    assert eng_tight.stats["preemptions"] > 0 and eng_roomy.stats["preemptions"] == 0
    assert tight == roomy and sorted(tight) == [0, 1]


def test_engine_sampling_is_the_same_across_preemption(tiny):
    _, _, cfg, params = tiny
    prompts = prompts_of(4, {0: 9, 1: 9})
    sampling = SamplingParams(temperature=0.8, top_k=16)
    roomy, eng_roomy = run_engine(params, cfg, prompts, 8, sampling=sampling, seed=7)
    tight, eng_tight = run_engine(params, cfg, prompts, 8, num_pages=6, sampling=sampling,
                                  seed=7)
    assert eng_roomy.stats["preemptions"] == 0 < eng_tight.stats["preemptions"]
    assert roomy == tight
    greedy, _ = run_engine(params, cfg, prompts, 8)
    assert roomy != greedy  # the draws are not the argmax
    other, _ = run_engine(params, cfg, prompts, 8, sampling=sampling, seed=8)
    assert other != roomy


def test_engine_unservable_requests_fail_cleanly(tiny):
    _, _, cfg, params = tiny
    # 2 usable pages -> 16 tokens; 8 prompt + 12 new needs 20.
    out, eng = run_engine(params, cfg, {7: list(range(8))}, 12, slots=1, num_pages=3)
    assert 7 not in out and eng.failed == [7]
    # A prompt larger than the whole pool is never admitted.
    out, eng = run_engine(params, cfg, {0: list(range(40))}, 4, slots=1, num_pages=3)
    assert out == {} and eng.failed == [0]
    assert eng.stats["requests_failed"] == 1


def test_engine_eos_stops_early(tiny):
    _, _, cfg, params = tiny
    prompt = [5, 3, 2, 9, 1, 7]
    full = greedy_generate(params, cfg, torch.tensor([prompt]), 8)[0].tolist()
    eos = full[2]
    out, eng = run_engine(params, cfg, {0: prompt}, 8, slots=1, num_pages=17, pages_per_seq=4,
                          eos_token_id=eos)
    assert out[0] == full[: full.index(eos) + 1] and out[0][-1] == eos


# kv_dtype: int8 and e4m3 pages are served; another 1-byte type (e5m2,
# which the JAX engine would quantize to) is refused.
LATER = [("init", name, value) for name, value in (
    ("kv_dtype", torch.float8_e5m2), ("mesh", object()), ("lora_params", {}), ("dfa", {}),
    ("enable_prefix_cache", True), ("host_swap_tokens", 64), ("return_logprobs", True),
    ("collect_clamp_stats", True),
)] + [("submit", name, value) for name, value in (
    ("logit_bias", {3: 1.0}), ("min_new_tokens", 2), ("stop_sequences", [[1, 2]]),
    ("constrain", True), ("adapter", 1), ("repetition_penalty", 1.2),
    ("presence_penalty", 0.5), ("frequency_penalty", 0.5),
)]


@pytest.mark.parametrize("where,name,value", LATER, ids=[f"{w}-{n}" for w, n, _ in LATER])
def test_options_outside_the_slice_raise(tiny, where, name, value):
    _, _, cfg, params = tiny
    if where == "init":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(params, cfg, **POOL, **{name: value})
        return
    eng = ServingEngine(params, cfg, **POOL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(0, [1, 2, 3], 4, **{name: value})
    eng.submit(0, [1, 2, 3], 4, **{name: engine._LATER_SUBMIT[name][0]})  # neutral: accepted


def test_engine_refuses_unknown_options(tiny):
    _, _, cfg, params = tiny
    with pytest.raises(TypeError, match="interpret"):
        ServingEngine(params, cfg, **POOL, interpret=True)


def test_keyed_uniforms_are_a_pure_function_of_seed_and_position():
    seeds = torch.tensor([7, 7, 8], dtype=torch.int64)
    pos = torch.tensor([0, 1, 0], dtype=torch.int64)
    u = engine._uniform(seeds, pos, 1000)
    assert u.shape == (3, 1000) and bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u, engine._uniform(seeds, pos, 1000))
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert abs(u.mean().item() - 0.5) < 0.02
    logits = torch.randn(3, 1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(engine.sample_keyed(logits, None, seeds, pos),
                       logits.argmax(-1).to(torch.int32))


def test_engine_priority_admits_first_and_max_steps_leaves_requests_queued(tiny):
    _, _, cfg, params = tiny
    eng = ServingEngine(params, cfg, **{**POOL, "slots": 1})
    eng.submit(0, [1, 2, 3], 12)
    eng.submit(1, [4, 5, 6], 12, priority=1)
    out = eng.run(max_steps=1)
    assert out == {} and not eng.failed  # unfinished, not unservable
    out = eng.run()
    assert [m["req_id"] for m in eng.request_metrics] == [1, 0] and sorted(out) == [0, 1]
    eng.submit(2, [1], 2)
    with pytest.raises(ValueError, match="already queued"):
        eng.submit(2, [1], 2)
    with pytest.raises(ValueError, match="prompt token"):
        eng.submit(3, [], 2)
