"""The port's speculative and prompt-lookup generation against the JAX
package and the port's own greedy generation, on the CPU.

Greedy speculation must reproduce the target's greedy chain token for token
for any draft (the draft only changes how many rounds it takes), so the
port's tokens are held equal to JAX `speculative_generate` (without
interpret mode) and to the port's `greedy_generate`, and its round and
acceptance counts equal to JAX's, on the tiny fp32 config. Sampled runs
cannot match JAX's bits (`jax.random` is not reproduced): the acceptance
step is held to JAX's on the same distributions, uniforms and residual
noise, its emitted marginal to the target distribution by Monte Carlo, and
whole runs to determinism per seed and to greedy at low temperature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.runtime import prompt_lookup as jax_pl
from flash_attention_cute_tpu.runtime import speculative as jax_spec
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.runtime import sampling
from flash_attention_cute_tpu_torch.runtime import speculative as spec
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
from flash_attention_cute_tpu_torch.runtime.prompt_lookup import (
    ngram_propose,
    prompt_lookup_generate,
)
from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate


def model(layers, key):
    jcfg = jax_tiny(num_layers=layers, dtype=jnp.float32)
    jparams = jax_init(jcfg, jax.random.key(key))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tiny_test_config(num_layers=layers), params


@pytest.fixture(scope="module")
def target():
    return model(2, 0)


@pytest.fixture(scope="module")
def draft():
    # Smaller and independently drawn: near-zero agreement with the target,
    # so acceptance runs the n = 0 bonus-only path.
    return model(1, 99)


def prompt(b=2, s=12, seed=7, high=250):
    return np.random.default_rng(seed).integers(0, high, (b, s)).astype(np.int32)


def run_both(target, draft, ids, n, **kw):
    """(port tokens, port stats, JAX tokens, JAX stats) of one greedy
    speculative call."""
    jcfg, jparams, cfg, params = target
    djcfg, djparams, dcfg, dparams = draft
    got, st = speculative_generate(params, cfg, dparams, dcfg, torch.from_numpy(ids), n,
                                   return_stats=True, **kw)
    want, jst = jax_spec.speculative_generate(jparams, jcfg, djparams, djcfg, jnp.asarray(ids),
                                              n, return_stats=True, **kw)
    return got.numpy(), st, np.asarray(want), jst


def port_greedy(target, ids, n, **kw):
    _, _, cfg, params = target
    return greedy_generate(params, cfg, torch.from_numpy(ids), n, **kw).numpy()


@pytest.mark.parametrize("gamma", [1, 2, 3, 4])
def test_greedy_speculative_random_draft_equals_jax_and_greedy(target, draft, gamma):
    ids = prompt()
    got, st, want, jst = run_both(target, draft, ids, 16, gamma=gamma)
    assert got.dtype == np.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 16))
    assert st == jst


def test_self_draft_accepts_every_draft(target):
    ids = prompt(seed=8)
    got, st, want, jst = run_both(target, target, ids, 16, gamma=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 16))
    assert st == jst
    assert st["accepted_drafts"] == st["rounds"] * 3 * ids.shape[0]
    assert st["rounds"] == 4  # 15 tokens after the first at 4 a round


def test_eos_stops_and_pads(target, draft):
    ids = prompt(b=1, seed=9)
    eos = int(port_greedy(target, ids, 16)[0, 5])
    got, st, want, jst = run_both(target, draft, ids, 16, gamma=3, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 16, eos_token_id=eos))
    assert st == jst
    pos = int(np.argmax(got[0] == eos))
    assert (got[0, pos:] == eos).all()


def test_staggered_eos_freezes_rows(target, draft):
    """Rows reach EOS in different rounds: finished rows keep their lengths
    (their forwards write at clamped positions) while the rest go on."""
    ids = prompt(b=3, seed=24)
    eos = int(port_greedy(target, ids, 20)[0, 7])
    got, st, want, jst = run_both(target, draft, ids, 20, gamma=4, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 20, eos_token_id=eos))
    assert st == jst


def test_max_new_tokens_one(target, draft):
    ids = prompt(b=1, seed=10)
    got, st, want, jst = run_both(target, draft, ids, 1, gamma=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 1))
    assert st == jst == {"rounds": 0, "accepted_drafts": 0}


def test_cache_capacity_too_small_raises(target, draft):
    _, _, cfg, params = target
    _, _, dcfg, dparams = draft
    ids = torch.from_numpy(prompt())
    with pytest.raises(ValueError, match="cache_capacity"):
        speculative_generate(params, cfg, dparams, dcfg, ids, 8, gamma=4, cache_capacity=20)


def test_accept_and_emit_equals_jax_on_the_same_draws():
    """The same tprobs / qprobs / drafts / uniforms, and the residual noise
    JAX's categorical draws from its keys: the accept counts and every
    emitted token are JAX's, so the residual distributions agree."""
    v, gamma, n = 12, 3, 3000
    kp, kq, kd, ku, kr = jax.random.split(jax.random.key(4), 5)
    tprobs = jax.nn.softmax(jax.random.normal(kp, (n, gamma + 1, v)) * 1.5, axis=-1)
    qprobs = jax.nn.softmax(jax.random.normal(kq, (n, gamma, v)) * 1.5, axis=-1)
    drafts = jax.random.categorical(kd, jnp.log(qprobs), axis=-1).astype(jnp.int32)
    u = jax.random.uniform(ku, (n, gamma))
    keys = jax.random.split(kr, n)
    want_n, want_e = jax_spec._accept_and_emit(tprobs, qprobs, drafts, u, keys)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(keys)
    got_n, got_e = spec._accept_and_emit(
        *(torch.from_numpy(np.asarray(x)) for x in (tprobs, qprobs, drafts, u, noise)))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert set(np.asarray(want_n).tolist()) == set(range(gamma + 1))  # every path ran


def test_accept_and_emit_marginal_is_the_target_distribution():
    """The speculative-sampling theorem: for any proposal q, the token
    emitted at a round's first position has marginal exactly p_0 (Monte
    Carlo over keyed draws; 5 sigma at N = 60000 is under 0.012)."""
    v, gamma, n = 8, 2, 60000
    rng = np.random.default_rng(3)
    p = torch.softmax(torch.from_numpy(rng.standard_normal((gamma + 1, v))).float() * 1.5, -1)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((gamma, v))).float() * 1.5, -1)
    rows = torch.arange(n)
    drafts = torch.stack([torch.argmax(torch.log(q[i]) + sampling.keyed_gumbel(
        rows, torch.full((n,), i), v, stream=0), dim=-1) for i in range(gamma)], dim=1)
    u = sampling.keyed_uniform(rows, torch.zeros(n, dtype=torch.long), gamma, stream=1)
    noise = sampling.keyed_gumbel(rows, torch.zeros(n, dtype=torch.long), v, stream=2)
    nacc, e = spec._accept_and_emit(p.expand(n, -1, -1), q.expand(n, -1, -1), drafts, u, noise)
    hist = torch.bincount(e[:, 0], minlength=v).float() / n
    np.testing.assert_allclose(hist.numpy(), p[0].numpy(), atol=0.012)
    assert (nacc == 0).any() and (nacc > 0).any()


def test_keyed_streams_differ_and_stream_zero_is_the_engines_key():
    seeds, pos = torch.tensor([0, 5, 1 << 30]), torch.tensor([0, 3, 100])
    u0 = sampling.keyed_uniform(seeds, pos, 64)
    assert torch.equal(u0, sampling.keyed_uniform(seeds, pos, 64, stream=0))
    for stream in (1, 2):
        us = sampling.keyed_uniform(seeds, pos, 64, stream=stream)
        assert ((us > 0) & (us < 1)).all() and not torch.equal(us, u0)
    assert not torch.equal(sampling.keyed_uniform(seeds, pos, 64, stream=1),
                           sampling.keyed_uniform(seeds, pos, 64, stream=2))


def test_sampled_speculative_is_deterministic_per_seed(target, draft):
    _, _, cfg, params = target
    _, _, dcfg, dparams = draft
    ids = torch.from_numpy(prompt(seed=11))
    sp = sampling.SamplingParams(temperature=0.9, top_k=40)

    def run(seed, **kw):
        return speculative_generate(params, cfg, dparams, dcfg, ids, 12, gamma=3,
                                    sampling=sp, seed=seed, **kw)

    a = run(5)
    assert torch.equal(a, run(5))
    assert not torch.equal(a, run(6))
    # EOS freezes a row: the stream up to EOS is the free-running one.
    eos = int(a[0, 4])
    out = run(5, eos_token_id=eos)[0].tolist()
    i = out.index(eos)
    assert out[: i + 1] == a[0, : i + 1].tolist() and all(t == eos for t in out[i:])


def test_sampled_speculative_at_low_temperature_is_greedy(target, draft):
    _, _, cfg, params = target
    _, _, dcfg, dparams = draft
    ids = prompt(seed=13)
    got = speculative_generate(params, cfg, dparams, dcfg, torch.from_numpy(ids), 12, gamma=3,
                               sampling=sampling.SamplingParams(temperature=1e-4), seed=1)
    np.testing.assert_array_equal(got.numpy(), port_greedy(target, ids, 12))


# ---- prompt lookup ----


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_propose_equals_jax(ngram):
    rng = np.random.default_rng(ngram)
    hist = rng.integers(0, 5, (6, 40)).astype(np.int32)  # a small vocab: many matches
    hlen = np.array([1, 2, 5, 17, 33, 40], np.int32)
    for gamma in (1, 4):
        want = jax_pl.ngram_propose(jnp.asarray(hist), jnp.asarray(hlen), gamma, ngram)
        got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(hlen), gamma, ngram)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def run_lookup(target, ids, n, **kw):
    jcfg, jparams, cfg, params = target
    got, st = prompt_lookup_generate(params, cfg, torch.from_numpy(ids), n, return_stats=True,
                                     **kw)
    want, jst = jax_pl.prompt_lookup_generate(jparams, jcfg, jnp.asarray(ids), n,
                                              return_stats=True, **kw)
    return got.numpy(), st, np.asarray(want), jst


@pytest.mark.parametrize("gamma,ngram", [(1, 1), (3, 2), (4, 3)])
def test_prompt_lookup_equals_jax_and_greedy(target, gamma, ngram):
    ids = prompt(s=14, seed=7, high=64)
    got, st, want, jst = run_lookup(target, ids, 14, gamma=gamma, ngram=ngram)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 14))
    assert st == jst and st["accepted_drafts"] > 0


def test_prompt_lookup_repetitive_prompt(target):
    """A repetitive prompt makes the lookup hit on every round (and this
    random model rejects the proposals): still the greedy chain, with
    JAX's counts."""
    ids = np.tile(prompt(b=1, s=6, seed=9, high=32), (2, 4))  # period 6
    got, st, want, jst = run_lookup(target, ids, 12, gamma=4, ngram=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 12))
    assert st == jst and st["rounds"] >= 1


def test_prompt_lookup_eos(target):
    ids = prompt(b=1, s=8, seed=13, high=64)
    eos = int(port_greedy(target, ids, 10)[0, 3])
    got, st, want, jst = run_lookup(target, ids, 10, gamma=3, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_greedy(target, ids, 10, eos_token_id=eos))


def test_prompt_lookup_sampled(target):
    _, _, cfg, params = target
    ids = prompt(s=10, seed=11, high=64)
    sp = sampling.SamplingParams(temperature=0.9)

    def run(seed, sp=sp):
        return prompt_lookup_generate(params, cfg, torch.from_numpy(ids), 10, gamma=3,
                                      sampling=sp, seed=seed).numpy()

    np.testing.assert_array_equal(run(3), run(3))
    np.testing.assert_array_equal(run(1, sampling.SamplingParams(temperature=1e-4)),
                                  port_greedy(target, ids, 10))
