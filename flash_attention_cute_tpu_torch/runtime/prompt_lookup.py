"""Prompt-lookup (n-gram) speculative decoding: speculation without a draft
model.

Port of flash_attention_cute_tpu/runtime/prompt_lookup.py. Proposals come
from matching the last `ngram` tokens of each row against the row's own
history (prompt and output) and copying the continuation of the most recent
match; on a miss the round still emits the target's bonus token. The
target verifies the proposals in one extend forward a round (kernel B4 on
CUDA), on the recurrence of runtime/speculative.py, so greedy output is
token-identical to `greedy_generate` and sampled output is distribution-
exact (rejection sampling against a one-hot proposal).

The history is a [B, cap] device buffer and the n-gram match a vectorised
compare over positions; the one host read a round is the loop condition.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.runtime.generate import prefill
from flash_attention_cute_tpu_torch.runtime.sampling import SamplingParams
from flash_attention_cute_tpu_torch.runtime.speculative import (
    _check_capacity,
    _first_token,
    _greedy_accept,
    _Rounds,
    _row_seeds,
    _sampled_accept,
    _with_lengths,
    _write,
)


def ngram_propose(
    hist: torch.Tensor,
    hlen: torch.Tensor,
    gamma: int,
    ngram: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Most-recent n-gram continuation proposals.

    hist [B, cap] holds tokens 0 .. hlen - 1 of each row (hlen [B]). Matches
    the row's last `ngram` tokens at every earlier position and proposes
    the `gamma` tokens that follow the most recent match. Returns (drafts
    [B, gamma] int32, matched [B] bool); a row without a match proposes its
    last token repeated (the verifier rejects wrong proposals for free).
    """
    b, cap = hist.shape
    dev = hist.device
    hlen = hlen.long()[:, None]
    pos = torch.arange(cap, device=dev)[None, :]
    # Candidate match ends j: hist[j - ngram + 1 .. j] equals the suffix,
    # j < hlen - 1 (the suffix's own match is excluded).
    ok = (pos < hlen - 1) & (pos >= ngram - 1)
    for k in range(ngram):
        want = hist.gather(1, (hlen - ngram + k).clamp(min=0))  # [B, 1]
        idx = pos - (ngram - 1) + k
        got = hist.gather(1, idx.clamp(0, cap - 1).expand(b, cap))
        ok &= (got == want) & (idx >= 0)
    matched = ok.any(dim=1)
    j = torch.where(ok, pos, -1).amax(dim=1)  # the most recent match, -1 = none
    start = torch.where(matched, j + 1, 0)
    gidx = (start[:, None] + torch.arange(gamma, device=dev)[None, :]).clamp(0, cap - 1)
    last = hist.gather(1, (hlen - 1).clamp(min=0))
    drafts = torch.where(matched[:, None], hist.gather(1, gidx), last)
    return drafts.to(torch.int32), matched


def prompt_lookup_generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    gamma: int = 4,
    ngram: int = 2,
    eos_token_id: int | None = None,
    cache_capacity: int | None = None,
    return_stats: bool = False,
    sampling: SamplingParams | None = None,
    seed: int = 0,
):
    """Draft-free speculative generation by prompt n-gram lookup, on the
    device of `input_ids`.

    Greedy: [B, max_new_tokens] int32 ids equal to `greedy_generate`.
    Sampled (temperature > 0): rejection sampling against a one-hot
    proposal; every emitted token's marginal is the target's filtered
    distribution. With `return_stats`, returns (tokens, {"rounds",
    "accepted_drafts"}).
    """
    if gamma < 1 or ngram < 1:
        raise ValueError(f"gamma and ngram must be >= 1, got {gamma}, {ngram}")
    if sampling is not None and sampling.temperature <= 0.0:
        sampling = None
    b, s = input_ids.shape
    dev = input_ids.device
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens + gamma + 2
    _check_capacity(cache_capacity, s, max_new_tokens, gamma)
    last_logits, t_cache = prefill(params, cfg, input_ids, cache_capacity)
    seeds = _row_seeds(seed, b, dev)
    first = _first_token(last_logits, sampling, seeds)
    if max_new_tokens == 1:
        tokens = first[:, None].to(torch.int32)
        return (tokens, {"rounds": 0, "accepted_drafts": 0}) if return_stats else tokens

    hist = torch.zeros((b, s + max_new_tokens + gamma + 2), dtype=torch.long, device=dev)
    hist[:, :s] = input_ids
    hist[:, s] = first  # cur, at index hlen - 1
    hlen = torch.full((b,), s + 1, dtype=torch.long, device=dev)

    st = _Rounds.start(first, max_new_tokens, gamma, eos_token_id)
    room = cache_capacity - (gamma + 1)  # only finished rows reach past it
    while st.go_on():
        alive = st.alive()
        t_len = t_cache.lengths  # = hlen - 1: cur is not cached yet
        cur = hist.gather(1, (hlen - 1)[:, None])[:, 0]
        drafts = ngram_propose(hist, hlen, gamma, ngram)[0].long()

        # Verify: one target extend over [cur, d_1 .. d_gamma].
        vlog, _ = forward(params, cfg, torch.cat([cur[:, None], drafts], dim=1),
                          cache=_with_lengths(t_cache, t_len.clamp(max=room)), mode="extend")
        if sampling is None:
            n, e = _greedy_accept(vlog, drafts)
        else:
            # A deterministic proposal is a one-hot q: accept d_i iff
            # u <= p_i(d_i); residual = norm(max(p - onehot(d), 0)).
            qprobs = torch.nn.functional.one_hot(drafts, vlog.shape[-1]).to(vlog.dtype)
            n, e = _sampled_accept(vlog, qprobs, drafts, sampling, seeds, st.out_pos)
        n, count = st.emit(n, e, alive)

        # The history grows by the same emitted tokens.
        mask = (torch.arange(gamma + 1, device=dev)[None, :] <= n[:, None]) & alive[:, None]
        _write(hist, hlen, e, mask)
        hlen = torch.where(alive, hlen + count, hlen)
        t_cache = _with_lengths(t_cache, torch.where(alive, t_len + count, t_len))
    return st.result(return_stats)
