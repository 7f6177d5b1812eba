"""Speculative decoding (draft / verify): exact greedy outputs, and
rejection sampling for temperature > 0 (every emitted token's marginal is
exactly the target's filtered sampling distribution, for any draft).

Port of flash_attention_cute_tpu/runtime/speculative.py. Each round a small
draft model proposes `gamma` tokens; the target scores all of them in one
extend forward over [cur, d_1 .. d_gamma] (kernel B4 on CUDA), accepts the
longest matching prefix and emits one bonus token of its own, so a round
advances 1 .. gamma + 1 tokens for one target forward. Greedy output is
token-identical to `greedy_generate` for any draft (in exact arithmetic:
on the card the verify and decode kernels round differently, so a near-tie
may flip).

  * Per-row ragged acceptance rides the caches' [B] length tensors:
    rollback is `lengths = L + n + 1`, no data moves.
  * Each round the draft re-extends the 2-token chunk [prev, cur]:
    rewriting an already cached token's K/V is idempotent, and it covers
    the all-accepted case where the draft cache lacks the last draft
    token's K/V. Invariant: draft length = target length - 1.
  * Finished rows keep their lengths. They still ride through the
    forwards (their outputs are discarded); their writes go to positions
    clamped to the cache's room, which only a finished row can exceed, so
    no write leaves the buffer (the JAX package's `dynamic_update_slice`
    clamps instead).

JAX runs the rounds in one `lax.while_loop`. Here they are a Python loop of
eager forwards whose state stays on the device; the one host read a round
is the loop condition (`any(alive)`), which waits for the round's forwards.
Sampling draws are keyed by (seed, output position, stream) with the
port's counter-based generator (runtime/sampling.py), as JAX keys them
with `jax.random`: stream 0 the draft proposals, 1 the acceptance
uniforms, 2 the residual / bonus draw and the first token.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.runtime.generate import prefill
from flash_attention_cute_tpu_torch.runtime.sampling import (
    SamplingParams,
    filter_logits,
    keyed_gumbel,
    keyed_uniform,
    sample_keyed,
)


def _accept_and_emit(tprobs, qprobs, drafts, u, gumbel):
    """Rejection-sampling acceptance (Leviathan / Chen speculative
    sampling): accept draft d_i with probability min(1, p_i(d_i) /
    q_i(d_i)); at the first rejection n, emit a draw from norm(max(p_n -
    q_n, 0)); when all gamma drafts are accepted, the bonus from p_gamma.
    The emitted prefix's marginal is exactly p for any proposal q.

    tprobs [B, gamma+1, V] and qprobs [B, gamma, V] are the filtered
    distributions; drafts [B, gamma] were drawn from qprobs; u [B, gamma]
    uniforms; gumbel [B, V] the noise of the residual draw (its argmax of
    log(dist) + noise is a draw from dist, as `jax.random.categorical`).
    Returns (n [B], e [B, gamma+1]) with e_i = d_{i+1} for i < n and e_n
    the round's final token; entries past n hold the draft padding."""
    b, gamma = drafts.shape
    iota = torch.arange(gamma + 1, device=drafts.device)
    d = drafts.long()[..., None]
    p_d = tprobs[:, :gamma].gather(2, d)[..., 0]
    q_d = qprobs.gather(2, d)[..., 0]
    accept = u * q_d <= p_d
    n = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    # The residual at n == gamma degenerates to the bonus draw from p_gamma.
    qext = torch.cat([qprobs, torch.zeros_like(qprobs[:, :1])], dim=1)
    at_n = n[:, None, None].expand(b, 1, tprobs.shape[-1])
    p_n = tprobs.gather(1, at_n)[:, 0]
    res = (p_n - qext.gather(1, at_n)[:, 0]).clamp(min=0.0)
    rs = res.sum(dim=-1, keepdim=True)
    # rs == 0 is impossible in exact arithmetic after a rejection; under
    # rounding fall back to p_n.
    dist = torch.where(rs > 0, res / rs.clamp(min=1e-30), p_n)
    tok_n = torch.argmax(torch.log(dist) + gumbel, dim=-1)
    padded = torch.cat([drafts.long(), drafts.new_zeros((b, 1), dtype=torch.long)], dim=1)
    e = torch.where(iota[None, :] == n[:, None], tok_n[:, None], padded)
    return n, e


def _greedy_accept(vlog, drafts):
    """Longest prefix of the drafts that the target's argmax agrees with
    (n in [0, gamma]), then the target's bonus at n: (n [B], e [B,
    gamma+1]) as `_accept_and_emit` returns them."""
    b, gamma = drafts.shape
    iota = torch.arange(gamma + 1, device=drafts.device)
    pred = torch.argmax(vlog, dim=-1)  # [B, gamma + 1]
    n = torch.cumprod((pred[:, :gamma] == drafts).long(), dim=1).sum(dim=1)
    bonus = pred.gather(1, n[:, None])
    padded = torch.cat([drafts.long(), drafts.new_zeros((b, 1), dtype=torch.long)], dim=1)
    return n, torch.where(iota[None, :] == n[:, None], bonus, padded)


def _sampled_accept(vlog, qprobs, drafts, sampling, seeds, out_pos):
    """`_accept_and_emit` on the target's filtered distributions, with the
    round's keyed uniforms (stream 1) and residual noise (stream 2)."""
    tprobs = torch.softmax(filter_logits(vlog, sampling), dim=-1)
    u = keyed_uniform(seeds, out_pos, drafts.shape[1], stream=1)
    return _accept_and_emit(tprobs, qprobs, drafts, u,
                            keyed_gumbel(seeds, out_pos, vlog.shape[-1], stream=2))


@dataclasses.dataclass
class _Rounds:
    """Output buffer and per-row progress of a verify loop, on the device.
    Rows that emitted EOS, or reached `max_new_tokens`, are frozen."""

    out: torch.Tensor  # [B, max_new_tokens + gamma + 1] int64
    out_pos: torch.Tensor  # [B] tokens emitted so far
    done: torch.Tensor  # [B] bool: emitted EOS
    accepted: torch.Tensor  # scalar: accepted drafts of live rows
    max_new_tokens: int
    eos_token_id: int | None
    rounds: int = 0

    @classmethod
    def start(cls, first, max_new_tokens, gamma, eos_token_id):
        b = first.shape[0]
        pad = eos_token_id if eos_token_id is not None else 0
        out = torch.full((b, max_new_tokens + gamma + 1), pad, dtype=torch.long,
                         device=first.device)
        out[:, 0] = first
        done = (first == eos_token_id) if eos_token_id is not None else \
            torch.zeros(b, dtype=torch.bool, device=first.device)
        return cls(out, torch.ones_like(first, dtype=torch.long), done,
                   torch.zeros((), dtype=torch.long, device=first.device),
                   max_new_tokens, eos_token_id)

    def alive(self) -> torch.Tensor:
        return ~self.done & (self.out_pos < self.max_new_tokens)

    def go_on(self) -> bool:
        """The loop condition: the round's one read on the host."""
        return self.rounds < self.max_new_tokens and bool(self.alive().any())

    def emit(self, n, e, alive):
        """Truncate the round at EOS, write the emitted tokens of live rows
        at their output positions. Returns (n_eff, count) per row."""
        iota = torch.arange(e.shape[1], device=e.device)
        if self.eos_token_id is not None:
            is_eos = (e == self.eos_token_id) & (iota[None, :] <= n[:, None])
            has_eos = is_eos.any(dim=1)
            n = torch.where(has_eos, torch.argmax(is_eos.long(), dim=1), n)
            self.done = self.done | (alive & has_eos)
        mask = (iota[None, :] <= n[:, None]) & alive[:, None]
        _write(self.out, self.out_pos, e, mask)
        count = n + 1
        self.out_pos = torch.where(alive, self.out_pos + count, self.out_pos)
        self.accepted = self.accepted + torch.where(alive, n, 0).sum()
        self.rounds += 1
        return n, count

    def result(self, return_stats):
        tokens = self.out[:, : self.max_new_tokens].to(torch.int32)
        if return_stats:
            return tokens, {"rounds": self.rounds, "accepted_drafts": int(self.accepted)}
        return tokens


def _write(buf, pos0, e, mask):
    """buf[b, pos0[b] + i] = e[b, i] where mask[b, i], in place. Masked-out
    entries rewrite the value they hold, so an index clamped to the
    buffer's end (only in rows that write nothing) changes nothing."""
    idx = (pos0[:, None] + torch.arange(e.shape[1], device=e.device)).clamp(max=buf.shape[1] - 1)
    buf.scatter_(1, idx, torch.where(mask, e.to(buf.dtype), buf.gather(1, idx)))


def _with_lengths(cache, lengths):
    return dataclasses.replace(cache, lengths=lengths.to(torch.int32))


def _first_token(last_logits, sampling, seeds):
    """Output position 0: the target's argmax, or a draw from stream 2 (the
    "final token of its round" stream; positions >= 1 come from the loop)."""
    return sample_keyed(last_logits, sampling, seeds, torch.zeros_like(seeds), stream=2).long()


def _row_seeds(seed: int, b: int, device) -> torch.Tensor:
    return (seed * 1_000_003 + torch.arange(b, device=device, dtype=torch.long)) & 0x7FFFFFFF


def _check_capacity(capacity: int, s: int, max_new_tokens: int, gamma: int) -> None:
    """A live row's round writes gamma + 1 positions from its length, at
    most s + max_new_tokens - 2."""
    need = s + max_new_tokens + gamma - 1
    if capacity < need:
        raise ValueError(f"cache_capacity {capacity} < {need} (prompt {s} + max_new_tokens "
                         f"{max_new_tokens} + gamma {gamma} - 1)")


def speculative_generate(
    params: dict,
    cfg: ModelConfig,
    draft_params: dict,
    draft_cfg: ModelConfig,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    gamma: int = 4,
    eos_token_id: int | None = None,
    cache_capacity: int | None = None,
    return_stats: bool = False,
    sampling: SamplingParams | None = None,
    seed: int = 0,
):
    """Generation accelerated by a draft model, on the device of `input_ids`.

    Greedy (sampling None or temperature <= 0): [B, max_new_tokens] int32
    ids equal to `greedy_generate(params, cfg, ...)` whatever the draft.
    Sampled: rejection-sampling speculative decoding; every emitted token's
    marginal is the target's own filtered distribution, and a seed replays
    the same tokens. Rows that emit `eos_token_id` are padded with it.
    With `return_stats`, returns (tokens, {"rounds", "accepted_drafts"});
    the acceptance share is accepted_drafts / (rounds * gamma).
    """
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if sampling is not None and sampling.temperature <= 0.0:
        sampling = None
    b, s = input_ids.shape
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens + gamma + 2
    _check_capacity(cache_capacity, s, max_new_tokens, gamma)
    last_logits, t_cache = prefill(params, cfg, input_ids, cache_capacity)
    _, d_cache = prefill(draft_params, draft_cfg, input_ids, cache_capacity)
    d_cache = _with_lengths(d_cache, d_cache.lengths - 1)
    seeds = _row_seeds(seed, b, input_ids.device)
    first = _first_token(last_logits, sampling, seeds)
    if max_new_tokens == 1:
        tokens = first[:, None].to(torch.int32)
        return (tokens, {"rounds": 0, "accepted_drafts": 0}) if return_stats else tokens

    st = _Rounds.start(first, max_new_tokens, gamma, eos_token_id)
    cur, prev = first, input_ids[:, -1].long()
    room = cache_capacity - (gamma + 1)  # only finished rows reach past it
    while st.go_on():
        alive = st.alive()
        t_len, d_len = t_cache.lengths, d_cache.lengths  # d_len = t_len - 1

        # Draft: a 2-token extend [prev, cur], then gamma - 1 decodes.
        dlog, dc = forward(draft_params, draft_cfg, torch.stack([prev, cur], dim=1),
                           cache=_with_lengths(d_cache, d_len.clamp(max=room)), mode="extend")
        lg, toks, fls = dlog[:, 1], [], []
        for i in range(gamma):
            if i:
                lg, dc = forward(draft_params, draft_cfg, toks[-1][:, None], cache=dc,
                                 mode="decode")
                lg = lg[:, 0]
            if sampling is None:
                toks.append(torch.argmax(lg, dim=-1))
            else:
                fls.append(filter_logits(lg, sampling))
                noise = keyed_gumbel(seeds, st.out_pos + i, lg.shape[-1], stream=0)
                toks.append(torch.argmax(fls[-1] + noise, dim=-1))
        drafts = torch.stack(toks, dim=1)  # [B, gamma] = d_1 .. d_gamma

        # Verify: one target extend over [cur, d_1 .. d_gamma].
        vlog, _ = forward(params, cfg, torch.cat([cur[:, None], drafts], dim=1),
                          cache=_with_lengths(t_cache, t_len.clamp(max=room)), mode="extend")
        if sampling is None:
            n, e = _greedy_accept(vlog, drafts)
        else:
            qprobs = torch.softmax(torch.stack(fls, dim=1), dim=-1)
            n, e = _sampled_accept(vlog, qprobs, drafts, sampling, seeds, st.out_pos)
        n, count = st.emit(n, e, alive)

        # Rollback: the target keeps cur .. d_n (n + 1 tokens), the draft one fewer.
        new_len = t_len + count
        t_cache = _with_lengths(t_cache, torch.where(alive, new_len, t_len))
        d_cache = _with_lengths(d_cache, torch.where(alive, new_len - 1, d_len))
        # Next round: cur' = the round's last token, prev' = the one before.
        last = e.gather(1, n[:, None])[:, 0]
        before = torch.where(n > 0, drafts.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0], cur)
        cur = torch.where(alive, last, cur)
        prev = torch.where(alive, before, prev)
    return st.result(return_stats)
