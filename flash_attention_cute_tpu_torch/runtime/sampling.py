"""Token sampling: greedy, temperature, top-k, top-p, min-p, penalties."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled
    min_p: float = 0.0  # 0 => disabled; keep tokens with p >= min_p * p_max


def filter_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature-scale, then mask (-inf) what top-k / top-p / min-p drop.

    `softmax(filter_logits(l))` is exactly the distribution `sample_token`
    draws from."""
    if params.temperature <= 0.0:
        raise ValueError("filter_logits needs temperature > 0")
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    logits = logits / params.temperature

    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)

    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= top_p (the argmax
        # is always kept).
        keep_sorted = cum - probs < params.top_p
        threshold = torch.where(
            keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, neg_inf, logits)

    if params.min_p > 0.0:
        # p_i / p_max >= min_p  <=>  l_i >= l_max + ln(min_p).
        cut = logits.amax(dim=-1, keepdim=True) + math.log(params.min_p)
        logits = torch.where(logits < cut, neg_inf, logits)
    return logits


def apply_penalties(logits, prompt_counts, out_counts, rep, pres, freq) -> torch.Tensor:
    """Repetition (HF: tokens seen in prompt or output get l/rep if l > 0
    else l*rep), presence and frequency (OpenAI: over output tokens only)
    penalties on raw logits. `rep`/`pres`/`freq` broadcast against
    `logits.shape[:-1]`."""
    rep = rep[..., None]
    seen = (prompt_counts + out_counts) > 0
    logits = torch.where(
        seen & (logits > 0), logits / rep, torch.where(seen, logits * rep, logits)
    )
    return logits - freq[..., None] * out_counts - pres[..., None] * (out_counts > 0)


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32. Greedy is an argmax (no
    randomness); temperature sampling draws from `generator`."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature > 0 needs a torch.Generator")
    probs = torch.softmax(filter_logits(logits.float(), params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
