"""Token sampling: greedy, temperature, top-k, top-p, min-p, penalties, and
draws keyed by (seed, output position, stream).

The JAX package keys its sampling randomness by (request seed, output
position, stream) through `jax.random.fold_in`. PyTorch cannot reproduce
`jax.random`'s bits, so the port keeps the keying with its own
counter-based generator (`keyed_uniform`): a replay of the same position
draws the same numbers whatever happened before it (preemption, a
speculative round's rollback). Streams, as in the JAX speculative
decoders: 0 for the engine's draws and draft proposals, 1 for the
acceptance uniforms, 2 for the residual / bonus draw.
"""

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


# ---- draws keyed by (seed, output position, stream) ----

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) on int64 tensors
    holding values below 2**32; multipliers below 2**31 keep every product
    inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def keyed_uniform(seeds: torch.Tensor, positions: torch.Tensor, n: int,
                  stream: int = 0) -> torch.Tensor:
    """[rows, n] uniforms in (0, 1), a pure function of (seed, position,
    stream, column): a counter-based generator, so a replay draws the same
    numbers. Stream 0 is the serving engine's key."""
    key = _mix32(_mix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    if stream:
        key = _mix32(key ^ ((stream * 0x9E3779B9) & _M32))
    col = _mix32(torch.arange(n, device=seeds.device, dtype=torch.int64))
    x = _mix32(_mix32(key[:, None] ^ col[None, :]) ^ 0x5BD1E995)
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))


def keyed_gumbel(seeds, positions, n: int, stream: int = 0) -> torch.Tensor:
    """[rows, n] standard Gumbel noise from `keyed_uniform`: the argmax of
    logits + noise is a draw from softmax(logits)."""
    return -torch.log(-torch.log(keyed_uniform(seeds, positions, n, stream)))


def sample_keyed(logits, sampling, seeds, positions, stream: int = 0) -> torch.Tensor:
    """logits [n, V] fp32 -> token ids [n] int32. Greedy (sampling None or
    temperature <= 0) is an argmax; otherwise a Gumbel-max draw from
    `filter_logits(logits, sampling)` with noise keyed by (seed, position,
    stream)."""
    if sampling is None or sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    dist = filter_logits(logits.float(), sampling)
    gumbel = keyed_gumbel(seeds, positions, logits.shape[-1], stream)
    return torch.argmax(dist + gumbel, dim=-1).to(torch.int32)
