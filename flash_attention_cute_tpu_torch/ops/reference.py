"""Plain PyTorch reference attention, in fp32 and without tiling.

The numerics oracle of the port and the plain version behind the prefill
and extend kernels (ops/flash_fwd.py, ops/flash_chunked.py), with the
prefill's lse (`return_lse`), `attention_partials_reference` for the
extend's (o, m, l) partials and `prefill_mask` for the plain backward.
Causal masking is bottom-right aligned: coordinate (m, n) is allowed iff
`n <= m + (kv_len - q_len)`, so with a longer cache the last query row sees
every key. Rows left with no allowed key (only possible when q_len >
kv_len, or through kv_length / window) produce exact zeros.
"""

from __future__ import annotations

import math

import torch


def bottom_right_causal_mask(
    q_len: int, kv_len: int, device=None, dtype=torch.bool
) -> torch.Tensor:
    """[q_len, kv_len] mask, True where attention is ALLOWED."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return (cols <= rows + (kv_len - q_len)).to(dtype)


def prefill_mask(sq: int, skv: int, causal: bool, window: int | None, device=None) -> torch.Tensor:
    """[sq, skv] bool, True where key n is visible from row m in prefill:
    bottom-right causal `n <= m + (skv - sq)` and the window
    `n > m + (skv - sq) - window`."""
    rows = torch.arange(sq, device=device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=device)[None, :]
    allowed = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        allowed &= cols <= rows
    if window is not None:
        allowed &= cols > rows - window
    return allowed


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_scale: float | None = None,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    q_offset: torch.Tensor | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """O = softmax(Q K^T * scale + mask) V in fp32.

    Args:
      q: [B, Hq, Sq, D]
      k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0 (q head h reads kv head
        h // (Hq // Hkv)).
      softmax_scale: defaults to D ** -0.5.
      causal: bottom-right-aligned causal masking.
      kv_length: optional [B] int valid KV lengths; positions >= length are
        masked.
      q_offset: optional [B] int global position of q row 0; with causal,
        causality becomes `col <= q_offset + row`.
      window: optional sliding window W: a query also masks keys more than
        W - 1 positions behind it.
      logit_softcap: optional tanh soft cap applied to the scores before
        the mask.
      return_lse: also return the per-row log-sum-exp of the scores in log2
        units ([B, Hq, Sq] fp32, log2 of sum 2^(scores * log2(e))), +inf on
        a row with no allowed key: the backward's residual, in the
        convention of the prefill kernels.

    Returns [B, Hq, Sq, D] in q's dtype, and the lse with `return_lse`.
    """
    scores, allowed, vf = _masked_scores(q, k, v, softmax_scale, causal, kv_length, q_offset,
                                         window, logit_softcap)
    row_has_any = allowed.any(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1)
    # softmax of an all -inf row is NaN; such rows output exact zeros.
    probs = torch.where(row_has_any, probs, torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores, dim=-1) * math.log2(math.e)
    return out, torch.where(row_has_any[..., 0], lse, math.inf)


def attention_partials_reference(
    q, k, v, softmax_scale=None, causal=False, kv_length=None, q_offset=None, window=None,
    logit_softcap=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unnormalised online-softmax partials of `attention_reference`,
    in the form the JAX chunked kernel returns them (`return_partials`):
    (o_unnorm [B, Hq, Sq, D], m [B, Hq, Sq], l [B, Hq, Sq]), fp32, with the
    scores in log2 units (scale * log2(e) folded in). m is the row's running
    max from the kernel's initial 0, i.e. max(0, largest visible score), so
    a row with no visible key has m = 0, l = 0 and o_unnorm = 0; then
    o = o_unnorm / l and any two partials merge exactly."""
    scores, allowed, vf = _masked_scores(q, k, v, softmax_scale, causal, kv_length, q_offset,
                                         window, logit_softcap)
    s2 = scores * math.log2(math.e)
    m = s2.amax(dim=-1).clamp(min=0.0)  # -inf (no visible key) -> 0
    p = torch.exp2(s2 - m[..., None])  # masked scores are -inf: p = 0
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return o, m, p.sum(dim=-1)


def _masked_scores(q, k, v, softmax_scale, causal, kv_length, q_offset, window, logit_softcap):
    """fp32 scores [B, Hq, Sq, Skv] with masked entries at -inf, the
    [B, 1, Sq, Skv] mask of allowed entries, and V in fp32 with the GQA
    heads repeated and the keys no query may read zeroed."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    dev = q.device

    qf, kf, vf = q.float(), k.float(), v.float()
    if hkv != hq:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)

    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * softmax_scale
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap

    rows = torch.arange(sq, device=dev).view(1, 1, sq, 1)
    cols = torch.arange(skv, device=dev).view(1, 1, 1, skv)
    allowed = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        if q_offset is not None:
            allowed &= cols <= rows + q_offset.view(b, 1, 1, 1)
        else:
            allowed &= bottom_right_causal_mask(sq, skv, device=dev)[None, None]
    if kv_length is not None:
        allowed &= cols < kv_length.view(b, 1, 1, 1)
    if window is not None:
        if q_offset is not None:
            base = q_offset.view(b, 1, 1, 1)
        elif kv_length is not None:
            base = kv_length.view(b, 1, 1, 1) - sq
        else:
            base = skv - sq
        allowed &= cols > rows + base - window

    scores = scores.masked_fill(~allowed, float("-inf"))
    # Masked keys get probability 0, but 0 * NaN is NaN: zero V where no
    # query may read it (an uninitialised cache tail).
    readable = allowed.any(dim=2, keepdim=True).transpose(2, 3)  # [B,1,Skv,1]
    vf = torch.where(readable, vf, torch.zeros((), device=dev))
    return scores, allowed, vf
