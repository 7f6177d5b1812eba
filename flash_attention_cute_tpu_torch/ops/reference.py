"""Plain PyTorch reference attention, in fp32 and without tiling.

The numerics oracle of the port and the plain version behind the prefill
kernel (ops/flash_fwd.py). Causal masking is bottom-right aligned:
coordinate (m, n) is allowed iff `n <= m + (kv_len - q_len)`, so with a
longer cache the last query row sees every key. Rows left with no allowed
key (only possible when q_len > kv_len, or through kv_length / window)
produce exact zeros.
"""

from __future__ import annotations

import torch


def bottom_right_causal_mask(
    q_len: int, kv_len: int, device=None, dtype=torch.bool
) -> torch.Tensor:
    """[q_len, kv_len] mask, True where attention is ALLOWED."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return (cols <= rows + (kv_len - q_len)).to(dtype)


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
) -> torch.Tensor:
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

    Returns [B, Hq, Sq, D] in q's dtype.
    """
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
    row_has_any = allowed.any(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1)
    # softmax of an all -inf row is NaN; such rows output exact zeros.
    probs = torch.where(row_has_any, probs, torch.zeros((), device=dev))
    # Masked keys get probability 0, but 0 * NaN is NaN: zero V where no
    # query may read it (an uninitialised cache tail).
    readable = allowed.any(dim=2, keepdim=True).transpose(2, 3)  # [B,1,Skv,1]
    vf = torch.where(readable, vf, torch.zeros((), device=dev))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)
