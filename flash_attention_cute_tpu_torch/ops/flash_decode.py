"""Split-KV single-token decode: CUDA kernels D1 (partials) and D2 (combine)
and their plain versions.

The KV axis of the cache is cut into `num_splits` contiguous chunks of
`ceil(capacity / num_splits)` positions. For each (batch row, kv head,
split), D1 computes the unnormalised output of the G = Hq / Hkv query rows
of the group over the chunk's live keys (positions < length), with the
running max m (base 2: scores carry scale * log2(e)) and sum l. D2 merges
the splits: weights exp2(m_s - max m), splits with m = -inf weigh 0, and a
total l of 0 gives 0. D1 replaces `_flash_decode_kernel` and D2 the XLA
combine of flash_attention_cute_tpu/ops/flash_decode.py.

Each wrapper routes on the device of `q`: CPU -> plain version, CUDA -> the
kernel; what the kernel does not take raises. Cache positions at or past a
row's length are never read by the kernel and are zeroed out of the plain
version's products, so the cache may hold uninitialised memory there.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops import _build

LOG2E = math.log2(math.e)
HEAD_DIMS = (64, 128)
MAX_GROUP = 8

P, I, L, F = _build.P, _build.I, _build.L, _build.F
PARTIALS = _build.Kernel(
    "decode_partials", "flash_decode.cu", "fact_decode_partials",
    [P, P, P, P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, L, L, F, I, P],
)
COMBINE = _build.Kernel(
    "decode_combine", "flash_decode.cu", "fact_decode_combine",
    [P, P, P, P, I, I, I, I, I, I, P],
)


def decode_partials_plain(q, k, v, lengths, sm_scale, num_splits,
                          window=None, logit_softcap=None):
    """Plain version of D1 on one layer's cache.

    q [B, Hq, 1, D], k/v [B, Hkv, C, D], lengths [B] int ->
    (acc [B, Hkv, S, G, D], m [B, Hkv, S, G], l [B, Hkv, S, G]), fp32.
    """
    b, hq, _, d = q.shape
    _, hkv, cap, _ = k.shape
    g = hq // hkv
    chunk = -(-cap // num_splits)
    pad = num_splits * chunk - cap
    dev = q.device

    s = torch.einsum("bhgd,bhcd->bhgc", q.float().reshape(b, hkv, g, d), k.float())
    s = s * sm_scale
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    s = s * LOG2E
    pos = torch.arange(cap, device=dev)
    lens = lengths.to(dev).clamp(0, cap)[:, None]
    live = pos[None, :] < lens  # [B, C]
    if window is not None:
        live &= pos[None, :] >= lens - window
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(b, hkv, g, num_splits, chunk)
    m = s.amax(dim=-1)  # [B, Hkv, G, S]
    p = torch.exp2(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    vf = torch.where(live[:, None, :, None], v.float(), torch.zeros((), device=dev))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad)).reshape(b, hkv, num_splits, chunk, d)
    acc = torch.einsum("bhgsc,bhscd->bhsgd", p, vf)
    return acc, m.transpose(2, 3).contiguous(), l.transpose(2, 3).contiguous()


def decode_combine_plain(acc, m, l, dtype):
    """Plain version of D2: partials -> [B, Hq, 1, D] in `dtype`."""
    b, hkv, _, g, d = acc.shape
    m_max = m.amax(dim=2, keepdim=True)
    w = torch.where(m == float("-inf"), 0.0, torch.exp2(m - m_max))
    l_tot = (w * l).sum(dim=2)  # [B, Hkv, G]
    o = torch.einsum("bhsgd,bhsg->bhgd", acc, w)
    o = torch.where(l_tot[..., None] > 0, o / l_tot[..., None], 0.0)
    return o.reshape(b, hkv * g, 1, d).to(dtype)


def decode_partials(q, k, v, lengths, sm_scale, num_splits):
    """D1 on one layer's cache: the kernel for CUDA tensors, else plain."""
    if q.device.type == "cpu":
        return decode_partials_plain(q, k, v, lengths, sm_scale, num_splits)
    b, hq, sq, d = q.shape
    _, hkv, cap, _ = k.shape
    g = hq // hkv
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"decode kernel takes bf16/f16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if g > MAX_GROUP:
        raise NotImplementedError(f"decode kernel takes Hq/Hkv <= {MAX_GROUP}, got {g}")
    if sq != 1 or hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_tensor(name, t, q.dtype)
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError("lengths must be a contiguous [B] int32 tensor on q's device")
    if not (0 < num_splits <= cap):
        raise ValueError(f"num_splits {num_splits} outside 1..{cap}")

    acc = torch.empty((b, hkv, num_splits, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, num_splits, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        PARTIALS(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, hkv, g, cap, d, num_splits, -(-cap // num_splits),
            q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
            float(sm_scale) * LOG2E, _build.DTYPE_CODES[q.dtype],
        )
    return acc, m, l


def decode_combine(acc, m, l, dtype):
    """D2: the kernel for CUDA tensors, else plain."""
    if acc.device.type == "cpu":
        return decode_combine_plain(acc, m, l, dtype)
    b, hkv, splits, g, d = acc.shape
    if dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"combine kernel writes bf16/f16, got {dtype}")
    for name, t in (("acc", acc), ("m", m), ("l", l)):
        if t.device != acc.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 on {acc.device}")
    if m.shape != (b, hkv, splits, g) or l.shape != m.shape:
        raise ValueError(f"bad partial shapes {tuple(acc.shape)} {tuple(m.shape)} {tuple(l.shape)}")
    out = torch.empty((b, hkv * g, 1, d), dtype=dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        COMBINE(
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
            b, hkv, g, d, splits, _build.DTYPE_CODES[dtype],
        )
    return out


def _layer_cache(k, v, layer):
    if k.ndim == 4:
        if layer is not None:
            raise ValueError("layer is given only with the stacked [L,B,Hkv,C,D] cache")
        return k, v
    if k.ndim != 5 or layer is None:
        raise ValueError("a 5-D cache needs a layer index")
    return k[layer], v[layer]  # views: no copy


def flash_attention_decode_plain(q, k, v, kv_length=None, sm_scale=None, window=None,
                                 logit_softcap=None, num_splits=0, layer=None):
    """Plain version of D1 + D2 on any device (same split arithmetic)."""
    k, v = _layer_cache(k, v, layer)
    b, hq, _, d = q.shape
    cap = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if num_splits <= 0:
        num_splits = dispatch.decode_num_splits(b, k.shape[1], cap)
    if kv_length is None:
        kv_length = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    acc, m, l = decode_partials_plain(
        q, k, v, kv_length, sm_scale, num_splits, window, logit_softcap
    )
    return decode_combine_plain(acc, m, l, q.dtype)


def flash_attention_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_length: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    num_splits: int = 0,
    layer: int | None = None,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly partly filled) cache.

    Args:
      q: [B, Hq, 1, D]
      k, v: one layer's cache [B, Hkv, C, D], or with `layer` the stacked
        cache [L, B, Hkv, C, D] (`k[layer]` is a view, so nothing is copied).
      kv_length: [B] int32 live lengths on q's device; None = full cache.
      num_splits: KV-axis splits; 0 picks `dispatch.decode_num_splits`.
      window, logit_softcap: plain version only (ROADMAP.md B3 follow-up).

    Returns [B, Hq, 1, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_decode_plain(
            q, k, v, kv_length, sm_scale, window, logit_softcap, num_splits, layer
        )
    if window is not None or logit_softcap is not None:
        raise NotImplementedError(
            "window / logit_softcap decode on CUDA is not in the kernel yet "
            "(ROADMAP.md B3 follow-up)"
        )
    k, v = _layer_cache(k, v, layer)
    b, hq, _, d = q.shape
    cap = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if num_splits <= 0:
        num_splits = dispatch.decode_num_splits(b, k.shape[1], cap)
    if kv_length is None:
        kv_length = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    acc, m, l = decode_partials(q, k, v, kv_length, sm_scale, num_splits)
    return decode_combine(acc, m, l, q.dtype)
