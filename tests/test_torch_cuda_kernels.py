"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without an NVIDIA Hopper GPU (the decision
is taken in the `device` fixture). Run them on the card with
`python -m pytest -m cuda tests/test_torch_cuda_kernels.py`.

Shapes are the Llama-3-8B attention widths (Hq 32, Hkv 8, D 128) that
`chip_smoke.py` uses. Tolerances: kernel P and the decode output are bf16
results of fp32 arithmetic on bf16 inputs held against the fp32 plain
version: max |diff| <= 3e-2 (the repository's bf16 figure). D1's partials
are fp32 sums of the same bf16 inputs in another order: rtol 1e-4 with
atol 1e-3. The paged append must write exactly what the plain masked
scatter writes. The quantized kernels (B7, B8, B9: bf16 q over int8 / e4m3
values with f32 scales) are held to their fp32 plain versions at 3e-2 too,
over caches whose scales (and e4m3 values) hold NaN at and past every
length; the quantize-and-append kernel QA must write exactly what the plain
`quantize_kv` + indexed write writes, also at head dim 256. The paged
decodes B5 and B8 (one kernel since their Hopper redesign) are held at page
sizes 8 / 16 / 128, head dims 64 / 128 / 256, GQA groups 1-32, windows,
the soft cap and f16, each call repeated bit for bit. The weight-only
quantized products
B10 (int8) and B11 (int4) take bf16 / f16 activations at unit scale and
weights of std fan_in ** -0.5, and are held to their plain versions over
the same inputs in fp32 at 3e-2 too, at Llama-3-8B projection shapes, a ragged K and the padded
lm_head; at every projection of the int8 and fused int4 Llama-3-8B trees at
decode rows and at T 2048; either side of the decode / prefill crossover;
with split K against one pass over K; and they repeat bit for bit.

Training and varlen: the lse of P and B2 is held to the plain fp32 lse at
1e-3 absolute on finite entries (log2 units; both sum the same fp32
probabilities in another order) with an identical +inf pattern, also at
D 256 and with the soft cap, and at the edges of the kernel's tiles (S 1,
63, 65, 130, rows with no key, GQA groups 1 / 7 / 32, windows 1 / 45 / 400),
where a second call repeats output and lse bit for bit. The
backward kernels B13a / B13b (D 64 / 128, D 256 in its own layout at
Gemma-2-9B's and Gemma-7B's widths, and D 257-512 in the layout of 512 at
DeepSeek-V4-Flash's 64 / 1 heads) take the kernel forward's o and lse and are
held to `flash_attention_bwd_plain` on the same inputs by max |diff| over
max |plain| <= 2e-2: gradients grow with the sequence, and the kernels
round P and dS to bf16 / f16 before their products (one step is 2^-8
relative), as the forward rounds P before PV. A second call repeats them
bit for bit; B13a's split walk is held to one pass over the walk within
2^-7 relative (the same fp32 sums grouped otherwise, each rounded once).
The packed-batch kernel B12 is held to its fp32 plain version at 3e-2.

int8 scores: K8 must write exactly what the plain row quantizer writes
(values and scales). P-i8 / B2-i8 compute the same fp32 scores as their
plain version (the same quantization and exact integer products), so they
are held to it at 3e-2 (the output's bf16 / f16 rounding and P's), the lse
at 1e-3 as P's; to the fp32 oracle of bf16 scores at 5e-2 (the JAX
package's envelope of int8 scores); they must differ from the bf16-score
kernel by more than 1e-4 (they do quantize) and repeat bit for bit.
"""

import dataclasses

import pytest
import torch

from flash_attention_cute_tpu_torch import api
from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params
from flash_attention_cute_tpu_torch.ops import _build, autodiff, flash_bwd, flash_varlen
from flash_attention_cute_tpu_torch.ops import flash_chunked, flash_decode, flash_fwd, paged_attention
from flash_attention_cute_tpu_torch.ops import quantized as quant
from flash_attention_cute_tpu_torch.ops import quantized_matmul as qmm
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
from flash_attention_cute_tpu_torch.runtime import paged_cache

pytestmark = pytest.mark.cuda

BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def pitched(t):
    """`t` copied into rows at `_build.row_pitch` (a view of its head dim),
    as the port's caches and pools lie; `t`'s own layout where the head dim
    needs no pitch."""
    return _build.empty_rows(t.shape, t.dtype, t.device).copy_(t)


PREFILL = {
    # name: (batch, hq, hkv, sq, skv, d, causal, dtype)
    "causal_b2_s1024": (2, 32, 8, 1024, 1024, 128, True, torch.bfloat16),
    "ragged_s1000": (1, 32, 8, 1000, 1000, 128, True, torch.bfloat16),
    "offset_256_1024": (1, 32, 8, 256, 1024, 128, True, torch.bfloat16),
    "zero_rows_1024_256": (1, 32, 8, 1024, 256, 128, True, torch.bfloat16),
    "full_300_1000": (1, 32, 8, 300, 1000, 128, False, torch.bfloat16),
    "f16_d64_mqa": (2, 8, 1, 333, 333, 64, True, torch.float16),
}


@pytest.mark.parametrize("case", list(PREFILL), ids=list(PREFILL))
def test_prefill_kernel_matches_plain(device, case):
    b, hq, hkv, sq, skv, d, causal, dtype = PREFILL[case]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = randn(gen, b, hq, sq, d, dtype=dtype), randn(gen, b, hkv, skv, d, dtype=dtype), \
        randn(gen, b, hkv, skv, d, dtype=dtype)
    before = flash_fwd.PREFILL.launches
    out = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_fwd.PREFILL.launches == before + 1
    ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert out.shape == ref.shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    if sq > skv and causal:
        assert (out[:, :, : sq - skv] == 0).all()


def test_prefill_kernel_takes_transposed_views(device):
    """The model hands in [B, S, H, D] projections viewed as [B, H, S, D]."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = randn(gen, 2, 300, 32, 128).transpose(1, 2)
    k = randn(gen, 2, 300, 8, 128).transpose(1, 2)
    v = randn(gen, 2, 300, 8, 128).transpose(1, 2)
    out = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
    ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def stacked_cache(gen, lengths, layers=4, hkv=8, cap=576, d=128):
    k = randn(gen, layers, len(lengths), hkv, cap, d)
    v = randn(gen, layers, len(lengths), hkv, cap, d)
    for i, n in enumerate(lengths):  # uninitialised tail: NaN must never leak
        k[:, i, :, n:] = float("nan")
        v[:, i, :, n:] = float("nan")
    return k, v


@pytest.mark.parametrize("num_splits", [5, 2])
def test_decode_kernels_match_plain_on_stacked_cache(device, num_splits):
    gen = torch.Generator(device="cuda").manual_seed(2)
    lens = [576, 513, 37, 0]
    kc, vc = stacked_cache(gen, lens)
    q = randn(gen, 4, 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5

    acc, m, l = flash_decode.decode_partials(q, kc[2], vc[2], lengths, scale, num_splits)
    acc_p, m_p, l_p = flash_decode.decode_partials_plain(q, kc[2], vc[2], lengths, scale,
                                                         num_splits)
    torch.testing.assert_close(m, m_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-3)
    out = flash_decode.decode_combine(acc, m, l, torch.bfloat16)
    torch.testing.assert_close(
        out.float(), flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16).float(),
        rtol=0, atol=BF16_TOL,
    )

    before = (flash_decode.PARTIALS.launches, flash_decode.COMBINE.launches)
    out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths,
                                              num_splits=num_splits, layer=2)
    torch.cuda.synchronize()
    assert (flash_decode.PARTIALS.launches, flash_decode.COMBINE.launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_decode.flash_attention_decode_plain(q, kc, vc, kv_length=lengths,
                                                    num_splits=num_splits, layer=2)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    assert (out[3] == 0).all()  # length 0: exact zeros


def test_kernels_refuse_what_they_do_not_take(device):
    # D 100 runs since the pitched rows, D 264 since the wide layout of 512;
    # above 512 is refused.
    for d in (100, 264, 520):
        q = torch.zeros(1, 4, 64, d, dtype=torch.bfloat16, device="cuda")
        if d <= 512:
            before = flash_fwd.PREFILL.launches
            out = flash_fwd.flash_attention_fwd(q, q[:, :2], q[:, :2])
            torch.cuda.synchronize()
            assert flash_fwd.PREFILL.launches == before + 1 and (out == 0).all()
            continue
        with pytest.raises(NotImplementedError, match="head_dim"):
            flash_fwd.flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 64, 64, dtype=torch.float32, device="cuda")
    with pytest.raises(NotImplementedError, match="bf16/f16"):
        flash_fwd.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        flash_decode.flash_attention_decode(q, k, k, kv_length=torch.ones(1, device="cuda"))


def paged_pool(gen, ps, rows, capacity=1024, hkv=8, d=128, lengths=None):
    """One layer's pool [Hkv, P, ps, D] behind a permuted page table (page 0
    in no table); with `lengths`, every position at or past a row's length
    and the whole of page 0 hold NaN."""
    pps = capacity // ps
    num_pages = rows * pps + 1
    kp, vp = randn(gen, hkv, num_pages, ps, d), randn(gen, hkv, num_pages, ps, d)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: rows * pps].view(rows, pps).to(torch.int32).contiguous()
    if lengths is not None:
        pos = torch.arange(pps * ps, device="cuda")
        for b, n in enumerate(lengths):
            dead = pos[pos >= n]
            flat = table[b].long()[dead // ps] * ps + dead % ps
            for pool in (kp, vp):
                pool.view(hkv, num_pages * ps, d)[:, flat] = float("nan")
                pool[:, 0] = float("nan")
    return pitched(kp), pitched(vp), table


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_decode_kernel_matches_plain(device, ps):
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = [0, 1, ps - 1, ps, ps + 1, 1024, 777, 2 * ps + 1]
    kp, vp, table = paged_pool(gen, ps, len(lens), lengths=lens)
    q = randn(gen, len(lens), 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = (paged_attention.PAGED_DECODE.launches, flash_decode.COMBINE.launches)
    out = paged_attention.paged_attention_decode(q, kp, vp, lengths, table)
    torch.cuda.synchronize()
    assert (paged_attention.PAGED_DECODE.launches, flash_decode.COMBINE.launches) == (
        before[0] + 1, before[1] + 1)
    ref = paged_attention.paged_attention_decode_plain(q, kp, vp, lengths, table)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()  # length 0: exact zeros
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


# The paged decodes B5 and B8 since their Hopper redesign (name: page_size,
# head_dim, hq, hkv, capacity, window, soft cap, q's dtype): page sizes 8,
# 16, 24 and 128 (copies of a part of a page, of whole pages, several pages
# a tile, parts of 8 keys of a page that no tile size divides), head dims
# 64, 128 and 256 (and 96), GQA groups 1, 2, 4, 7, 8, 16 and 32 (two
# m-tiles), and above 32 in chunks of at most 32 q rows a block (33: 17 /
# 16; 48: StarCoder's 48 / 1; 64; 71: Falcon-7B's 71 / 1, 24 / 24 / 23),
# windows of 1, 45 and 4096 keys, caps 50 and 1.0, f16.
# Rows of lengths 0, 1, a page edge either side, the full table and 777,
# NaN at and past every length and in page 0, behind a permuted table.
PAGED_DECODE = {
    "ps8_d64_g1": (8, 64, 8, 8, 1024, None, None, torch.bfloat16),
    "ps16_d128_g4": (16, 128, 32, 8, 1024, None, None, torch.bfloat16),
    "ps128_d128_g2_w45": (128, 128, 16, 8, 1024, 45, None, torch.bfloat16),
    "ps16_d256_g2_cap50": (16, 256, 16, 8, 1024, None, 50.0, torch.bfloat16),
    "ps128_d256_g2_cap1_w4096": (128, 256, 16, 8, 5120, 4096, 1.0, torch.bfloat16),
    "ps8_d128_g7_w1": (8, 128, 28, 4, 1024, 1, None, torch.bfloat16),
    "ps16_d64_g8_f16_cap50": (16, 64, 32, 4, 1024, None, 50.0, torch.float16),
    "ps128_d128_g16_cap50_w4096": (128, 128, 32, 2, 5120, 4096, 50.0, torch.bfloat16),
    "ps16_d128_g32_w45": (16, 128, 32, 1, 1024, 45, None, torch.bfloat16),
    "ps8_d256_g32_f16_cap1": (8, 256, 32, 1, 1024, None, 1.0, torch.float16),
    "ps128_d64_g32": (128, 64, 32, 1, 1024, None, None, torch.bfloat16),
    "ps24_d128_g4_w45": (24, 128, 32, 8, 1032, 45, None, torch.bfloat16),
    "ps16_d128_g33_w45": (16, 128, 66, 2, 1024, 45, None, torch.bfloat16),
    "ps128_d128_g48": (128, 128, 48, 1, 2048, None, None, torch.bfloat16),
    "ps8_d256_g64_f16_cap50": (8, 256, 64, 1, 1024, None, 50.0, torch.float16),
    "ps16_d64_g71": (16, 64, 71, 1, 2048, None, None, torch.bfloat16),
    "ps16_d96_g71_cap1_w4096": (16, 96, 142, 2, 5120, 4096, 1.0, torch.bfloat16),
}


def paged_decode_inputs(gen, case, values=None):
    """Case's q, lengths, and NaN-poisoned pools (bf16 / f16 in q's dtype,
    or quantized to `values`) behind a permuted table."""
    ps, d, hq, hkv, cap_len, _, _, dtype = PAGED_DECODE[case]
    lens = [0, 1, ps - 1, ps, ps + 1, cap_len, 777, 2 * ps + 1]
    if values is None:
        kp, vp, table = paged_pool(gen, ps, len(lens), capacity=cap_len, hkv=hkv, d=d,
                                   lengths=lens)
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        kp, vp, table = quant_paged_pool(gen, ps, len(lens), values, lens, capacity=cap_len,
                                         hkv=hkv, d=d)
    q = randn(gen, len(lens), hq, 1, d, dtype=dtype)
    return q, kp, vp, torch.tensor(lens, dtype=torch.int32, device="cuda"), table


@pytest.mark.parametrize("values", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("case", list(PAGED_DECODE), ids=list(PAGED_DECODE))
def test_paged_decode_kernels_geometry(device, case, values):
    """B5 (bf16 / f16 pages) and B8 (int8 / e4m3 pages) against their fp32
    plain versions run on q's fp32 image; a length-0 row of exact zeros
    over NaN tails; a second call bit-identical to the first; one launch
    each of the kernel and of D2 a call."""
    _, _, _, _, _, window, cap, _ = PAGED_DECODE[case]
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, kp, vp, lengths, table = paged_decode_inputs(gen, case, KV_DTYPES.get(values))
    if values == "bf16":
        kernel, fn, plain = (paged_attention.PAGED_DECODE, paged_attention.paged_attention_decode,
                             paged_attention.paged_attention_decode_plain)
    else:
        kernel, fn, plain = (quant.QUANT_PAGED_DECODE, quant.paged_attention_decode_quantized,
                             quant.paged_attention_decode_quantized_plain)
    kw = dict(window=window, logit_softcap=cap)
    before = (kernel.launches, flash_decode.COMBINE.launches)
    out = fn(q, kp, vp, lengths, table, **kw)
    again = fn(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, flash_decode.COMBINE.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, again)
    ref = plain(q.float(), kp, vp, lengths, table, **kw)
    assert out.dtype == q.dtype and torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


# Geometry of the contiguous decodes D1 and B7 since they run B5 / B8's
# kernel (name: head_dim, hq, hkv, capacity, window, soft cap, q's dtype):
# head dims 64, 128 and 256 (and 96), GQA groups 1, 2, 4, 7, 8, 16 and 32
# and above 32 (33, 48, 64, 71, 128: chunks of at most 32 q rows a block),
# capacities that are no multiple of 4 nor of a tile (B7's scale rows start
# off any 16-byte boundary), windows of 1, 45, 100 and 4096 keys, caps 50
# and 1.0, f16. Rows of lengths 0, 1, 37, the capacity, one short of it and
# half of it; NaN at and past every length (B7: its scales and e4m3
# values); the stacked [2, B, Hkv, C, D] cache through `layer`.
CONTIG_DECODE = {
    "d64_g1_c577": (64, 8, 8, 577, None, None, torch.bfloat16),
    "d64_g7_c130_w1": (64, 28, 4, 130, 1, None, torch.bfloat16),
    "d64_g16_c999_cap50": (64, 32, 2, 999, None, 50.0, torch.bfloat16),
    "d128_g2_c1030_w45": (128, 16, 8, 1030, 45, None, torch.bfloat16),
    "d128_g4_c576": (128, 32, 8, 576, None, None, torch.bfloat16),
    "d128_g8_c513_f16_cap50": (128, 32, 4, 513, None, 50.0, torch.float16),
    "d128_g32_c2051_w100_cap1": (128, 32, 1, 2051, 100, 1.0, torch.bfloat16),
    "d256_g2_c4641_cap50_w4096": (256, 16, 8, 4641, 4096, 50.0, torch.bfloat16),
    "d256_g2_c1023_cap1": (256, 16, 8, 1023, None, 1.0, torch.bfloat16),
    "d256_g32_c770_f16": (256, 32, 1, 770, None, None, torch.float16),
    "d128_g33_c1030_w100": (128, 66, 2, 1030, 100, None, torch.bfloat16),
    "d128_g48_c2051": (128, 48, 1, 2051, None, None, torch.bfloat16),
    "d256_g64_c770_cap50": (256, 64, 1, 770, None, 50.0, torch.bfloat16),
    "d64_g71_c2051_f16": (64, 71, 1, 2051, None, None, torch.float16),
    "d96_g128_c577_cap1_w45": (96, 128, 1, 577, 45, 1.0, torch.bfloat16),
}


def contig_decode_inputs(gen, case, values=None):
    """Case's q, lengths and NaN-tailed stacked cache (q's dtype, or
    quantized to `values`)."""
    d, hq, hkv, cap_len, _, _, dtype = CONTIG_DECODE[case]
    lens = [0, 1, 37, cap_len, cap_len - 1, cap_len // 2 + 3]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(cap_len, device="cuda")[None, :] >= lengths[:, None]  # [B, C]
    dead = dead[None, :, None, :].expand(2, -1, hkv, -1)
    caches = []
    for _ in "kv":
        x = randn(gen, 2, len(lens), hkv, cap_len, d, dtype=torch.float32)
        if values is None:
            x = x.to(dtype)
            x[dead] = float("nan")
        else:
            x = quant.quantize_kv(x, values)
            poison(x, dead)
        caches.append(x)
    return randn(gen, len(lens), hq, 1, d, dtype=dtype), *caches, lengths


@pytest.mark.parametrize("values", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("case", list(CONTIG_DECODE), ids=list(CONTIG_DECODE))
def test_contiguous_decode_kernels_geometry(device, case, values):
    """D1 (bf16 / f16 cache) and B7 (int8 / e4m3 cache) + D2 against their
    fp32 plain versions run on q's fp32 image: exact zeros for a length-0
    row over NaN tails, a second call bit-identical to the first, one launch
    each of the kernel and of D2 a call. D1's partials at 7 splits (chunk
    edges inside the kernel's tiles) against the plain partials: fp32 sums
    of the same inputs, P taken in two parts."""
    _, _, _, _, window, cap, _ = CONTIG_DECODE[case]
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, lengths = contig_decode_inputs(gen, case, KV_DTYPES.get(values))
    if values == "bf16":
        kernel, fn, plain = (flash_decode.PARTIALS, flash_decode.flash_attention_decode,
                             flash_decode.flash_attention_decode_plain)
    else:
        kernel, fn, plain = (quant.QUANT_DECODE, quant.flash_attention_decode_quantized,
                             quant.flash_attention_decode_quantized_plain)
    kw = dict(window=window, logit_softcap=cap, layer=1)
    before = (kernel.launches, flash_decode.COMBINE.launches)
    out = fn(q, k, v, lengths, **kw)
    again = fn(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, flash_decode.COMBINE.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, again)
    ref = plain(q.float(), k, v, lengths, **kw)
    assert out.dtype == q.dtype and torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    if values == "bf16":
        scale = q.shape[-1] ** -0.5
        got = flash_decode.decode_partials(q, k[1], v[1], lengths, scale, 7, window, cap)
        want = flash_decode.decode_partials_plain(q, k[1], v[1], lengths, scale, 7, window, cap)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-3)


# Edge cases of the paged extends B6 and B9 (name: page_size, head_dim, hq,
# hkv, S, q_offset of rows 0-2, window, soft cap, q's dtype): page sizes 8,
# 16 and 128, head dims 64, 128 and 256, chunks across the kernels' 128-row
# blocks and 128- / 64-key tiles, offsets off every tile and page boundary,
# windows of 1, 45 and 4096 keys, GQA groups 1, 7, 8, 12, 16 and 71, f16,
# the soft cap.
# Row 3 is inactive (kv_length 0); pools hold NaN at and past every length.
EXTEND_CASES = {
    "ps16_s256": (16, 128, 32, 8, 256, [0, 256, 700], None, None, torch.bfloat16),
    "ps128_s100": (128, 128, 32, 8, 100, [0, 256, 700], None, None, torch.bfloat16),
    "ps8_s63": (8, 128, 32, 8, 63, [5, 130, 601], None, None, torch.bfloat16),
    "ps128_s65_f16": (128, 128, 32, 8, 65, [127, 300, 77], None, None, torch.float16),
    "d64_s130_group1": (16, 64, 8, 8, 130, [0, 61, 599], None, None, torch.bfloat16),
    "d256_s512_cap50": (16, 256, 16, 8, 512, [0, 300, 503], None, 50.0, torch.bfloat16),
    "d256_s1_ps128_cap1": (128, 256, 16, 8, 1, [0, 37, 1000], None, 1.0, torch.bfloat16),
    "s1_group7": (16, 128, 28, 4, 1, [0, 37, 1000], None, None, torch.bfloat16),
    "window1_s130": (16, 128, 32, 8, 130, [0, 200, 700], 1, None, torch.bfloat16),
    "window45_ps8_s65": (8, 128, 32, 8, 65, [10, 90, 900], 45, None, torch.bfloat16),
    "window4096_s512": (16, 128, 32, 8, 512, [3584, 4096, 100], 4096, None, torch.bfloat16),
    "group8_s130_f16": (16, 128, 8, 1, 130, [3, 700, 899], None, None, torch.float16),
    "group12_s130_w45": (16, 128, 96, 8, 130, [0, 256, 700], 45, None, torch.bfloat16),
    "group16_ps128_s256_cap50": (128, 128, 128, 8, 256, [5, 300, 900], None, 50.0,
                                 torch.bfloat16),
    "group71_d64_s65_f16": (16, 64, 71, 1, 65, [0, 130, 600], None, None, torch.float16),
}


def extend_inputs(gen, case, pools):
    """q (the model's transposed view), pools, table, offsets and lengths of
    one EXTEND_CASES case; `pools(ps, d, hkv, lengths)` makes the pools."""
    ps, d, hq, hkv, s, offs, _, _, dtype = EXTEND_CASES[case]
    kvl = [o + s for o in offs] + [0]
    k, v, table = pools(ps, d, hkv, kvl)
    q = randn(gen, 4, s, hq, d, dtype=dtype).transpose(1, 2)
    return (q, k, v, torch.tensor(offs + [0], dtype=torch.int32, device="cuda"),
            torch.tensor(kvl, dtype=torch.int32, device="cuda"), table)


@pytest.mark.parametrize("case", list(EXTEND_CASES))
def test_paged_extend_kernel_matches_plain(device, case):
    """B6 within 3e-2 of its fp32 plain version, one launch a call, the
    inactive row exactly 0, a second call bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    w, cap, dtype = EXTEND_CASES[case][6:]

    def pools(ps, d, hkv, kvl):
        kp, vp, table = paged_pool(gen, ps, 4, capacity=5120, hkv=hkv, d=d, lengths=kvl)
        return kp.to(dtype), vp.to(dtype), table

    args = extend_inputs(gen, case, pools)
    before = paged_attention.PAGED_EXTEND.launches
    out, clamps = paged_attention.paged_attention_extend(*args, window=w, logit_softcap=cap,
                                                         return_clamps=True)
    torch.cuda.synchronize()
    assert paged_attention.PAGED_EXTEND.launches == before + 1 and clamps == 0
    assert torch.equal(paged_attention.paged_attention_extend(*args, window=w,
                                                              logit_softcap=cap), out)
    ref = paged_attention.paged_attention_extend_plain(args[0].float(), *args[1:], window=w,
                                                       logit_softcap=cap)
    assert torch.isfinite(out).all()
    assert (out[3] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("s", [1, 100])
def test_paged_append_kernel_writes_what_plain_writes(device, s):
    gen = torch.Generator(device="cuda").manual_seed(5)
    starts, act = [0, 13, 15, 1024, 37, 32], [1, 1, 1, 1, 0, 1]
    if s > 1:
        starts[2] = 1024 - 40  # crosses the end of the table
    kp, vp, table = paged_pool(gen, 16, len(starts))
    new_k = randn(gen, len(starts), s, 8, 128).transpose(1, 2)
    new_v = randn(gen, len(starts), s, 8, 128).transpose(1, 2)
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    active = torch.tensor(act, dtype=torch.bool, device="cuda")
    ref_k, ref_v = kp.clone(), vp.clone()
    before = paged_cache.APPEND.launches
    paged_cache.paged_append_layer(kp, vp, new_k, new_v, table, lengths, active)
    torch.cuda.synchronize()
    assert paged_cache.APPEND.launches == before + 1
    paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
    assert torch.equal(kp, ref_k) and torch.equal(vp, ref_v)


def test_paged_kernels_refuse_what_they_do_not_take(device):
    """B5 and B6 take a soft cap (held to their plain versions here); they
    refuse a pool of another dtype and lengths that are not int32."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    kp, vp, table = paged_pool(gen, 16, 2, capacity=64, lengths=[7, 9])
    q = randn(gen, 2, 32, 1, 128)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    out = paged_attention.paged_attention_decode(q, kp, vp, lengths, table, logit_softcap=30.0)
    ref = paged_attention.paged_attention_decode_plain(q.float(), kp, vp, lengths, table,
                                                       logit_softcap=30.0)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    with pytest.raises(ValueError, match="bfloat16"):  # the pool is never cast
        paged_attention.paged_attention_decode(q, kp.half(), vp.half(), lengths, table)
    with pytest.raises(ValueError, match="int32"):
        paged_attention.paged_attention_decode(q, kp, vp, lengths.long(), table)
    qe = randn(gen, 2, 32, 4, 128)
    out = paged_attention.paged_attention_extend(qe, kp, vp, lengths, lengths + 4, table,
                                                 logit_softcap=30.0)
    ref = paged_attention.paged_attention_extend_plain(qe.float(), kp, vp, lengths, lengths + 4,
                                                       table, logit_softcap=30.0)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


KV_DTYPES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}


def poison(kv: QuantizedKV, dead):
    """NaN into the scales where `dead` [..., S] is True, and the e4m3 NaN
    byte into the values there (int8 has no NaN)."""
    kv.scales[dead] = float("nan")
    if kv.values.dtype == torch.float8_e4m3fn:
        kv.values.view(torch.uint8)[dead] = 0x7F


@pytest.mark.parametrize("name", list(KV_DTYPES))
def test_quant_decode_kernel_matches_plain_on_stacked_cache(device, name):
    gen = torch.Generator(device="cuda").manual_seed(7)
    lens = [0, 1, 63, 64, 65, 544, 2048]
    k = quant.quantize_kv(randn(gen, 2, len(lens), 8, 2048, 128, dtype=torch.float32),
                          KV_DTYPES[name])
    v = quant.quantize_kv(randn(gen, 2, len(lens), 8, 2048, 128, dtype=torch.float32),
                          KV_DTYPES[name])
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(2048, device="cuda")[None, :] >= lengths[:, None]  # [B, C]
    for kv in (k, v):
        poison(kv, dead[None, :, None, :].expand(2, -1, 8, -1))
    q = randn(gen, len(lens), 32, 1, 128)
    before = (quant.QUANT_DECODE.launches, flash_decode.COMBINE.launches)
    out = quant.flash_attention_decode_quantized(q, k, v, lengths, layer=1)
    torch.cuda.synchronize()
    assert (quant.QUANT_DECODE.launches, flash_decode.COMBINE.launches) == (
        before[0] + 1, before[1] + 1)
    ref = quant.flash_attention_decode_quantized_plain(q, k, v, lengths, layer=1)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def quant_paged_pool(gen, ps, rows, dtype, lengths, capacity=1024, hkv=8, d=128):
    """One layer's quantized pools behind a permuted page table, with NaN
    at and past each row's length and in page 0."""
    pps = capacity // ps
    num_pages = rows * pps + 1
    k = quant.quantize_kv(randn(gen, hkv, num_pages, ps, d, dtype=torch.float32), dtype)
    v = quant.quantize_kv(randn(gen, hkv, num_pages, ps, d, dtype=torch.float32), dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: rows * pps].view(rows, pps).to(torch.int32).contiguous()
    pos = torch.arange(pps * ps, device="cuda")
    dead = torch.zeros(num_pages * ps, dtype=torch.bool, device="cuda")
    dead[:ps] = True
    for b, n in enumerate(lengths):
        p = pos[pos >= n]
        dead[table[b].long()[p // ps] * ps + p % ps] = True
    for kv in (k, v):
        poison(kv, dead.view(1, num_pages, ps).expand(hkv, -1, -1))
    return (*(QuantizedKV(pitched(x.values), x.scales) for x in (k, v)), table)


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("ps", [16, 128])
def test_quant_paged_decode_kernel_matches_plain(device, ps, name):
    gen = torch.Generator(device="cuda").manual_seed(8)
    lens = [0, 1, ps - 1, ps, ps + 1, 1024, 777, 2 * ps + 1]
    k, v, table = quant_paged_pool(gen, ps, len(lens), KV_DTYPES[name], lens)
    q = randn(gen, len(lens), 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = quant.QUANT_PAGED_DECODE.launches
    out = quant.paged_attention_decode_quantized(q, k, v, lengths, table)
    torch.cuda.synchronize()
    assert quant.QUANT_PAGED_DECODE.launches == before + 1
    ref = quant.paged_attention_decode_quantized_plain(q, k, v, lengths, table)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("case", list(EXTEND_CASES))
def test_quant_paged_extend_kernel_matches_plain(device, case, name):
    """B9 over B6's edge cases: within 3e-2 of its fp32 plain version over
    NaN scales (and e4m3 NaN values) at and past every length, one launch a
    call, the inactive row exactly 0, a second call bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    w, cap = EXTEND_CASES[case][6:8]
    args = extend_inputs(gen, case, lambda ps, d, hkv, kvl: quant_paged_pool(
        gen, ps, 4, KV_DTYPES[name], kvl, capacity=5120, hkv=hkv, d=d))
    before = quant.QUANT_PAGED_EXTEND.launches
    out, clamps = quant.paged_attention_extend_quantized(*args, window=w, logit_softcap=cap,
                                                         return_clamps=True)
    torch.cuda.synchronize()
    assert quant.QUANT_PAGED_EXTEND.launches == before + 1 and clamps == 0
    assert torch.equal(quant.paged_attention_extend_quantized(*args, window=w,
                                                              logit_softcap=cap), out)
    ref = quant.paged_attention_extend_quantized_plain(args[0].float(), *args[1:], window=w,
                                                       logit_softcap=cap)
    assert torch.isfinite(out).all() and (out[3] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("cap", [50.0, 1.0])
@pytest.mark.parametrize("name", list(KV_DTYPES))
def test_quant_paged_extend_kernel_takes_the_cap_and_d256(device, name, cap):
    """B9 at Gemma-2-9B's widths (16 / 8 heads, D 256) with its soft cap
    50 and one that binds on every score, held to its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    kvl = [40, 300, 1000, 0]
    k, v, table = quant_paged_pool(gen, 16, 4, KV_DTYPES[name], kvl, d=256)
    q = randn(gen, 4, 40, 16, 256).transpose(1, 2)
    off = torch.tensor([0, 260, 960, 0], dtype=torch.int32, device="cuda")
    lengths = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    out = quant.paged_attention_extend_quantized(q, k, v, off, lengths, table, logit_softcap=cap)
    ref = quant.paged_attention_extend_quantized_plain(q.float(), k, v, off, lengths, table,
                                                       logit_softcap=cap)
    assert torch.isfinite(out).all() and (out[3] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("s", [1, 100])
def test_quant_append_kernel_writes_what_plain_writes(device, s, paged, name):
    gen = torch.Generator(device="cuda").manual_seed(10)
    dtype = KV_DTYPES[name]
    starts = [0, 13, 15, 1024 - 40 if s > 1 else 1024, 37, 32]
    new_k = randn(gen, len(starts), s, 8, 128).transpose(1, 2)
    new_v = randn(gen, len(starts), s, 8, 128).transpose(1, 2)
    if paged:  # row 3 runs past its table, row 4 is inactive
        k, v, table = quant_paged_pool(gen, 16, len(starts), dtype, [1024] * len(starts))
        active = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.bool, device="cuda")
    else:
        starts[3] = 1024 - s
        cache = [quant.quantize_kv(randn(gen, len(starts), 8, 1024, 128), dtype) for _ in "kv"]
        k, v = cache
        table = active = None
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (k, v)]
    before = quant.QUANT_APPEND.launches
    quant.quantize_append(new_k, new_v, k, v, lengths, table, active)
    torch.cuda.synchronize()
    assert quant.QUANT_APPEND.launches == before + 1
    quant.quantize_append_plain(new_k, new_v, *ref, lengths, table, active)
    for got, want in zip((k, v), ref):  # bit for bit (page 0's scales are NaN)
        assert torch.equal(got.values.view(torch.uint8), want.values.view(torch.uint8))
        assert torch.equal(got.scales.view(torch.int32), want.scales.view(torch.int32))


def test_quantized_kernels_refuse_what_they_do_not_take(device):
    """Every quantized kernel refuses values other than int8 / e4m3 and
    scales other than f32; B7 and B8 take a group above 32 (33 here, two
    chunks: held to their plain versions). B7, B8 and QA take the cap and
    D 256 (test_contiguous_decode_kernels_geometry,
    test_paged_decode_kernels_geometry,
    test_quant_append_kernel_writes_what_plain_writes_at_d256)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    k, v, table = quant_paged_pool(gen, 16, 2, torch.int8, [64, 64], capacity=64)
    q = randn(gen, 2, 32, 1, 128)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    half = QuantizedKV(k.values.half(), k.scales)
    with pytest.raises(NotImplementedError, match="int8 / float8_e4m3fn"):
        quant.paged_attention_decode_quantized(q, half, half, lengths, table)
    with pytest.raises(ValueError, match="float32"):
        quant.paged_attention_decode_quantized(q, QuantizedKV(k.values, k.scales.half()), v,
                                               lengths, table)
    q33 = randn(gen, 2, 8 * 33, 1, 128)
    out = quant.paged_attention_decode_quantized(q33, k, v, lengths, table)
    ref = quant.paged_attention_decode_quantized_plain(q33.float(), k, v, lengths, table)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    cache = quant.quantize_kv(randn(gen, 2, 8, 64, 128), torch.int8)
    out = quant.flash_attention_decode_quantized(q33, cache, cache, lengths)
    ref = quant.flash_attention_decode_quantized_plain(q33.float(), cache, cache, lengths)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    with pytest.raises(ValueError, match="float32"):
        quant.quantize_append(randn(gen, 2, 8, 1, 128), randn(gen, 2, 8, 1, 128),
                              QuantizedKV(cache.values, cache.scales.double()), cache, lengths)


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_quant_append_kernel_writes_what_plain_writes_at_d256(device, paged, name):
    """QA at Gemma-2-9B's head dim: a 100-token chunk (one inactive row,
    one across the end of the table) bit-identical to the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    starts = [0, 13, 1024 - 40, 37]
    new_k = randn(gen, len(starts), 100, 8, 256).transpose(1, 2)
    new_v = randn(gen, len(starts), 100, 8, 256).transpose(1, 2)
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    if paged:
        k, v, table = quant_paged_pool(gen, 16, len(starts), KV_DTYPES[name], [1024] * 4, d=256)
        active = torch.tensor([1, 1, 1, 0], dtype=torch.bool, device="cuda")
    else:
        k, v = (quant.quantize_kv(randn(gen, len(starts), 8, 1124, 256), KV_DTYPES[name])
                for _ in "kv")
        table = active = None
    ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (k, v)]
    before = quant.QUANT_APPEND.launches
    quant.quantize_append(new_k, new_v, k, v, lengths, table, active)
    torch.cuda.synchronize()
    assert quant.QUANT_APPEND.launches == before + 1
    quant.quantize_append_plain(new_k, new_v, *ref, lengths, table, active)
    for got, want in zip((k, v), ref):
        assert torch.equal(got.values.view(torch.uint8), want.values.view(torch.uint8))
        assert torch.equal(got.scales.view(torch.int32), want.scales.view(torch.int32))


QMM_CASES = {
    # name: (rows T, K, N); Llama-3-8B projections, the padded lm_head
    # (N 128256 -> 129024), a ragged K, a K_pad of 256 (int4: 2 groups in
    # one pack block) and several 512-row pack blocks with a ragged tail.
    "decode_t1_q": (1, 4096, 4096),
    "decode_t4_gate": (4, 4096, 14336),
    "decode_t8_qkv": (8, 4096, 6144),
    "t37_down": (37, 14336, 4096),
    "prefill_t2048_kv": (2048, 4096, 1024),
    "t4_lm_head": (4, 4096, 128256),
    "ragged_t5_k300": (5, 300, 520),
    "kpad256_t3": (3, 200, 130),
    "blocks_t33_k1152": (33, 1152, 384),
}


def qmm_inputs(gen, t, k, n, bits, dtype=torch.bfloat16):
    x = randn(gen, t, k, dtype=dtype)
    w = randn(gen, k, n, dtype=torch.float32) * k ** -0.5
    return x, (qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4)(w)


@pytest.mark.parametrize("case", list(QMM_CASES), ids=list(QMM_CASES))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_kernel_matches_plain(device, bits, case):
    t, k, n = QMM_CASES[case]
    x, w = qmm_inputs(torch.Generator(device="cuda").manual_seed(12), t, k, n, bits)
    kern = qmm.QMM8 if bits == 8 else qmm.QMM4
    before = kern.launches
    out = qmm.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert out.shape == (t, n) and out.dtype == torch.bfloat16
    ref = qmm.quantized_matmul_plain(x.float(), w)  # fp32: one rounding, the kernel's
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


# Every projection (K, N) of the Llama-3-8B trees that B10 / B11 serve: the
# unfused int8 tree and the fused int4 tree, lm_head included; each at its
# decode rows (the greedy batch 4, a serving round of 8) and at T 2048.
PROJECTIONS = {
    8: {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
        "down": (14336, 4096), "lm_head": (4096, 128256)},
    4: {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096), "lm_head": (4096, 128256)},
}
DECODE_T = {8: 4, 4: 8}
PROJECTION_CASES = [(bits, name, t) for bits, shapes in PROJECTIONS.items() for name in shapes
                    for t in (DECODE_T[bits], 2048)]


def check_qmm(x, w, out, kern=None, before=None):
    ref = qmm.quantized_matmul_plain(x.float(), w)  # fp32: one rounding, the kernel's
    torch.cuda.synchronize()
    if kern is not None:
        assert kern.launches == before + 1
    assert out.shape == ref.shape and out.dtype == x.dtype
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("bits,name,t", PROJECTION_CASES,
                         ids=[f"int{b}_{n}_t{t}" for b, n, t in PROJECTION_CASES])
def test_quantized_matmul_every_llama_projection(device, bits, name, t):
    k, n = PROJECTIONS[bits][name]
    x, w = qmm_inputs(torch.Generator(device="cuda").manual_seed(16), t, k, n, bits)
    kern = qmm.QMM8 if bits == 8 else qmm.QMM4
    before = kern.launches
    check_qmm(x, w, qmm.quantized_matmul(x, w), kern, before)


@pytest.mark.parametrize("t", [16, 17, 20, 63, 64, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_either_side_of_the_crossover(device, bits, t):
    """Rows either side of DECODE_MAX_T (16 / 17), a speculative verify
    (20 = 4 x 5), 63 / 64 and a prefill chunk: the plan's route, and each
    design forced, against the plain version."""
    x, w = qmm_inputs(torch.Generator(device="cuda").manual_seed(17), t, 4096, 4096, bits)
    plan = qmm.qmm_plan(t, 4096, 4096, 4096, 4096, bits == 4, True)
    assert plan.route == ("decode" if t <= qmm.DECODE_MAX_T else "prefill")
    for route in qmm.ROUTES:
        check_qmm(x, w, qmm.quantized_matmul(x, w, route=route))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_t2048_unaligned_rows(device, bits, dtype):
    """x rows of 301 elements (K 300): neither base nor stride 16-byte
    aligned, so TMA cannot take them and the plan sends T 2048 to the
    decode design; f16 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = randn(gen, 2048, 301, dtype=dtype)[:, :300]
    w = randn(gen, 300, 520, dtype=torch.float32) * 300 ** -0.5
    w = (qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4)(w)
    k_pad, n_pad = w.values.shape[0] * (2 if bits == 4 else 1), w.values.shape[1]
    assert qmm.qmm_plan(2048, 300, 520, k_pad, n_pad, bits == 4, False).route == "decode"
    check_qmm(x, w, qmm.quantized_matmul(x, w))
    xa = x.contiguous()[:, :296]  # rows of 592 bytes: not 16-byte aligned either
    check_qmm(xa, w, qmm.quantized_matmul(xa, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_repeats_bit_for_bit(device, bits, dtype):
    """Fixed summation orders: the split-K partials combined in split order,
    the decode warps' sums in warp order, wgmma chains in K order."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    for t, k, n in ((4, 4096, 1024), (8, 14336, 4096), (64, 4096, 4096), (300, 4096, 1024)):
        x, w = qmm_inputs(gen, t, k, n, bits, dtype)
        first = qmm.quantized_matmul(x, w)
        for _ in range(3):
            assert torch.equal(first, qmm.quantized_matmul(x, w))


@pytest.mark.parametrize("t", [4, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_split_k_agrees_with_one_pass(device, bits, t):
    """The plan splits K here (decode at N 4096, prefill at T 64); one pass
    over the whole of K, and other split counts, agree within BF16_TOL and
    each with the plain version."""
    x, w = qmm_inputs(torch.Generator(device="cuda").manual_seed(20), t, 4096, 4096, bits)
    plan = qmm.qmm_plan(t, 4096, 4096, 4096, 4096, bits == 4, True)
    assert plan.splits > 1
    split = qmm.quantized_matmul(x, w)
    one = qmm.quantized_matmul(x, w, splits=1)
    check_qmm(x, w, split)
    check_qmm(x, w, one)
    assert (split.float() - one.float()).abs().max().item() <= BF16_TOL
    units = plan.tiles // plan.unit
    check_qmm(x, w, qmm.quantized_matmul(x, w, splits=units))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_f16_strided_rows_and_stacked_layers(device, bits):
    gen = torch.Generator(device="cuda").manual_seed(13)
    # x rows of 301 elements: not 16-byte aligned, so the kernel loads them
    # element by element; a [2, 3, K] batch; layer 1 of a stacked weight.
    x = randn(gen, 2, 3, 301, dtype=torch.float16)[..., :300]
    w = randn(gen, 2, 300, 520, dtype=torch.float32) * 300 ** -0.5
    w = (qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4)(w)
    out = qmm.quantized_matmul(x, w[1])
    ref = qmm.quantized_matmul_plain(x.float(), w[1])
    assert out.shape == (2, 3, 520) and out.dtype == torch.float16
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def test_quantized_matmul_refuses_what_it_does_not_take(device):
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, w = qmm_inputs(gen, 4, 256, 128, 8)
    with pytest.raises(NotImplementedError, match="bf16 / f16"):
        qmm.quantized_matmul(x.float(), w)
    stacked = qmm.quantize_weight(randn(gen, 2, 256, 128, dtype=torch.float32))
    with pytest.raises(ValueError, match="one layer"):
        qmm.quantized_matmul(x, stacked)
    with pytest.raises(ValueError, match="scales"):
        qmm.quantized_matmul(x, qmm.QuantizedWeight(w.values, w.scales.half(), 256, 128))
    # A leaf carried from a JAX tree with impl="xla" still runs B10 on the
    # card: the port routes on the device only.
    before = qmm.QMM8.launches
    xla = qmm.quantized_matmul(x, dataclasses.replace(w, impl="xla"))
    assert qmm.QMM8.launches == before + 1
    assert torch.equal(xla, qmm.quantized_matmul(x, w))


@pytest.mark.parametrize("shape", [(300, 520), (3, 384, 200)], ids=["2d", "stacked"])
@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quantization_on_the_card_is_bit_identical_to_cpu(device, bits, shape):
    """The CPU result is bit-identical to the JAX package's (the CPU tests);
    on the card a division by a Python scalar would be a reciprocal multiply,
    one ulp off in some scales. Both forms: a 2-D weight and a stacked one."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    w = randn(gen, *shape, dtype=torch.float32)
    w[..., ::7] = 0.0  # all-zero columns take unit scales
    quantize = qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4
    on_card, on_cpu = quantize(w), quantize(w.cpu())
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.values.cpu(), on_cpu.values)
    assert torch.equal(on_card.scales.cpu().view(torch.int32), on_cpu.scales.view(torch.int32))


CHUNKED = {
    # name: (hq, hkv, s, capacity, q_offset, kv_length, d, causal, dtype);
    # kv_length None = q_offset + s.
    "verify_s5": (32, 8, 5, 640, [0, 130, 511, 600], None, 128, True, torch.bfloat16),
    "chunk_s256": (32, 8, 256, 1100, [0, 77, 300, 768], None, 128, True, torch.bfloat16),
    "inactive_row": (32, 8, 64, 256, [10, 0, 100], [74, 0, 164], 128, True, torch.bfloat16),
    "noncausal": (32, 8, 100, 512, [0, 50, 300], [100, 200, 450], 128, False, torch.bfloat16),
    "f16_d64": (8, 2, 70, 333, [0, 33, 263], None, 64, True, torch.float16),
}


def chunked_inputs(gen, hq, hkv, s, cap, offs, kvl, d, dtype):
    """The chunk's queries as the model's transposed view, and caches
    holding NaN at and past every row's kv_length (uninitialised tails)."""
    kvl = [o + s for o in offs] if kvl is None else kvl
    q = randn(gen, len(offs), s, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(gen, len(offs), cap, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, len(offs), cap, hkv, d, dtype=dtype).transpose(1, 2)
    for i, n in enumerate(kvl):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    rows = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (offs, kvl))
    return q, k, v, *rows


@pytest.mark.parametrize("case", list(CHUNKED), ids=list(CHUNKED))
def test_chunked_extend_kernel_matches_plain(device, case):
    hq, hkv, s, cap, offs, kvl, d, causal, dtype = CHUNKED[case]
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap, offs, kvl, d, dtype)
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, causal=causal)
    torch.cuda.synchronize()
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q, k, v, off, lens, causal=causal)
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert (out[i] == 0).all()


def partials_err(got, want) -> float:
    """B4's (o, m, l) partials against the plain ones: the largest of
    |o - o'| and |l - l'| over max(l', 1) (o and l grow with the visible
    keys; over l they are errors of the normalised output) and |m - m'|."""
    (o, m, l), (o_p, m_p, l_p) = got, want
    scale = l_p.clamp(min=1.0)
    return max(((o - o_p).abs() / scale[..., None]).max().item(),
               ((l - l_p).abs() / scale).max().item(), (m - m_p).abs().max().item())


def test_chunked_extend_refuses_what_it_does_not_take(device):
    """The (o, m, l) partials, refused before ring attention came (A12),
    launch B4's partials mode: held to the plain partials. The soft cap,
    which the kernel takes since its Hopper redesign, launches it."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, off, lens = chunked_inputs(gen, 32, 8, 5, 64, [0, 3], None, 128, torch.bfloat16)
    before = flash_chunked.PARTIALS.launches
    parts = flash_chunked.flash_attention_chunked(q, k, v, off, lens, return_partials=True)
    assert flash_chunked.PARTIALS.launches == before + 1
    plain = flash_chunked.flash_attention_chunked_plain(q, k, v, off, lens, return_partials=True)
    assert partials_err(parts, plain) <= BF16_TOL
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, logit_softcap=30.0)
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens,
                                                      logit_softcap=30.0)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    # D 100, refused before the pitched rows, runs (a view of d columns at a
    # row stride of 128); D 264, refused before the wide layout of 512,
    # runs in it; a head dim above 512 is refused.
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q[..., :100], k[..., :100], v[..., :100], off,
                                                lens)
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q[..., :100].float(), k[..., :100],
                                                      v[..., :100], off, lens)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    wide = randn(gen, *q.shape[:3], 264)
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(wide, wide[:, :8], wide[:, :8], off, lens)
    torch.cuda.synchronize()
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(wide.float(), wide[:, :8], wide[:, :8],
                                                      off, lens)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    wide = torch.zeros(*q.shape[:3], 520, dtype=q.dtype, device=q.device)
    before = flash_chunked.CHUNKED.launches
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash_chunked.flash_attention_chunked(wide, wide[:, :8], wide[:, :8], off, lens)
    assert flash_chunked.CHUNKED.launches == before
    with pytest.raises(ValueError, match="q_offset"):
        flash_chunked.flash_attention_chunked(q, k, v, off.cpu(), lens)


def test_api_and_model_extend_launch_the_chunked_kernel(device):
    """`flash_attn_func` with kv_length / q_offset and S > 1, and the model's
    extend forward, run B4 (one launch per layer), never a decode kernel."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, off, lens = chunked_inputs(gen, 32, 8, 5, 64, [0, 3], None, 128, torch.bfloat16)
    before = flash_chunked.CHUNKED.launches
    out = api.flash_attn_func(q, k, v, causal=True, kv_length=lens, q_offset=off)
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q, k, v, off, lens)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL

    cfg = tiny_test_config(num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=64,
                           dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, device="cuda")
    cache = KVCache.create(cfg, 2, 32)
    _, cache = forward(params, cfg, ids[:, :7], cache=cache)
    before = (flash_chunked.CHUNKED.launches, flash_decode.PARTIALS.launches)
    got, cache = forward(params, cfg, ids[:, 7:], cache=cache, mode="extend")
    torch.cuda.synchronize()
    assert flash_chunked.CHUNKED.launches == before[0] + cfg.num_layers
    assert flash_decode.PARTIALS.launches == before[1]
    assert cache.lengths.tolist() == [12, 12]
    want, _ = forward(params, cfg, ids, cache=KVCache.create(cfg, 2, 32))
    assert (got - want[:, 7:]).abs().max().item() <= 0.1


# ---- sliding windows: B2, and the windows of D1, B4, B5-B9 ----
# One key, an edge inside a 64-key tile (and a page or split), and one at
# least every length (it never binds: P's and the unwindowed geometry).
# The plain versions run on q in fp32 and return fp32: a window of one key
# makes the output a single V row, whose magnitude reaches 4-8, where one
# bf16 step is 0.03125; a bf16 plain result would add a second rounding.
WINDOWS = [1, 100, 4096]

WINDOWED_PREFILL = {
    # name: (batch, hq, hkv, sq, skv, d, causal, dtype)
    "mistral_s1536": (1, 32, 8, 1536, 1536, 128, True, torch.bfloat16),
    "qwen2_group7_s1000": (2, 28, 4, 1000, 1000, 128, True, torch.bfloat16),
    "offset_256_1024": (1, 32, 8, 256, 1024, 128, True, torch.bfloat16),
    "noncausal_700": (1, 32, 8, 700, 700, 128, False, torch.bfloat16),
    "f16_d64": (2, 8, 1, 333, 333, 64, True, torch.float16),
}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("case", list(WINDOWED_PREFILL), ids=list(WINDOWED_PREFILL))
def test_windowed_prefill_kernel_matches_plain(device, case, window):
    """B2 where the window binds (W < Skv), P where it cannot."""
    b, hq, hkv, sq, skv, d, causal, dtype = WINDOWED_PREFILL[case]
    gen = torch.Generator(device="cuda").manual_seed(20)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)  # the model's view
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    before = (flash_fwd.WINDOWED_PREFILL.launches, flash_fwd.PREFILL.launches)
    out = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    binds = window < skv
    assert (flash_fwd.WINDOWED_PREFILL.launches, flash_fwd.PREFILL.launches) == (
        before[0] + binds, before[1] + (not binds))
    ref = flash_fwd.flash_attention_fwd_plain(q.float(), k, v, causal=causal, window=window)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("hq,hkv", [(32, 8), (28, 4)], ids=["group4", "group7"])
def test_windowed_decode_kernels_match_plain(device, hq, hkv, window):
    """D1's partials (splits wholly below the window dead) and D1 + D2."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    lens = [576, 513, 100, 37, 1, 0]
    kc, vc = stacked_cache(gen, lens, hkv=hkv)
    q = randn(gen, len(lens), hq, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5
    acc, m, l = flash_decode.decode_partials(q, kc[1], vc[1], lengths, scale, 5, window)
    acc_p, m_p, l_p = flash_decode.decode_partials_plain(q, kc[1], vc[1], lengths, scale, 5,
                                                         window)
    torch.testing.assert_close(m, m_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-3)
    before = flash_decode.PARTIALS.launches
    out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths, window=window,
                                              layer=1)
    torch.cuda.synchronize()
    assert flash_decode.PARTIALS.launches == before + 1
    ref = flash_decode.flash_attention_decode_plain(q.float(), kc, vc, kv_length=lengths,
                                                    window=window, layer=1)
    assert torch.isfinite(out).all() and (out[5] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    if window >= max(lens):  # a window at least the length is no window
        assert torch.equal(out, flash_decode.flash_attention_decode(q, kc, vc, lengths, layer=1))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("case", ["verify_s5", "chunk_s256", "inactive_row", "noncausal"])
def test_windowed_chunked_extend_kernel_matches_plain(device, case, window):
    hq, hkv, s, cap, offs, kvl, d, causal, dtype = CHUNKED[case]
    gen = torch.Generator(device="cuda").manual_seed(22)
    q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap, offs, kvl, d, dtype)
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens, causal=causal,
                                                      window=window)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ps", [16, 128])
def test_windowed_paged_kernels_match_plain(device, ps, window):
    """B5 (+ D2) and B6 over NaN-poisoned pools."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    lens = [0, 1, ps - 1, ps + 1, 100, 1024, 777, 2 * ps + 1]
    kp, vp, table = paged_pool(gen, ps, len(lens), lengths=lens)
    q = randn(gen, len(lens), 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_attention.paged_attention_decode(q, kp, vp, lengths, table, window=window)
    ref = paged_attention.paged_attention_decode_plain(q.float(), kp, vp, lengths, table,
                                                       window=window)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL

    offs, kvl = [0, 256, 700, 0], [256, 512, 956, 0]
    kp, vp, table = paged_pool(gen, ps, len(offs), lengths=kvl)
    q = randn(gen, len(offs), 256, 32, 128).transpose(1, 2)
    off_t, kvl_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (offs, kvl))
    before = paged_attention.PAGED_EXTEND.launches
    out = paged_attention.paged_attention_extend(q, kp, vp, off_t, kvl_t, table, window=window)
    torch.cuda.synchronize()
    assert paged_attention.PAGED_EXTEND.launches == before + 1
    ref = paged_attention.paged_attention_extend_plain(q.float(), kp, vp, off_t, kvl_t, table,
                                                       window=window)
    assert torch.isfinite(out).all() and (out[3] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", list(KV_DTYPES))
def test_windowed_quant_kernels_match_plain(device, name, window):
    """B7 (+ D2) over the stacked cache, B8 (+ D2) and B9 over pools, the
    scales (and e4m3 values) NaN at and past every length."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    dtype = KV_DTYPES[name]
    lens = [0, 1, 63, 100, 544, 2048]
    k, v = (quant.quantize_kv(randn(gen, 2, len(lens), 8, 2048, 128, dtype=torch.float32), dtype)
            for _ in "kv")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(2048, device="cuda")[None, :] >= lengths[:, None]
    for kv in (k, v):
        poison(kv, dead[None, :, None, :].expand(2, -1, 8, -1))
    q = randn(gen, len(lens), 32, 1, 128)
    out = quant.flash_attention_decode_quantized(q, k, v, lengths, window=window, layer=1)
    ref = quant.flash_attention_decode_quantized_plain(q.float(), k, v, lengths, window=window,
                                                       layer=1)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    del k, v

    lens = [0, 1, 15, 17, 100, 1024, 777]
    k, v, table = quant_paged_pool(gen, 16, len(lens), dtype, lens)
    q = randn(gen, len(lens), 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = quant.paged_attention_decode_quantized(q, k, v, lengths, table, window=window)
    ref = quant.paged_attention_decode_quantized_plain(q.float(), k, v, lengths, table,
                                                       window=window)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL

    offs, kvl = [0, 256, 700, 0], [100, 356, 800, 0]
    k, v, table = quant_paged_pool(gen, 16, len(offs), dtype, kvl)
    q = randn(gen, len(offs), 100, 32, 128).transpose(1, 2)
    off_t, kvl_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (offs, kvl))
    before = quant.QUANT_PAGED_EXTEND.launches
    out = quant.paged_attention_extend_quantized(q, k, v, off_t, kvl_t, table, window=window)
    torch.cuda.synchronize()
    assert quant.QUANT_PAGED_EXTEND.launches == before + 1
    ref = quant.paged_attention_extend_quantized_plain(q.float(), k, v, off_t, kvl_t, table,
                                                       window=window)
    assert torch.isfinite(out).all() and (out[3] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def test_windowed_model_forwards_launch_the_windowed_kernels(device):
    """A Mistral-style model (window 48 on every layer) prefills 100 tokens
    through B2, decodes through D1 + D2 and extends through B4, each launch
    windowed, and agrees with its plain_attention route."""
    cfg = tiny_test_config(num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=64,
                           sliding_window=48, use_sliding_window=True, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(25)
    ids = torch.randint(0, cfg.vocab_size, (2, 106), generator=gen, device="cuda")
    logits = {}
    for plain in (False, True):
        cache = KVCache.create(cfg, 2, 128)
        before = (flash_fwd.WINDOWED_PREFILL.launches, flash_fwd.PREFILL.launches,
                  flash_decode.PARTIALS.launches, flash_chunked.CHUNKED.launches)
        outs = []
        for lo, hi, mode in ((0, 100, "prefill"), (100, 101, "decode"), (101, 106, "extend")):
            out, cache = forward(params, cfg, ids[:, lo:hi], cache=cache, mode=mode,
                                 plain_attention=plain)
            outs.append(out)
        torch.cuda.synchronize()
        after = (flash_fwd.WINDOWED_PREFILL.launches, flash_fwd.PREFILL.launches,
                 flash_decode.PARTIALS.launches, flash_chunked.CHUNKED.launches)
        want = (0, 0, 0, 0) if plain else (2, 0, 2, 2)  # B2, P, D1, B4: layers x forwards
        assert tuple(a - b for a, b in zip(after, before)) == want
        logits[plain] = torch.cat(outs, dim=1)
    assert (logits[False] - logits[True]).abs().max().item() <= 0.1


# ---- training: the lse of P / B2, B13a / B13b, the autograd route; B12 ----
LSE_TOL = 1e-3
GRAD_REL_TOL = 2e-2

BACKWARD = {
    # name: (batch, hq, hkv, sq, skv, d, causal, window, dtype)
    "causal_b2_s1024": (2, 32, 8, 1024, 1024, 128, True, None, torch.bfloat16),
    "noncausal_700": (1, 32, 8, 700, 700, 128, False, None, torch.bfloat16),
    "window_100_s1536": (1, 32, 8, 1536, 1536, 128, True, 100, torch.bfloat16),
    "offset_256_1024": (1, 32, 8, 256, 1024, 128, True, None, torch.bfloat16),
    "zero_rows_1024_256": (1, 32, 8, 1024, 256, 128, True, None, torch.bfloat16),
    "ragged_s1000": (1, 32, 8, 1000, 1000, 128, True, None, torch.bfloat16),
    "qwen2_group7": (1, 28, 4, 512, 512, 128, True, None, torch.bfloat16),
    "f16_d64_mqa": (2, 8, 1, 333, 333, 64, True, None, torch.float16),
    # tiles of 128 keys and 64 rows cut short or ragged; the split walk
    "short_s130": (1, 32, 8, 130, 130, 128, True, None, torch.bfloat16),
    "sq64_skv1000": (1, 32, 8, 64, 1000, 128, True, None, torch.bfloat16),
    "sq1000_skv64_zero_rows": (1, 32, 8, 1000, 64, 128, True, None, torch.bfloat16),
    "mqa_group32": (1, 32, 1, 512, 512, 128, True, None, torch.bfloat16),
    "window_48_ragged_d64": (1, 8, 2, 300, 300, 64, True, 48, torch.bfloat16),
    # D 256 (its own layout: 64-key / 64-row blocks), chip_smoke.py's cases
    "gemma2_d256_s4608": (1, 16, 8, 4608, 4608, 256, True, None, torch.bfloat16),
    "gemma2_d256_window4096_s4608": (1, 16, 8, 4608, 4608, 256, True, 4096, torch.bfloat16),
    "gemma7b_mha_d256_s2048": (1, 16, 16, 2048, 2048, 256, True, None, torch.bfloat16),
    "d256_ragged_s1000": (1, 16, 8, 1000, 1000, 256, True, None, torch.bfloat16),
    "d256_offset_256_1024": (1, 16, 8, 256, 1024, 256, True, None, torch.bfloat16),
    "d256_zero_rows_1024_256": (1, 16, 8, 1024, 256, 256, True, None, torch.bfloat16),
    "d256_mqa_group32": (1, 32, 1, 1024, 1024, 256, True, None, torch.bfloat16),
    "d256_f16_s1024": (1, 16, 8, 1024, 1024, 256, True, None, torch.float16),
    "d256_window_48_s300": (1, 4, 2, 300, 300, 256, True, 48, torch.bfloat16),
    "d256_noncausal_700": (1, 16, 8, 700, 700, 256, False, None, torch.bfloat16),
    # D 257-512 (the layout of 512: B13a two blocks a 64-key block over
    # 32-row q tiles, B13b 16-key tiles): DeepSeek-V4-Flash's 64 / 1 heads
    # with and without its window of 128, rows of no key, d 264 and 320 in
    # the padded instantiation, d 260 at a pitch of 264
    "d512_v4_s2048": (1, 64, 1, 2048, 2048, 512, True, None, torch.bfloat16),
    "d512_v4_window128_s2048": (1, 64, 1, 2048, 2048, 512, True, 128, torch.bfloat16),
    "d512_f16_zero_rows_600_200": (1, 8, 2, 600, 200, 512, True, None, torch.float16),
    "d512_noncausal_300": (1, 8, 8, 300, 300, 512, False, None, torch.bfloat16),
    "d264_ragged_s517": (1, 16, 4, 517, 517, 264, True, None, torch.bfloat16),
    "d320_window_48_s300": (1, 4, 2, 300, 300, 320, True, 48, torch.bfloat16),
    "d260_offset_256_700": (1, 8, 1, 256, 700, 260, True, None, torch.bfloat16),
}
SPLIT_REL_TOL = 2 ** -7


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-6)).item()


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("case", ["causal_b2_s1024", "zero_rows_1024_256", "f16_d64_mqa"])
def test_prefill_lse_matches_plain(device, case, window):
    b, hq, hkv, sq, skv, d, causal, _, dtype = BACKWARD[case]
    gen = torch.Generator(device="cuda").manual_seed(30)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                             return_lse=True)
    assert torch.equal(out, flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window))
    _, ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert (lse[fin] - ref[fin]).abs().max().item() <= LSE_TOL
    if sq > skv:
        assert torch.isinf(lse[:, :, : sq - skv]).all()


@pytest.mark.parametrize("case", list(BACKWARD), ids=list(BACKWARD))
def test_backward_kernels_match_plain(device, case):
    b, hq, hkv, sq, skv, d, causal, window, dtype = BACKWARD[case]
    gen = torch.Generator(device="cuda").manual_seed(31)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)  # the model's views
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    do = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)  # a non-contiguous cotangent
    o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                           return_lse=True)
    before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
    got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_bwd.DKV.launches, flash_bwd.DQ.launches) == (before[0] + 1, before[1] + 1)
    want = flash_bwd.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do, lse,
                                               causal=causal, window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape and torch.isfinite(a).all(), name
        assert rel_err(a, w) <= GRAD_REL_TOL, (name, rel_err(a, w))
    if sq > skv and causal:
        assert (got[0][:, :, : sq - skv] == 0).all()  # rows with no key


@pytest.mark.parametrize("case", list(BACKWARD), ids=list(BACKWARD))
def test_backward_kernels_repeat_bit_for_bit(device, case):
    """No atomics: a second call, with the same split plan, gives the same
    bits (dK and dV sum the group and the splits in a fixed order)."""
    b, hq, hkv, sq, skv, d, causal, window, dtype = BACKWARD[case]
    gen = torch.Generator(device="cuda").manual_seed(35)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    do = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                           return_lse=True)
    first = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    second = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("case", [c for c, x in BACKWARD.items()
                                  if flash_bwd.dkv_splits(x[0], x[2], x[1] // x[2], x[3], x[4],
                                                          x[5]) > 1])
def test_backward_split_walk_matches_one_pass(device, case):
    """Where `dkv_splits` cuts B13a's walk, its dK / dV are held to one pass
    over the walk (`launch(..., splits=1)`) within SPLIT_REL_TOL: the same
    fp32 sums grouped otherwise, each rounded once."""
    b, hq, hkv, sq, skv, d, causal, window, dtype = BACKWARD[case]
    gen = torch.Generator(device="cuda").manual_seed(38)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    do = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                           return_lse=True)
    _, dk, dv = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    one = tuple(_build.empty_rows(x.shape, x.dtype, x.device) for x in (dk, dv))  # at the pitch
    before = flash_bwd.DKV.launches
    flash_bwd.launch(flash_bwd.DKV, q, k, v, do, lse, (do.float() * o.float()).sum(-1), *one,
                     d ** -0.5, causal, window or 0, splits=1)
    torch.cuda.synchronize()
    assert flash_bwd.DKV.launches == before + 1
    assert rel_err(dk, one[0]) <= SPLIT_REL_TOL and rel_err(dv, one[1]) <= SPLIT_REL_TOL


@pytest.mark.parametrize("window", [None, 48])
def test_autodiff_grads_match_reference_autograd(device, window):
    gen = torch.Generator(device="cuda").manual_seed(32)
    q, k, v = (randn(gen, 2, h, 300, 64).requires_grad_() for h in (8, 2, 2))
    do = randn(gen, 2, 8, 300, 64)
    before = (flash_fwd.PREFILL.launches + flash_fwd.WINDOWED_PREFILL.launches,
              flash_bwd.DKV.launches, flash_bwd.DQ.launches)
    out = autodiff.flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    after = (flash_fwd.PREFILL.launches + flash_fwd.WINDOWED_PREFILL.launches,
             flash_bwd.DKV.launches, flash_bwd.DQ.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = flash_fwd.flash_attention_fwd_plain(*leaves, causal=True, window=window)
    want = torch.autograd.grad(ref, leaves, do.float())
    for a, w in zip(got, want):
        assert rel_err(a, w) <= GRAD_REL_TOL


def test_model_backward_launches_the_training_kernels(device):
    """loss.backward() through `forward` runs P with its lse and B13a / B13b
    once per layer; under no_grad the same forward launches P alone."""
    cfg = tiny_test_config(num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=64,
                           dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    for w in params["layers"].values():
        w.requires_grad_()
    ids = torch.randint(0, cfg.vocab_size, (2, 130), generator=torch.Generator(
        device="cuda").manual_seed(33), device="cuda")
    counters = (flash_fwd.PREFILL, flash_bwd.DKV, flash_bwd.DQ)
    before = [c.launches for c in counters]
    logits, _ = forward(params, cfg, ids)
    torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten()).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    assert all(torch.isfinite(w.grad).all() for w in params["layers"].values())
    before = [c.launches for c in counters]
    with torch.no_grad():
        forward(params, cfg, ids)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 0, 0]


VARLEN = {
    # name: (q lengths, kv lengths (None: q's), causal, window)
    "equal_causal": ([100, 37, 256, 1, 190], None, True, None),
    "equal_full": ([100, 37, 256, 1], None, False, None),
    "cross_bottom_right": ([64, 200, 32, 16], [128, 100, 32, 400], True, None),
    "window_64": ([300, 80, 700], None, True, 64),
    "ragged_total": ([1000, 33], None, True, None),
}


@pytest.mark.parametrize("case", list(VARLEN), ids=list(VARLEN))
def test_varlen_kernel_matches_plain(device, case):
    lens_q, lens_kv, causal, window = VARLEN[case]
    lens_kv = lens_kv or lens_q
    gen = torch.Generator(device="cuda").manual_seed(34)
    q = randn(gen, sum(lens_q), 32, 128)
    k, v = randn(gen, sum(lens_kv), 8, 128), randn(gen, sum(lens_kv), 8, 128)

    def cu(lens):
        return torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)

    before = flash_varlen.VARLEN.launches
    out = flash_varlen.flash_attention_varlen(q, k, v, cu(lens_q), cu(lens_kv), causal=causal,
                                              window=window)
    torch.cuda.synchronize()
    assert flash_varlen.VARLEN.launches == before + 1
    ref = flash_varlen.flash_attention_varlen(q.cpu().float(), k.cpu().float(), v.cpu().float(),
                                              cu(lens_q).cpu(), cu(lens_kv).cpu(), causal=causal,
                                              window=window)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out.float().cpu() - ref).abs().max().item() <= BF16_TOL
    if case == "cross_bottom_right":  # q longer than kv: the first 100 rows of seq 1 are 0
        assert (out[64:164] == 0).all()


def test_training_and_varlen_kernels_refuse_what_they_do_not_take(device):
    """The backward and B12 refuse a head dim above their wide layouts (D
    520, ROADMAP.md A14) before any launch; B12 launches at D 264, in the
    wide layout of 512. B13a / B13b launch at D 256, at D 96 (in D 128's
    layout), at D 100 (rows of 104, refused so before the pitched rows) and
    at D 264 (refused so before the layout of 512), within GRAD_REL_TOL of
    the plain backward; B12 takes the soft cap, D 256 and D 96: each call
    launches it."""
    gen = torch.Generator(device="cuda").manual_seed(35)
    q264, q520 = randn(gen, 1, 4, 64, 264), randn(gen, 1, 4, 64, 520)
    cu = torch.tensor([0, 64], dtype=torch.int32, device="cuda")
    counted = (flash_bwd.DKV, flash_bwd.DQ, flash_varlen.VARLEN)
    before = [c.launches for c in counted]
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        flash_bwd.flash_attention_bwd(q520, q520[:, :2], q520[:, :2], q520, q520,
                                      torch.zeros(1, 4, 64, device="cuda"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        flash_varlen.flash_attention_varlen(q520[0].transpose(0, 1), q520[0, :2].transpose(0, 1),
                                            q520[0, :2].transpose(0, 1), cu)
    assert [c.launches for c in counted] == before
    args = (q264[0].transpose(0, 1), q264[0, :2].transpose(0, 1), q264[0, :2].transpose(0, 1))
    out = flash_varlen.flash_attention_varlen(*args, cu)
    torch.cuda.synchronize()
    assert [c.launches for c in counted] == [*before[:2], before[2] + 1]
    ref = flash_varlen.flash_attention_varlen(*(x.cpu().float() for x in args), cu.cpu())
    assert (out.float().cpu() - ref).abs().max().item() <= BF16_TOL
    for d in (256, 96, 100, 264):
        q = randn(gen, 1, 4, 64, d)
        k, v, do = randn(gen, 1, 2, 64, d), randn(gen, 1, 2, 64, d), randn(gen, 1, 4, 64, d)
        o, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True)
        before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
        got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        assert (flash_bwd.DKV.launches, flash_bwd.DQ.launches) == (before[0] + 1, before[1] + 1)
        want = flash_bwd.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do, lse)
        assert all(a.shape == w.shape and rel_err(a, w) <= GRAD_REL_TOL
                   for a, w in zip(got, want)), d
    qv = randn(gen, 64, 4, 128)
    q96 = randn(gen, 64, 4, 96)
    for args, kw in (((qv, qv[:, :2], qv[:, :2]), {"logit_softcap": 30.0}),
                     ((q[0].transpose(0, 1), q[0, :2].transpose(0, 1),
                       q[0, :2].transpose(0, 1)), {}),
                     ((q96, q96[:, :2], q96[:, :2]), {"causal": True})):
        before = flash_varlen.VARLEN.launches
        out = flash_varlen.flash_attention_varlen(*args, cu, **kw)
        assert flash_varlen.VARLEN.launches == before + 1
        ref = flash_varlen.flash_attention_varlen(*(x.cpu().float() for x in args), cu.cpu(),
                                                  **kw)
        assert out.shape == ref.shape
        assert (out.float().cpu() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("d,cap", [(256, None), (128, 30.0)], ids=["d256", "cap30"])
def test_prefill_lse_takes_d256_and_the_cap(device, d, cap):
    """The forward writes its lse at D 256 and with the soft cap (the JAX
    forward returns both): output within BF16_TOL and lse within LSE_TOL of
    the fp32 plain version, at the shapes the kernel refused before."""
    gen = torch.Generator(device="cuda").manual_seed(36)
    q, k, v = randn(gen, 1, 4, 64, d), randn(gen, 1, 2, 64, d), randn(gen, 1, 2, 64, d)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, logit_softcap=cap, return_lse=True)
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                       logit_softcap=cap, return_lse=True)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_autodiff_refuses_d256_before_the_forward_launches(device):
    """Under autograd a head dim no backward layout takes (D 520, ROADMAP.md
    A14) raises before P runs, not after a forward whose gradient cannot
    come; the API refuses D 264 by its own shape check, as JAX's does. D 96
    (in D 128's layout, refused so until the backward took the head-dim
    rule), D 100 (rows of 104, refused so until the pitched rows) and D 256
    (refused so until the backward kernels took it) run P, then B13a and
    B13b, and their gradients match autograd through the fp32 reference
    within GRAD_REL_TOL; D 264 and 512 (refused so until the layout of 512)
    alike through `ops.autodiff.flash_attention`."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    q = randn(gen, 1, 4, 64, 520).requires_grad_()
    k, v = randn(gen, 1, 2, 64, 520), randn(gen, 1, 2, 64, 520)
    before = (flash_fwd.PREFILL.launches, flash_fwd.WINDOWED_PREFILL.launches)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
        autodiff.flash_attention(q, k, v, causal=True)
    q264 = randn(gen, 1, 4, 64, 264).requires_grad_()
    with pytest.raises(ValueError, match="> 256 unsupported"):  # the API's own shape check
        api.flash_attn_func(q264, q264[:, :2], q264[:, :2], causal=True)
    assert (flash_fwd.PREFILL.launches, flash_fwd.WINDOWED_PREFILL.launches) == before
    for hq, hkv, s, d in ((32, 32, 300, 96), (4, 2, 300, 256), (32, 8, 300, 100),
                          (8, 1, 300, 264), (8, 2, 300, 512)):
        q = randn(gen, 1, hq, s, d).requires_grad_()
        k, v = randn(gen, 1, hkv, s, d).requires_grad_(), randn(gen, 1, hkv, s, d).requires_grad_()
        do = randn(gen, 1, hq, s, d)
        counters = (flash_fwd.PREFILL, flash_bwd.DKV, flash_bwd.DQ)
        before = [c.launches for c in counters]
        attend = api.flash_attn_func if d <= 256 else autodiff.flash_attention
        got = torch.autograd.grad(attend(q, k, v, causal=True), (q, k, v), do)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(flash_fwd.flash_attention_fwd_plain(*leaves, causal=True),
                                   leaves, do.float())
        assert all(rel_err(a, w) <= GRAD_REL_TOL for a, w in zip(got, want)), d


# P / B2 at the edges of their tiles (128 q rows a block, 128 keys a tile at
# D 64 / 128, 64 at D 256), with the lse, on the model's transposed views,
# each call repeated: output and lse bit-identical, and the call without the
# lse writes the same output.
PREFILL_EDGES = {
    # name: (batch, hq, hkv, sq, skv, d, causal, window, cap, dtype)
    "s1": (2, 32, 8, 1, 1, 128, True, None, None, torch.bfloat16),
    "s63": (1, 32, 8, 63, 63, 128, True, None, None, torch.bfloat16),
    "s65": (1, 32, 8, 65, 65, 128, True, None, None, torch.bfloat16),
    "s130": (1, 32, 8, 130, 130, 128, True, None, None, torch.bfloat16),
    "s1000": (1, 32, 8, 1000, 1000, 128, True, None, None, torch.bfloat16),
    "sq64_skv1000": (1, 32, 8, 64, 1000, 128, True, None, None, torch.bfloat16),
    "sq1000_skv64_zero_rows": (1, 32, 8, 1000, 64, 128, True, None, None, torch.bfloat16),
    "group1": (1, 8, 8, 300, 300, 128, True, None, None, torch.bfloat16),
    "group7": (1, 28, 4, 700, 700, 128, True, None, None, torch.bfloat16),
    "group32": (1, 32, 1, 512, 512, 128, True, None, None, torch.bfloat16),
    "f16": (1, 32, 8, 333, 333, 128, True, None, None, torch.float16),
    "noncausal": (1, 32, 8, 300, 1000, 128, False, None, None, torch.bfloat16),
    "window1": (1, 32, 8, 1000, 1000, 128, True, 1, None, torch.bfloat16),
    "window45": (1, 32, 8, 1000, 1000, 128, True, 45, None, torch.bfloat16),
    "window400": (1, 32, 8, 1000, 1000, 128, True, 400, None, torch.bfloat16),
    "d64_window45": (1, 8, 2, 700, 700, 64, True, 45, None, torch.bfloat16),
    "d256_cap50": (2, 16, 8, 700, 700, 256, True, None, 50.0, torch.bfloat16),
    "d256_cap1_window400": (1, 16, 8, 1000, 1000, 256, True, 400, 1.0, torch.bfloat16),
    "d256_sq1000_skv64_zero_rows": (1, 16, 8, 1000, 64, 256, True, None, None, torch.bfloat16),
    "d256_f16_noncausal": (1, 16, 8, 300, 500, 256, False, None, 50.0, torch.float16),
}


@pytest.mark.parametrize("case", list(PREFILL_EDGES), ids=list(PREFILL_EDGES))
def test_prefill_kernel_edges_with_lse_repeat_bit_for_bit(device, case):
    b, hq, hkv, sq, skv, d, causal, window, cap, dtype = PREFILL_EDGES[case]
    gen = torch.Generator(device="cuda").manual_seed(38)
    q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    again, lse_again = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    assert torch.equal(out, flash_fwd.flash_attention_fwd(q, k, v, **kw))
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                       return_lse=True, **kw)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= LSE_TOL
    if causal and sq > skv:  # rows with no key: exact zeros, lse +inf
        assert (out[:, :, : sq - skv] == 0).all() and torch.isinf(lse[:, :, : sq - skv]).all()


# Gemma2 (soft caps, head dim 256) on P / B2, D1 + D2, B5, B6 and the append,
# at Gemma-2-9B attention widths (Hq 16, Hkv 8, D 256, scale 256 ** -0.5)
# and, for the cap alone, Llama widths (32 / 8, D 128). Each case runs with
# the model's cap 50 and with 1.0, which binds on every score. The plain
# version runs on the fp32 image of q (an fp32 result), as for windows.
GEMMA_WIDTHS = {"d256": (16, 8, 256), "d128": (32, 8, 128)}
CAPS = {"cap50": 50.0, "cap1": 1.0}
GEMMA_PREFILL = {
    # name: (batch, sq, skv, window, dtype)
    "causal_b2_s1024": (2, 1024, 1024, None, torch.bfloat16),
    "window256_s1024": (2, 1024, 1024, 256, torch.bfloat16),
    "offset_256_1024": (1, 256, 1024, None, torch.bfloat16),
    "ragged_s1000": (1, 1000, 1000, None, torch.float16),
}


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("case", list(GEMMA_PREFILL))
@pytest.mark.parametrize("widths", list(GEMMA_WIDTHS))
def test_gemma2_prefill_kernel_matches_plain(device, widths, case, cap):
    hq, hkv, d = GEMMA_WIDTHS[widths]
    b, sq, skv, window, dtype = GEMMA_PREFILL[case]
    gen = torch.Generator(device="cuda").manual_seed(40)
    q = randn(gen, b, hq, sq, d, dtype=dtype)
    k, v = randn(gen, b, hkv, skv, d, dtype=dtype), randn(gen, b, hkv, skv, d, dtype=dtype)
    counter = flash_fwd.WINDOWED_PREFILL if window else flash_fwd.PREFILL
    before = counter.launches
    out = flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=window,
                                        logit_softcap=CAPS[cap])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = flash_fwd.flash_attention_fwd_plain(q.float(), k.float(), v.float(), causal=True,
                                              window=window, logit_softcap=CAPS[cap])
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("widths", list(GEMMA_WIDTHS))
def test_gemma2_decode_kernels_match_plain(device, widths, cap, window):
    hq, hkv, d = GEMMA_WIDTHS[widths]
    gen = torch.Generator(device="cuda").manual_seed(41)
    lens = [576, 513, 37, 0]
    kc, vc = stacked_cache(gen, lens, layers=2, hkv=hkv, d=d)
    q = randn(gen, 4, hq, 1, d)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = (flash_decode.PARTIALS.launches, flash_decode.COMBINE.launches)
    out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths, window=window,
                                              logit_softcap=CAPS[cap], num_splits=5, layer=1)
    torch.cuda.synchronize()
    assert (flash_decode.PARTIALS.launches, flash_decode.COMBINE.launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_decode.flash_attention_decode_plain(q.float(), kc, vc, kv_length=lengths,
                                                    window=window, logit_softcap=CAPS[cap],
                                                    num_splits=5, layer=1)
    assert torch.isfinite(out).all() and (out[3] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("widths", list(GEMMA_WIDTHS))
def test_gemma2_paged_kernels_match_plain(device, widths, cap):
    """B5 (+ D2) and B6 (chunk of 100, window 64 on one call) over NaN past
    every length behind a permuted table."""
    hq, hkv, d = GEMMA_WIDTHS[widths]
    gen = torch.Generator(device="cuda").manual_seed(42)
    lens = [0, 1, 17, 1024, 777, 33]  # decode; the extend's kv_length below
    kvl_list = [0, 100, 100, 1024, 777, 120]
    kp, vp, table = paged_pool(gen, 16, len(lens), hkv=hkv, d=d, lengths=kvl_list)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = randn(gen, len(lens), hq, 1, d)
    out = paged_attention.paged_attention_decode(q, kp, vp, lengths, table,
                                                 logit_softcap=CAPS[cap])
    ref = paged_attention.paged_attention_decode_plain(q.float(), kp, vp, lengths, table,
                                                       logit_softcap=CAPS[cap])
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    qe = randn(gen, len(lens), 100, hq, d).transpose(1, 2)
    kvl = torch.tensor(kvl_list, dtype=torch.int32, device="cuda")
    off = (kvl - 100).clamp(min=0)
    for window in (None, 64):
        out = paged_attention.paged_attention_extend(qe, kp, vp, off, kvl, table, window=window,
                                                     logit_softcap=CAPS[cap])
        ref = paged_attention.paged_attention_extend_plain(qe.float(), kp, vp, off, kvl, table,
                                                           window=window,
                                                           logit_softcap=CAPS[cap])
        assert torch.isfinite(out).all() and (out[0] == 0).all()
        assert (out.float() - ref).abs().max().item() <= BF16_TOL


def test_gemma2_paged_append_at_d256_writes_what_plain_writes(device):
    gen = torch.Generator(device="cuda").manual_seed(43)
    starts, act = [0, 13, 1024 - 40, 37], [1, 1, 1, 0]
    kp, vp, table = paged_pool(gen, 16, len(starts), d=256)
    new_k = randn(gen, len(starts), 100, 8, 256).transpose(1, 2)
    new_v = randn(gen, len(starts), 100, 8, 256).transpose(1, 2)
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    active = torch.tensor(act, dtype=torch.bool, device="cuda")
    ref_k, ref_v = kp.clone(), vp.clone()
    paged_cache.paged_append_layer(kp, vp, new_k, new_v, table, lengths, active)
    paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
    assert torch.equal(kp, ref_k) and torch.equal(vp, ref_v)


def test_gemma2_routes_outside_the_slice_raise(device):
    """The soft cap stays refused by B13 under autograd, naming ROADMAP.md
    A10b, while B13a / B13b take D 256; nothing falls back to a plain
    version. B4, B7, B8, B9 (here), B12 and
    QA take both (test_chunked_extend_kernel_geometry,
    test_contiguous_decode_kernels_geometry,
    test_paged_decode_kernels_geometry,
    test_quant_paged_extend_kernel_takes_the_cap_and_d256,
    test_varlen_kernel_takes_the_cap_and_d256,
    test_quant_append_kernel_writes_what_plain_writes_at_d256)."""
    gen = torch.Generator(device="cuda").manual_seed(44)
    q, k, v, off, lens = chunked_inputs(gen, 16, 8, 5, 64, [0, 3], None, 256, torch.bfloat16)
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, logit_softcap=50.0)
    assert flash_chunked.CHUNKED.launches == before + 1
    ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens,
                                                      logit_softcap=50.0)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    cache = QuantizedKV(torch.zeros(2, 8, 64, 256, dtype=torch.int8, device="cuda"),
                        torch.ones(2, 8, 64, device="cuda"))
    qd = randn(gen, 2, 16, 1, 256)
    pages = QuantizedKV(torch.zeros(8, 9, 16, 256, dtype=torch.int8, device="cuda"),
                        torch.ones(8, 9, 16, device="cuda"))
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").view(2, 4)
    for kernel, fn, args in (
            (quant.QUANT_DECODE, quant.flash_attention_decode_quantized, (qd, cache, cache, lens)),
            (quant.QUANT_PAGED_DECODE, quant.paged_attention_decode_quantized,
             (qd, pages, pages, lens, table)),
            (quant.QUANT_PAGED_EXTEND, quant.paged_attention_extend_quantized,
             (q, pages, pages, off, lens, table))):
        before = kernel.launches
        out = fn(*args, logit_softcap=50.0)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1 and torch.isfinite(out).all()
    # B13a / B13b take D 256 (Gemma's 16 / 8 heads, a chunk of 5 rows over
    # 64 keys: bottom-right causal) but not the cap, which stays refused
    # under autograd.
    kb, vb, dob = randn(gen, 2, 8, 64, 256), randn(gen, 2, 8, 64, 256), randn(gen, 2, 16, 5, 256)
    qb = randn(gen, 2, 16, 5, 256)
    o, lse = flash_fwd.flash_attention_fwd(qb, kb, vb, causal=True, return_lse=True)
    before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
    got = flash_bwd.flash_attention_bwd(qb, kb, vb, o, dob, lse, causal=True)
    torch.cuda.synchronize()
    assert (flash_bwd.DKV.launches, flash_bwd.DQ.launches) == (before[0] + 1, before[1] + 1)
    want = flash_bwd.flash_attention_bwd_plain(qb.float(), kb.float(), vb.float(), o, dob, lse,
                                               causal=True)
    assert all(rel_err(a, w) <= GRAD_REL_TOL for a, w in zip(got, want))
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="A10b"):  # no backward takes the cap
        api.flash_attn_func(q, k, v, causal=True, logit_softcap=50.0)


# B4's geometry since its Hopper redesign: (hq, hkv, s, capacity, q_offset,
# kv_length (None: q_offset + s, but 0 in row 1), d, causal, window, cap,
# dtype). A block
# packs the largest divisor of the GQA group whose heads' rows fit 128
# (S 5 at groups 2 / 7 / 4, S 16 at group 8: 128 rows exactly, S 40 at
# group 4: two heads); S 20 at group 7 and S 256 take one head a block.
# Row 1 is inactive (kv_length 0, exact zeros); caches are NaN at and past
# every kv_length; q / k / v are the model's transposed views.
CHUNKED_GEOMETRY = {
    "pack_s5_g2_d256_cap50": (16, 8, 5, 700, [600, 0, 13], None, 256, True, None, 50.0,
                              torch.bfloat16),
    "pack_s5_g2_d256_cap1_w45": (16, 8, 5, 700, [600, 0, 13], None, 256, True, 45, 1.0,
                                 torch.bfloat16),
    "pack_s5_g7_d128": (28, 4, 5, 640, [511, 0, 130], None, 128, True, None, None,
                        torch.bfloat16),
    "pack_s16_g8_d128_cap30": (32, 4, 16, 640, [300, 0, 1], None, 128, True, None, 30.0,
                               torch.float16),
    "pack_s40_g4_d64_w100": (32, 8, 40, 512, [400, 0, 7], None, 64, True, 100, None,
                             torch.bfloat16),
    "pack_s1_g4_d128": (32, 8, 1, 300, [299, 0, 0], None, 128, True, None, None,
                        torch.bfloat16),
    "fallback_s20_g7_d128_cap50": (28, 4, 20, 640, [500, 0, 33], None, 128, True, None, 50.0,
                                   torch.bfloat16),
    "fallback_s256_g2_d256_cap50_w4096": (16, 8, 256, 1200, [900, 0, 70], None, 256, True, 4096,
                                          50.0, torch.bfloat16),
    "noncausal_s300_d256": (16, 8, 300, 900, [0, 0, 500], [300, 0, 800], 256, False, None, None,
                            torch.bfloat16),
}


@pytest.mark.parametrize("case", list(CHUNKED_GEOMETRY), ids=list(CHUNKED_GEOMETRY))
def test_chunked_extend_kernel_geometry(device, case):
    """B4 at D 64 / 128 / 256, with and without the cap and windows, packed
    and one head a block, against its fp32 plain version run on q's fp32
    image; an inactive row of exact zeros over NaN tails; a second call
    bit-identical to the first."""
    hq, hkv, s, cap_len, offs, kvl, d, causal, window, cap, dtype = CHUNKED_GEOMETRY[case]
    kvl = kvl or [o + s if i != 1 else 0 for i, o in enumerate(offs)]
    gen = torch.Generator(device="cuda").manual_seed(36)
    q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap_len, offs, kvl, d, dtype)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = flash_chunked.CHUNKED.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    again = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    torch.cuda.synchronize()
    assert flash_chunked.CHUNKED.launches == before + 2
    assert torch.equal(out, again)
    ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens, **kw)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out[1] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


# B4's (o, m, l) partials at ring attention's step geometries
# (parallel/sequence.py): (hq, hkv, s, capacity, q_offset, kv_length, d,
# causal, window, cap, dtype), kv_length None = the capacity. A chunk of
# 256 rows against one of 256 keys at the offsets S_local (every key seen),
# 0 (its own chunk) and -S_local (a later chunk: an empty walk) in one
# call; the zig-zag's half shapes (the diagonal stripe, the high stripe
# against the pair at S_local / 2 and at S_local, both stripes against the
# low one); D 96 and 256; a group of 16 (S 5: sixteen heads a block, S 100:
# one); the window and the cap; a row of kv_length 0; the two-part P of a
# chunk of at most 16 rows; f16; caches NaN at and past every kv_length.
PARTIALS = {
    "offsets_s_0_minus_s": (32, 8, 256, 256, [256, 0, -256], None, 128, True, None, None,
                            torch.bfloat16),
    "zigzag_diagonal": (32, 8, 128, 128, [0, 0], None, 128, True, None, None, torch.bfloat16),
    "zigzag_own_high": (32, 8, 128, 256, [128, 128], None, 128, True, None, None,
                        torch.bfloat16),
    "zigzag_later_high": (32, 8, 128, 256, [256, 256], None, 128, True, None, None,
                          torch.bfloat16),
    "zigzag_earlier": (32, 8, 256, 128, [256, 256], None, 128, True, None, None,
                       torch.bfloat16),
    "d96_offsets": (32, 32, 200, 200, [200, 0, -200], None, 96, True, None, None,
                    torch.bfloat16),
    "d256_cap50": (16, 8, 192, 192, [192, 0, -192], None, 256, True, None, 50.0, torch.bfloat16),
    "group16_s5": (32, 2, 5, 300, [300, 2, -5], None, 128, True, None, None, torch.bfloat16),
    "group16_s100": (32, 2, 100, 300, [300, 40, -100], None, 128, True, None, None,
                     torch.bfloat16),
    "window45_cap30": (32, 8, 150, 400, [400, 90, 0], None, 128, True, 45, 30.0, torch.bfloat16),
    "kv_length_0": (32, 8, 64, 256, [256, 10, 0], [256, 74, 0], 128, True, None, None,
                    torch.bfloat16),
    "split_p_s12_f16": (32, 8, 12, 640, [640, 300, -12], None, 128, True, None, None,
                        torch.float16),
    "noncausal_d64": (8, 2, 70, 333, [0, 33, 263], [333, 100, 0], 64, False, None, None,
                      torch.bfloat16),
}


@pytest.mark.parametrize("case", list(PARTIALS), ids=list(PARTIALS))
def test_chunked_partials_kernel_matches_plain(device, case):
    """B4's partials against the plain partials on the same inputs
    (`partials_err` <= 3e-2), rows with no visible key exact (m = l = o =
    0), every value finite over NaN tails, a second call bit for bit."""
    hq, hkv, s, cap_len, offs, kvl, d, causal, window, cap, dtype = PARTIALS[case]
    kvl = kvl or [cap_len] * len(offs)
    gen = torch.Generator(device="cuda").manual_seed(39)
    q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap_len, offs, kvl, d, dtype)
    kw = dict(causal=causal, window=window, logit_softcap=cap, return_partials=True)
    before = flash_chunked.PARTIALS.launches, flash_chunked.CHUNKED.launches
    got = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    again = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    torch.cuda.synchronize()
    assert (flash_chunked.PARTIALS.launches, flash_chunked.CHUNKED.launches) == (
        before[0] + 2, before[1])
    want = flash_chunked.flash_attention_chunked_plain(q, k, v, off, lens, **kw)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a) and torch.isfinite(g).all()
    assert partials_err(got, want) <= BF16_TOL
    dead = want[2] == 0
    assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    assert (got[0][dead] == 0).all()


@pytest.mark.parametrize("s,causal,launches", [(2048, True, 4 * 5), (2048, False, 4 * 4),
                                               (2044, True, 4 * 4)],
                         ids=["zigzag", "noncausal", "odd_s_local"])
def test_ring_attention_unrolled_launches_b4_partials(device, s, causal, launches):
    """The ring over 4 ranks, unrolled in one process (parallel/sequence.py),
    at Llama widths against P over the whole sequence: B4's partials n (n
    + 1) times on the zig-zag (two calls at each rank's own pair), n^2
    otherwise; the all-gather route launches B4 once a rank."""
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    gen = torch.Generator(device="cuda").manual_seed(40)
    q, k, v = randn(gen, 1, 32, s, 128), randn(gen, 1, 8, s, 128), randn(gen, 1, 8, s, 128)
    want = flash_fwd.flash_attention_fwd(q, k, v, causal=causal).float()
    before = flash_chunked.PARTIALS.launches, flash_chunked.CHUNKED.launches
    ring = seq.ring_attention_unrolled(q, k, v, 4, causal=causal)
    gathered = seq.allgather_attention_unrolled(q, k, v, 4, causal=causal)
    torch.cuda.synchronize()
    assert (flash_chunked.PARTIALS.launches, flash_chunked.CHUNKED.launches) == (
        before[0] + launches, before[1] + 4)
    assert ring.dtype == q.dtype and torch.isfinite(ring).all()
    assert (ring.float() - want).abs().max().item() <= BF16_TOL
    assert (gathered.float() - want).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("d,cap,window", [(64, None, None), (64, 50.0, 64), (128, 30.0, None),
                                          (128, 1.0, 100), (256, None, None), (256, 50.0, 64),
                                          (256, 1.0, None)])
@pytest.mark.parametrize("case", ["equal_causal", "cross_bottom_right", "equal_full"])
def test_varlen_kernel_takes_the_cap_and_d256(device, case, d, cap, window):
    """B12 at D 64 / 128 / 256 with the soft cap and windows (Gemma-2-9B's
    16 / 8 heads) against its fp32 plain version; rows with no key exact
    zeros; a second call bit-identical to the first."""
    lens_q, lens_kv, causal, _ = VARLEN[case]
    lens_kv = lens_kv or lens_q
    gen = torch.Generator(device="cuda").manual_seed(37)
    q = randn(gen, sum(lens_q), 16, d)
    k, v = randn(gen, sum(lens_kv), 8, d), randn(gen, sum(lens_kv), 8, d)

    def cu(lens):
        return torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)

    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = flash_varlen.VARLEN.launches
    out = flash_varlen.flash_attention_varlen(q, k, v, cu(lens_q), cu(lens_kv), **kw)
    again = flash_varlen.flash_attention_varlen(q, k, v, cu(lens_q), cu(lens_kv), **kw)
    torch.cuda.synchronize()
    assert flash_varlen.VARLEN.launches == before + 2
    assert torch.equal(out, again)
    ref = flash_varlen.flash_attention_varlen(q.cpu().float(), k.cpu().float(), v.cpu().float(),
                                              cu(lens_q).cpu(), cu(lens_kv).cpu(), **kw)
    assert torch.isfinite(out).all()
    assert (out.float().cpu() - ref).abs().max().item() <= BF16_TOL
    if case == "cross_bottom_right":  # q longer than kv: the first 100 rows of seq 1 are 0
        assert (out[64:164] == 0).all()


INT8_PREFILL = {
    # name: (batch, hq, hkv, sq, skv, d, causal, window, cap, dtype, transposed, lse)
    "d128_b4_s512": (4, 32, 8, 512, 512, 128, True, None, None, torch.bfloat16, False, False),
    "d128_window100_views": (1, 32, 8, 1000, 1000, 128, True, 100, None, torch.bfloat16, True,
                             True),
    "d64_noncausal_cross_lse": (2, 8, 2, 200, 700, 64, False, None, None, torch.bfloat16, False,
                                True),
    "d64_f16_zero_rows_cap": (1, 8, 1, 300, 100, 64, True, None, 30.0, torch.float16, True, True),
    "d256_cap50_ragged": (2, 16, 8, 333, 333, 256, True, None, 50.0, torch.bfloat16, True, True),
    "d256_window64_cap1_f16": (1, 16, 8, 600, 600, 256, True, 64, 1.0, torch.float16, False,
                               True),
    # Head dims outside {64, 128, 256} (the head-dim rule; D 4 and 100 at
    # rows of 8 and 104, through the padded copy of the views).
    "d96_b4_s512": (4, 32, 32, 512, 512, 96, True, None, None, torch.bfloat16, True, True),
    "d100_window100_views": (1, 32, 8, 1000, 1000, 100, True, 100, None, torch.bfloat16, True,
                             True),
    "d40_f16_cap30": (2, 32, 8, 333, 333, 40, True, None, 30.0, torch.float16, False, True),
    "d4_noncausal_cross": (2, 32, 8, 200, 700, 4, False, None, None, torch.bfloat16, True, True),
}


@pytest.mark.parametrize("case", list(INT8_PREFILL), ids=list(INT8_PREFILL))
def test_int8_prefill_kernels_match_plain(device, case):
    """K8 then P-i8 (B2-i8 where the window binds) against the plain int8
    version, the fp32 oracle and the bf16-score kernel."""
    b, hq, hkv, sq, skv, d, causal, window, cap, dtype, views, with_lse = INT8_PREFILL[case]
    gen = torch.Generator(device="cuda").manual_seed(41)
    if views:  # the model's [B, S, H, D] projections
        q = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
        k = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
        v = randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    else:
        q, k, v = (randn(gen, b, h, s, d, dtype=dtype) for h, s in ((hq, sq), (hkv, skv),
                                                                     (hkv, skv)))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    kern = flash_fwd.WINDOWED_PREFILL_INT8 if window else flash_fwd.PREFILL_INT8
    before = (kern.launches, flash_fwd.QUANTIZE_K.launches, flash_fwd.PREFILL.launches)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, score_dtype="int8", **kw)
    again = flash_fwd.flash_attention_fwd(q, k, v, return_lse=with_lse, score_dtype="int8", **kw)
    torch.cuda.synchronize()
    assert (kern.launches, flash_fwd.QUANTIZE_K.launches, flash_fwd.PREFILL.launches) == (
        before[0] + 2, before[1] + 2, before[2])
    assert torch.equal(out, again[0] if with_lse else again)
    if with_lse:
        assert torch.equal(lse, again[1])
    ref, ref_lse = flash_fwd.int8_attention_plain(q, k, v, d ** -0.5, causal, window, cap, True,
                                                  out_dtype=torch.float32)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    fin = torch.isfinite(ref_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-3
    oracle = flash_fwd.flash_attention_fwd_plain(q.float(), k.float(), v.float(), **kw)
    assert (out.float() - oracle).abs().max().item() <= 5e-2
    bf16_scores = flash_fwd.flash_attention_fwd(q, k, v, **kw)
    assert (out.float() - bf16_scores.float()).abs().max().item() > 1e-4
    if causal and sq > skv:
        assert (out[:, :, : sq - skv] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128, 256, 4, 40, 96, 100])
def test_k8_is_bit_identical_to_plain(device, d, dtype):
    """K8 over a transposed view with a zero row and a ragged length: the
    plain quantizer's values and scales exactly, zeros past Skv; below the
    layout's D its int8 rows lie at `_build.row_pitch(d, 1)` with zeros
    past d."""
    gen = torch.Generator(device="cuda").manual_seed(42)
    k = (4 * randn(gen, 2, 333, 8, d, dtype=dtype)).transpose(1, 2)
    k[1, 3, 7] = 0
    before = flash_fwd.QUANTIZE_K.launches
    values, scales = flash_fwd.quantize_k_rows(k)
    _, padded = flash_fwd._quantize_k_padded(k)
    torch.cuda.synchronize()
    assert flash_fwd.QUANTIZE_K.launches == before + 2
    want_v, want_s = flash_fwd.quantize_rows_plain(k)
    assert values.dtype == torch.int8 and torch.equal(values, want_v)
    assert torch.equal(scales, want_s) and scales[1, 3, 7] == 1
    assert padded.shape[2] == 384 and (padded[..., 333:] == 0).all()
    pitch = _build.row_pitch(d, 1)
    assert values.stride(2) == pitch
    if pitch > d:
        assert (values.as_strided(values.shape[:3] + (pitch,), values.stride())[..., d:]
                == 0).all()
    cpu_v, cpu_s = flash_fwd.quantize_rows_plain(k.cpu())
    assert torch.equal(values.cpu(), cpu_v) and torch.equal(scales.cpu(), cpu_s)


def test_api_int8_scores_launch_k8_and_p_i8(device):
    """The API's dense prefill with score_dtype="int8": K8 and P-i8 once
    each, no bf16-score P; a binding window: B2-i8."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    q, k, v = randn(gen, 2, 32, 256, 128), randn(gen, 2, 8, 256, 128), randn(gen, 2, 8, 256, 128)
    counted = (flash_fwd.QUANTIZE_K, flash_fwd.PREFILL_INT8, flash_fwd.WINDOWED_PREFILL_INT8,
               flash_fwd.PREFILL, flash_fwd.WINDOWED_PREFILL)
    before = [x.launches for x in counted]
    with torch.no_grad():
        out = api.flash_attention_forward(q, k, v, causal=True, score_dtype="int8")
        api.flash_attention_forward(q, k, v, causal=True, window=100, score_dtype="int8")
    torch.cuda.synchronize()
    assert [x.launches - n for x, n in zip(counted, before)] == [2, 1, 1, 0, 0]
    ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True, score_dtype="int8")
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    with pytest.raises(NotImplementedError, match="forward-only"):
        api.flash_attention_forward(q.requires_grad_(), k, v, causal=True, score_dtype="int8")


# Head dims outside {64, 128, 256}: P / B2, D1 + D2, B5, B6 and the paged
# append run every multiple of 8 up to 256 in the layout of the next of
# 64, 128 and 256 (TMA reads zeros past d). D 32 (a 64-column box over a
# 32-column row), 80 (Danube's 32 / 8 heads), 96 (Phi-3-mini's 32 / 32),
# 160 (a box of D 256's layout wholly past d) and 192, in bf16 and f16,
# each held to its fp32 plain version at 3e-2 over NaN tails and repeated
# bit for bit; D 520 refused before any launch (D 264 runs in the wide
# layouts of 512). Since the pitched rows also
# D 4, 36 and 100 (rows of 8, 40 and 104 elements) at Llama-3-8B's 32 / 8
# heads, and over one-byte rows (ONE_BYTE_DIMS) D 24, 40 and 72 (rows of
# 32, 48 and 80 bytes).
ODD_DIMS = {32: (16, 4), 80: (32, 8), 96: (32, 32), 160: (16, 8), 192: (16, 4),
            4: (32, 8), 36: (32, 8), 100: (32, 8)}
ONE_BYTE_DIMS = {**ODD_DIMS, 24: (32, 8), 40: (32, 8), 72: (32, 8)}
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


def held(fn, plain, kernel, *args, **kw):
    """Two calls of `fn` (one launch of `kernel` each, bit for bit), and the
    first's max |diff| against the fp32 plain version on q's fp32 image."""
    before = kernel.launches
    out, again = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 and torch.equal(out, again)
    assert torch.isfinite(out).all()
    ref = plain(args[0].float(), *args[1:], **kw)
    return out, (out.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_DIMS))
def test_prefill_kernels_at_odd_head_dims(device, d, dtype):
    """P (causal, ragged S, the model's transposed views) and B2 (a window
    of 100 keys), one launch each a call."""
    hq, hkv = ODD_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(90 + d)
    q = randn(gen, 2, 333, hq, d, dtype=DTYPES[dtype]).transpose(1, 2)
    k = randn(gen, 2, 333, hkv, d, dtype=DTYPES[dtype]).transpose(1, 2)
    v = randn(gen, 2, 333, hkv, d, dtype=DTYPES[dtype]).transpose(1, 2)
    for kernel, window in ((flash_fwd.PREFILL, None), (flash_fwd.WINDOWED_PREFILL, 100)):
        out, err = held(flash_fwd.flash_attention_fwd, flash_fwd.flash_attention_fwd_plain,
                        kernel, q, k, v, causal=True, window=window)
        assert out.shape == (2, hq, 333, d) and err <= BF16_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_DIMS))
def test_decode_kernels_at_odd_head_dims(device, d, dtype):
    """D1 + D2 over a stacked cache with NaN tails (rows of lengths 0, 1,
    37, C, C - 1 and C / 2 + 3) through `layer`; D1's partials against the
    plain partials at 7 splits."""
    hq, hkv = ODD_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(100 + d)
    lens = [0, 1, 37, 577, 576, 291]
    k, v = stacked_cache(gen, lens, layers=2, hkv=hkv, cap=577, d=d)
    k, v = k.to(DTYPES[dtype]), v.to(DTYPES[dtype])
    q = randn(gen, len(lens), hq, 1, d, dtype=DTYPES[dtype])
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = flash_decode.COMBINE.launches
    out, err = held(flash_decode.flash_attention_decode, flash_decode.flash_attention_decode_plain,
                    flash_decode.PARTIALS, q, k, v, lengths, layer=1)
    assert flash_decode.COMBINE.launches == before + 2
    assert err <= BF16_TOL and (out[0] == 0).all()
    got = flash_decode.decode_partials(q, k[1], v[1], lengths, d ** -0.5, 7)
    want = flash_decode.decode_partials_plain(q, k[1], v[1], lengths, d ** -0.5, 7)
    assert got[0].shape == want[0].shape == (len(lens), hkv, 7, hq // hkv, d)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_DIMS))
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernels_at_odd_head_dims(device, ps, d, dtype):
    """B5 + D2 (a decode), B6 (a chunk of 130 rows at offsets off the tiles,
    an inactive row) and the append, over NaN-poisoned pools behind a
    permuted table."""
    hq, hkv = ODD_DIMS[d]
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(110 + d + ps)
    lens = [0, 1, ps - 1, ps + 1, 1024, 777]
    kp, vp, table = paged_pool(gen, ps, len(lens), hkv=hkv, d=d, lengths=lens)
    kp, vp = pitched(kp.to(dt)), pitched(vp.to(dt))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = randn(gen, len(lens), hq, 1, d, dtype=dt)
    out, err = held(paged_attention.paged_attention_decode,
                    paged_attention.paged_attention_decode_plain, paged_attention.PAGED_DECODE,
                    q, kp, vp, lengths, table)
    assert err <= BF16_TOL and (out[0] == 0).all()

    offs = torch.tensor([0, 61, 599, 0, 200, 700], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([130, 191, 729, 0, 330, 830], dtype=torch.int32, device="cuda")
    kp, vp, table = paged_pool(gen, ps, len(lens), hkv=hkv, d=d, lengths=kvl.tolist())
    kp, vp = pitched(kp.to(dt)), pitched(vp.to(dt))
    qe = randn(gen, len(lens), 130, hq, d, dtype=dt).transpose(1, 2)
    out, err = held(paged_attention.paged_attention_extend,
                    paged_attention.paged_attention_extend_plain, paged_attention.PAGED_EXTEND,
                    qe, kp, vp, offs, kvl, table)
    assert err <= BF16_TOL and (out[3] == 0).all()

    new_k = randn(gen, len(lens), 5, hkv, d, dtype=dt).transpose(1, 2)
    new_v = randn(gen, len(lens), 5, hkv, d, dtype=dt).transpose(1, 2)
    active = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool, device="cuda")
    ref_k, ref_v = kp.clone(), vp.clone()
    before = paged_cache.APPEND.launches
    paged_cache.paged_append_layer(kp, vp, new_k, new_v, table, lengths, active)
    torch.cuda.synchronize()
    assert paged_cache.APPEND.launches == before + 1
    paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
    assert torch.equal(kp.nan_to_num(), ref_k.nan_to_num())
    assert torch.equal(vp.nan_to_num(), ref_v.nan_to_num())


@pytest.mark.parametrize("d", [100, 264])
def test_odd_head_dim_kernels_refuse_what_no_layout_takes(device, d):
    """D 100, refused so before the pitched rows, and D 264, refused so
    before the wide layouts of 512 (P and B6, then the decodes and the
    append), launch each kernel once (D 100's pool at rows of 104), B6 and
    B5 within BF16_TOL of their plain versions; D 520, which no layout
    takes, raises naming the roadmap item before any launch; nothing falls
    back."""
    gen = torch.Generator(device="cuda").manual_seed(120)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").view(2, 4)
    counted = (flash_fwd.PREFILL, flash_decode.PARTIALS, flash_decode.COMBINE,
               paged_attention.PAGED_DECODE, paged_attention.PAGED_EXTEND, paged_cache.APPEND)

    def calls(dd):
        q, k = randn(gen, 2, 4, 64, dd), randn(gen, 2, 2, 64, dd)
        kp, vp = pitched(randn(gen, 2, 9, 16, dd)), pitched(randn(gen, 2, 9, 16, dd))
        return kp, vp, q, [
            lambda: flash_fwd.flash_attention_fwd(q, k, k, causal=True),
            lambda: flash_decode.flash_attention_decode(q[:, :, :1], k, k, lengths),
            lambda: paged_attention.paged_attention_decode(q[:, :, :1], kp, vp, lengths, table),
            lambda: paged_attention.paged_attention_extend(q[:, :, :4], kp, vp, lengths,
                                                           lengths + 4, table),
            lambda: paged_cache.paged_append_layer(kp, vp, k[:, :, :2], k[:, :, :2], table,
                                                   lengths),
        ]

    kp, vp, q, taken = calls(d)
    kc, vc = kp.clone(), vp.clone()  # the pools before the append writes them
    before = [x.launches for x in counted]
    outs = [call() for call in taken]
    torch.cuda.synchronize()
    assert [x.launches - n for x, n in zip(counted, before)] == [1, 1, 2, 1, 1, 1]
    for out, ref in ((outs[3], paged_attention.paged_attention_extend_plain(
            q[:, :, :4].float(), kc, vc, lengths, lengths + 4, table)),
                     (outs[2], paged_attention.paged_attention_decode_plain(
                         q[:, :, :1].float(), kc, vc, lengths, table))):
        assert (out.float() - ref).abs().max().item() <= BF16_TOL
    if d < 256:
        return
    _, _, _, refused = calls(d + 256)
    before = [x.launches for x in counted]
    for call in refused:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A14"):
            call()
    torch.cuda.synchronize()
    assert [x.launches for x in counted] == before


# Head dims outside {64, 128, 256} in training and packed batches: B13a /
# B13b and B12 run every multiple of 8 up to 256 in the layout of the next
# of 64, 128 and 256 (D 8-56 in D 64's, 72-120 in D 128's, 136-248 in D
# 256's, whose second 128-column half is partial). Causal, windowed and
# non-causal, Sq != Skv, GQA groups 1 and 4, bf16 and f16; B13a also forced
# into 3 parts and into one; each held to its plain version (backward
# GRAD_REL_TOL of the gradient's max, B12 3e-2) and repeated bit for bit.
# Since the pitched rows also D 36 and 100 (rows of 40 and 104).
ODD_TRAINING_DIMS = {8: (4, 1), 24: (8, 2), 40: (8, 8), 96: (32, 32), 136: (16, 4),
                     200: (8, 2), 248: (8, 8), 36: (8, 2), 100: (8, 2)}
ODD_BACKWARD = {
    # name: (sq, skv, causal, window)
    "causal_s300": (300, 300, True, None),
    "window_48_sq200_skv333": (200, 333, True, 48),
    "full_sq333_skv200": (333, 200, False, None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_TRAINING_DIMS))
def test_backward_kernels_at_odd_head_dims(device, d, dtype):
    """B13a / B13b on the model's transposed views and a non-contiguous dO,
    fed the kernel forward's o and lse, against the plain backward; B13a
    again in 3 parts and in one pass (`launch(..., splits=)`)."""
    hq, hkv = ODD_TRAINING_DIMS[d]
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(130 + d)
    for name, (sq, skv, causal, window) in ODD_BACKWARD.items():
        q = randn(gen, 1, sq, hq, d, dtype=dt).transpose(1, 2)
        k, v = (randn(gen, 1, skv, hkv, d, dtype=dt).transpose(1, 2) for _ in "kv")
        do = randn(gen, 1, sq, hq, d, dtype=dt).transpose(1, 2)
        o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                               return_lse=True)
        before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
        got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        again = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        torch.cuda.synchronize()
        assert (flash_bwd.DKV.launches, flash_bwd.DQ.launches) == (before[0] + 2, before[1] + 2)
        want = flash_bwd.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do, lse,
                                                   causal=causal, window=window)
        for g, a, c, w in zip(("dq", "dk", "dv"), got, again, want):
            assert a.shape == w.shape and a.dtype == dt and torch.isfinite(a).all(), (name, g)
            assert torch.equal(a, c), (name, g)
            assert rel_err(a, w) <= GRAD_REL_TOL, (name, g, rel_err(a, w))
        delta = (do.float() * o.float()).sum(-1)
        parts = {}
        for splits in (3, 1):
            parts[splits] = tuple(_build.empty_rows(g.shape, g.dtype, g.device)
                                  for g in got[1:])
            flash_bwd.launch(flash_bwd.DKV, q, k, v, do, lse, delta, *parts[splits], d ** -0.5,
                             causal, window or 0, splits=splits)
        torch.cuda.synchronize()
        for i, w in ((0, want[1]), (1, want[2])):
            assert rel_err(parts[1][i], w) <= GRAD_REL_TOL, name
            assert rel_err(parts[3][i], parts[1][i]) <= SPLIT_REL_TOL, name


def varlen_plain(q, k, v, cu_q, cu_kv, **kw):
    """B12's plain version behind the cu_seqlens front end, on the card."""
    seg_q, pos_q = flash_varlen._seg_metadata(cu_q, q.shape[0])
    seg_kv, pos_kv = flash_varlen._seg_metadata(cu_kv, k.shape[0])
    bounds = pos_q + (cu_kv.diff() - cu_q.diff())[seg_q.long()]
    return flash_varlen.flash_attention_packed_plain(
        q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), seg_q, seg_kv, bounds, pos_kv,
        **kw).transpose(0, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_TRAINING_DIMS))
def test_varlen_kernel_at_odd_head_dims(device, d, dtype):
    """B12 over packed batches (causal, kv longer with a window, full), one
    launch a call, against its fp32 plain version on q's fp32 image."""
    hq, hkv = ODD_TRAINING_DIMS[d]
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(140 + d)
    for lens_q, lens_kv, kw in (([100, 37, 256, 1, 190], None, {"causal": True}),
                                ([64, 200, 32], [128, 100, 300], {"causal": True, "window": 64}),
                                ([100, 37, 256], None, {})):
        lens_kv = lens_kv or lens_q
        q = randn(gen, sum(lens_q), hq, d, dtype=dt)
        k, v = (randn(gen, sum(lens_kv), hkv, d, dtype=dt) for _ in "kv")
        cu_q, cu_kv = (torch.tensor([0] + x, device="cuda").cumsum(0).to(torch.int32)
                       for x in (lens_q, lens_kv))
        out, err = held(flash_varlen.flash_attention_varlen, varlen_plain, flash_varlen.VARLEN,
                        q, k, v, cu_q, cu_kv, **kw)
        assert out.shape == q.shape and err <= BF16_TOL, (lens_q, kw, err)


# Head dims outside {64, 128, 256} over one-byte caches and in the extend:
# B7, B8, B9 and QA take every head dim whose int8 / e4m3 row is a multiple
# of 16 bytes, B4 every multiple of 8, each in the layout of the next of 64,
# 128 and 256 (TMA reads zeros past d, which widen to exact zeros). At
# ODD_DIMS' head dims and heads, over int8 and e4m3 (B4: bf16 and f16),
# each held to its fp32 plain version at 3e-2 over NaN tails and repeated
# bit for bit; QA's whole pools bit-identical; a one-byte row of d % 16 ==
# 8 refused before any launch.
@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("d", list(ONE_BYTE_DIMS))
def test_quant_decode_kernel_at_odd_head_dims(device, d, name):
    """B7 + D2 over a stacked cache (NaN scales, and e4m3 NaN values, past
    lengths 0, 1, 37, C, C - 1 and C / 2 + 3) through `layer`, its rows at
    `_build.row_pitch(d, 1)`."""
    hq, hkv = ONE_BYTE_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(130 + d)
    lens = [0, 1, 37, 577, 576, 291]
    k, v = (quant.quantize_kv(randn(gen, 2, len(lens), hkv, 577, d, dtype=torch.float32),
                              KV_DTYPES[name]) for _ in "kv")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(577, device="cuda")[None, :] >= lengths[:, None]
    for kv in (k, v):
        poison(kv, dead[None, :, None, :].expand(2, -1, hkv, -1))
    k, v = (QuantizedKV(pitched(x.values), x.scales) for x in (k, v))
    q = randn(gen, len(lens), hq, 1, d)
    before = flash_decode.COMBINE.launches
    out, err = held(quant.flash_attention_decode_quantized,
                    quant.flash_attention_decode_quantized_plain, quant.QUANT_DECODE,
                    q, k, v, lengths, layer=1)
    assert flash_decode.COMBINE.launches == before + 2
    assert out.shape == (len(lens), hq, 1, d) and err <= BF16_TOL and (out[0] == 0).all()


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("d", list(ONE_BYTE_DIMS))
@pytest.mark.parametrize("ps", [16, 128])
def test_quant_paged_kernels_at_odd_head_dims(device, ps, d, name):
    """B8 + D2 (a decode) and B9 (a chunk of 130 rows at offsets off the
    tiles, an inactive row) over NaN-poisoned pools behind a permuted
    table."""
    hq, hkv = ONE_BYTE_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(140 + d + ps)
    lens = [0, 1, ps - 1, ps + 1, 1024, 777]
    k, v, table = quant_paged_pool(gen, ps, len(lens), KV_DTYPES[name], lens, hkv=hkv, d=d)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, err = held(quant.paged_attention_decode_quantized,
                    quant.paged_attention_decode_quantized_plain, quant.QUANT_PAGED_DECODE,
                    randn(gen, len(lens), hq, 1, d), k, v, lengths, table)
    assert err <= BF16_TOL and (out[0] == 0).all()

    offs = torch.tensor([0, 61, 599, 0, 200, 700], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([130, 191, 729, 0, 330, 830], dtype=torch.int32, device="cuda")
    k, v, table = quant_paged_pool(gen, ps, len(lens), KV_DTYPES[name], kvl.tolist(), hkv=hkv,
                                   d=d)
    qe = randn(gen, len(lens), 130, hq, d).transpose(1, 2)
    out, err = held(quant.paged_attention_extend_quantized,
                    quant.paged_attention_extend_quantized_plain, quant.QUANT_PAGED_EXTEND,
                    qe, k, v, offs, kvl, table)
    assert out.shape == (len(lens), hq, 130, d) and err <= BF16_TOL and (out[3] == 0).all()


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("d", list(ONE_BYTE_DIMS))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_quant_append_kernel_at_odd_head_dims(device, paged, d, name):
    """QA of a 100-token chunk (paged: a row across the end of its table,
    an inactive row): the whole pools, values and scales, bit-identical to
    the plain version's, so no lane wrote past its row's d bytes or read
    the next row into its scale."""
    _, hkv = ONE_BYTE_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(150 + d)
    starts = [0, 13, 1024 - 40, 37]
    new_k, new_v = (randn(gen, len(starts), 100, hkv, d).transpose(1, 2) for _ in "kv")
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    if paged:
        k, v, table = quant_paged_pool(gen, 16, len(starts), KV_DTYPES[name], [1024] * 4,
                                       hkv=hkv, d=d)
        active = torch.tensor([1, 1, 1, 0], dtype=torch.bool, device="cuda")
    else:
        k, v = (quant.quantize_kv(randn(gen, len(starts), hkv, 1124, d), KV_DTYPES[name])
                for _ in "kv")
        table = active = None
    ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (k, v)]
    before = quant.QUANT_APPEND.launches
    quant.quantize_append(new_k, new_v, k, v, lengths, table, active)
    torch.cuda.synchronize()
    assert quant.QUANT_APPEND.launches == before + 1
    quant.quantize_append_plain(new_k, new_v, *ref, lengths, table, active)
    for got, want in zip((k, v), ref):
        assert torch.equal(got.values.view(torch.uint8), want.values.view(torch.uint8))
        assert torch.equal(got.scales.view(torch.int32), want.scales.view(torch.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", list(ODD_DIMS))
def test_chunked_extend_kernel_at_odd_head_dims(device, d, dtype):
    """B4 at a verify round (S 5, a row of kv_length 0) and a chunk (S
    256), over caches NaN past every kv_length, the model's transposed
    views."""
    hq, hkv = ODD_DIMS[d]
    gen = torch.Generator(device="cuda").manual_seed(160 + d)
    for s, cap, offs, kvl in ((5, 582, [571, 0, 300, 13], [576, 0, 305, 18]),
                              (256, 1100, [0, 77, 300, 768], None)):
        q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap, offs, kvl, d, DTYPES[dtype])
        out, err = held(flash_chunked.flash_attention_chunked,
                        flash_chunked.flash_attention_chunked_plain, flash_chunked.CHUNKED,
                        q, k, v, off, lens)
        assert out.shape == (len(offs), hq, s, d) and err <= BF16_TOL
        for i, n in enumerate(lens.tolist()):
            if n == 0:
                assert (out[i] == 0).all()


@pytest.mark.parametrize("d", [40, 24])
def test_one_byte_rows_of_d_mod_16_8_are_refused(device, d):
    """A one-byte row of d bytes, d % 16 == 8, refused before the pitched
    rows (it breaks TMA's 16-byte stride rule): B7, B8, B9 and QA now
    launch once each, the contiguous cache through one padded copy of
    its values (counted as a cache copy), the pools at the pitch; B4, over
    bf16 rows of 2 d bytes, takes such a d."""
    gen = torch.Generator(device="cuda").manual_seed(170)
    k, v, table = quant_paged_pool(gen, 16, 2, torch.int8, [64, 64], capacity=64, hkv=2, d=d)
    cache = quant.quantize_kv(randn(gen, 2, 2, 64, d), torch.int8)
    q = randn(gen, 2, 4, 1, d)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    counted = (quant.QUANT_DECODE, quant.QUANT_PAGED_DECODE, quant.QUANT_PAGED_EXTEND,
               quant.QUANT_APPEND, flash_decode.COMBINE)
    before = [x.launches for x in counted]
    calls = [
        lambda: quant.flash_attention_decode_quantized(q, cache, cache, lengths),
        lambda: quant.paged_attention_decode_quantized(q, k, v, lengths, table),
        lambda: quant.paged_attention_extend_quantized(q, k, v, lengths, lengths + 1, table),
        lambda: quant.quantize_append(q[:, :2], q[:, :2], cache, cache, lengths),
    ]
    copies = _build.copies["cache"]
    for call in calls:
        call()
    torch.cuda.synchronize()
    assert [x.launches - n for x, n in zip(counted, before)] == [1, 1, 1, 1, 2]
    assert _build.copies["cache"] == copies + 2  # B7's contiguous K and V: one copy each
    qc, kc, vc, off, lens = chunked_inputs(gen, 4, 2, 5, 64, [0, 20], None, d, torch.bfloat16)
    out, err = held(flash_chunked.flash_attention_chunked,
                    flash_chunked.flash_attention_chunked_plain, flash_chunked.CHUNKED,
                    qc, kc, vc, off, lens)
    assert err <= BF16_TOL


# Head dims from 257 to 512: P / B2 (with the lse) and B12 run them in the
# wide layout of 512 (a block computes 256 of O's columns, grid y picks
# which, and recomputes S over the whole d; 32-key tiles). D 260 (rows of
# 264, a second chunk of 4 live columns), 320, 384 and 512 (DeepSeek-V4's
# MQA group of 64 cut to 16 heads), causal, a window with the soft cap,
# rows of no key, non-causal f16; each held to its fp32 plain version, the
# lse at LSE_TOL with the same +inf rows, a second call bit for bit.
WIDE_PREFILL = {
    # name: (d, batch, hq, hkv, sq, skv, causal, window, cap, dtype)
    "d512_mqa_causal": (512, 1, 16, 1, 1000, 1000, True, None, None, torch.bfloat16),
    "d512_window_cap": (512, 2, 8, 1, 700, 700, True, 128, 50.0, torch.bfloat16),
    "d260_zero_rows": (260, 1, 8, 2, 600, 300, True, None, None, torch.bfloat16),
    "d320_f16_full": (320, 1, 8, 8, 130, 1000, False, None, None, torch.float16),
    "d384_window": (384, 1, 8, 2, 513, 513, True, 45, None, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(WIDE_PREFILL), ids=list(WIDE_PREFILL))
def test_wide_head_dim_prefill_matches_plain(device, case):
    d, b, hq, hkv, sq, skv, causal, window, cap, dtype = WIDE_PREFILL[case]
    gen = torch.Generator(device="cuda").manual_seed(250)
    q, k, v = (pitched(randn(gen, b, h, s, d, dtype=dtype))
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    kernel = flash_fwd.WINDOWED_PREFILL if window else flash_fwd.PREFILL
    before = kernel.launches
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    again = flash_fwd.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                       return_lse=True, **kw)
    assert out.shape == ref.shape and out.stride(-2) == _build.row_pitch(d)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    assert torch.equal(out, again)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= LSE_TOL
    if causal and sq > skv:
        assert (out[:, :, : sq - skv] == 0).all()


@pytest.mark.parametrize("d", [260, 320, 384, 512])
def test_wide_head_dim_varlen_matches_plain(device, d):
    """B12 at a wide head dim over a packed batch (a 1-token sequence, kv
    longer than q), causal with a window of 100 and the soft cap 30."""
    gen = torch.Generator(device="cuda").manual_seed(251)
    lens_q, lens_kv = [300, 1, 190, 517, 64], [400, 17, 190, 600, 200]
    q, k, v = (pitched(randn(gen, sum(n), h, d)) for n, h in ((lens_q, 8), (lens_kv, 2),
                                                              (lens_kv, 2)))
    cu_q, cu_kv = (torch.tensor([0] + n, device="cuda").cumsum(0).to(torch.int32)
                   for n in (lens_q, lens_kv))
    kw = dict(causal=True, window=100, logit_softcap=30.0)
    before = flash_varlen.VARLEN.launches
    out = flash_varlen.flash_attention_varlen(q, k, v, cu_q, cu_kv, **kw)
    again = flash_varlen.flash_attention_varlen(q, k, v, cu_q, cu_kv, **kw)
    torch.cuda.synchronize()
    assert flash_varlen.VARLEN.launches == before + 2
    ref = varlen_plain(q.float(), k, v, cu_q, cu_kv, **kw)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    assert torch.equal(out, again)


# B4 (with and without its (o, m, l) partials) and B6 at head dims from 257
# to 512, in the wide layout of 512 as P: DeepSeek-V4-Flash's MQA group of
# 64 cut to 16 heads at D 512, a verify-size chunk (S 5: the 16 heads
# packed into one block) and a chunk of 300 rows, NaN at and past every
# kv_length, a row of kv_length 0, a window with the soft cap, D 260 (rows
# of 264, a second chunk of 4 live columns), 320 and 384; each held to its
# fp32 plain version (the partials by `partials_err`), a second call bit
# for bit, rows with no key exact zeros (m = l = o = 0).
WIDE_CHUNKED = {
    # name: (d, hq, hkv, s, capacity, q_offset, kv_length, window, cap, dtype);
    # kv_length None = q_offset + s
    "d512_verify_s5": (512, 16, 1, 5, 700, [0, 130, 511, 600], None, None, None,
                       torch.bfloat16),
    "d512_chunk_s300_inactive": (512, 16, 1, 300, 1100, [0, 77, 0, 768], [300, 377, 0, 1068],
                                 None, None, torch.bfloat16),
    "d512_window_cap": (512, 8, 1, 200, 900, [0, 300, 650], None, 128, 50.0, torch.bfloat16),
    "d260_gqa": (260, 8, 2, 130, 600, [0, 33, 400], None, None, None, torch.bfloat16),
    "d320_f16": (320, 8, 2, 64, 400, [10, 0, 300], [74, 0, 364], None, None, torch.float16),
    "d384_window": (384, 8, 2, 100, 500, [0, 250, 380], None, 45, None, torch.bfloat16),
}


@pytest.mark.parametrize("partials", [False, True], ids=["output", "partials"])
@pytest.mark.parametrize("case", list(WIDE_CHUNKED), ids=list(WIDE_CHUNKED))
def test_wide_head_dim_chunked_matches_plain(device, case, partials):
    d, hq, hkv, s, cap, offs, kvl, window, softcap, dtype = WIDE_CHUNKED[case]
    gen = torch.Generator(device="cuda").manual_seed(260)
    q, k, v, off, lens = chunked_inputs(gen, hq, hkv, s, cap, offs, kvl, d, dtype)
    kw = dict(window=window, logit_softcap=softcap, return_partials=partials)
    kernel = flash_chunked.PARTIALS if partials else flash_chunked.CHUNKED
    before = kernel.launches
    out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    again = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens, **kw)
    dead = lens == 0
    if partials:
        assert all(torch.equal(x, y) for x, y in zip(out, again))
        assert all(torch.isfinite(x).all() for x in out)
        assert out[0].stride(-2) == _build.row_pitch(d)
        assert partials_err(out, ref) <= BF16_TOL
        assert all((x[dead] == 0).all() for x in out)
        return
    assert torch.equal(out, again) and torch.isfinite(out).all()
    assert out.shape == ref.shape and out.dtype == dtype and out.stride(-2) == _build.row_pitch(d)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    assert (out[dead] == 0).all()


@pytest.mark.parametrize("d", [260, 320, 384, 512])
@pytest.mark.parametrize("ps", [16, 64])
def test_wide_head_dim_paged_extend_matches_plain(device, ps, d):
    """B6 over NaN-poisoned pools behind a permuted table (pages of 16 keys:
    two copies a 32-key tile; of 64: half a page a tile), chunks at offsets
    off the tiles, an inactive row, once more with a window of 128 and the
    soft cap 50; MQA 16 / 1 heads at D 512, 8 / 2 below."""
    hq, hkv = (16, 1) if d == 512 else (8, 2)
    gen = torch.Generator(device="cuda").manual_seed(261 + d + ps)
    offs = torch.tensor([0, 61, 599, 0, 200], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([130, 191, 729, 0, 330], dtype=torch.int32, device="cuda")
    kp, vp, table = paged_pool(gen, ps, len(offs), hkv=hkv, d=d, lengths=kvl.tolist())
    q = randn(gen, len(offs), 130, hq, d).transpose(1, 2)
    for kw in ({}, {"window": 128, "logit_softcap": 50.0}):
        out, err = held(paged_attention.paged_attention_extend,
                        paged_attention.paged_attention_extend_plain,
                        paged_attention.PAGED_EXTEND, q, kp, vp, offs, kvl, table, **kw)
        assert out.shape == q.shape and out.stride(-2) == _build.row_pitch(d)
        assert err <= BF16_TOL and (out[3] == 0).all(), kw


# The decodes D1, B5, B7 and B8 at head dims from 257 to 512, in the wide
# layout of csrc/paged_decode.cuh (each consumer warp owns 256 of O's
# columns and computes S over the whole d itself; 16-key tiles), with D2;
# B9 in B6's wide layout (V widened at its chunk's columns); the append and
# QA. DeepSeek-V4-Flash's group of 64 over 1 kv head (two chunks of 32
# rows: both m-tiles, all four warps on every tile), a window of 128 with
# the soft cap 50 at a group of 16 (one m-tile: two slots of two column
# owners), d 264 at a group of 24 and d 320 at 8 / 2; NaN at and past every
# length (one-byte caches: NaN scales, and the e4m3 NaN byte); each held to
# its fp32 plain version and repeated bit for bit, the appends bit-identical.
WIDE_DECODE = {
    # name: (d, hq, hkv, window, cap)
    "d512_group64": (512, 64, 1, None, None),
    "d512_window_cap": (512, 16, 1, 128, 50.0),
    "d264_group24": (264, 24, 1, None, None),
    "d320_gqa": (320, 8, 2, None, 30.0),
}
WIDE_LENGTHS = [0, 1, 37, 577, 576, 291]


@pytest.mark.parametrize("case", list(WIDE_DECODE), ids=list(WIDE_DECODE))
def test_wide_head_dim_contiguous_decodes_match_plain(device, case):
    """D1 + D2 over a stacked bf16 cache, and B7 + D2 over stacked int8 and
    e4m3 caches, through `layer` (capacity 577, no multiple of a tile)."""
    d, hq, hkv, window, cap = WIDE_DECODE[case]
    gen = torch.Generator(device="cuda").manual_seed(270 + d)
    lengths = torch.tensor(WIDE_LENGTHS, dtype=torch.int32, device="cuda")
    q = randn(gen, len(WIDE_LENGTHS), hq, 1, d)
    kw = dict(window=window, logit_softcap=cap, layer=1)
    k, v = stacked_cache(gen, WIDE_LENGTHS, layers=2, hkv=hkv, cap=577, d=d)
    before = flash_decode.COMBINE.launches
    out, err = held(flash_decode.flash_attention_decode, flash_decode.flash_attention_decode_plain,
                    flash_decode.PARTIALS, q, k, v, lengths, **kw)
    assert flash_decode.COMBINE.launches == before + 2
    assert out.shape == q.shape and err <= BF16_TOL and (out[0] == 0).all()
    dead = torch.arange(577, device="cuda")[None, :] >= lengths[:, None]
    for dtype in KV_DTYPES.values():
        kq, vq = (quant.quantize_kv(randn(gen, 2, len(WIDE_LENGTHS), hkv, 577, d,
                                          dtype=torch.float32), dtype) for _ in "kv")
        for kv in (kq, vq):
            poison(kv, dead[None, :, None, :].expand(2, -1, hkv, -1))
        out, err = held(quant.flash_attention_decode_quantized,
                        quant.flash_attention_decode_quantized_plain, quant.QUANT_DECODE,
                        q, kq, vq, lengths, **kw)
        assert err <= BF16_TOL and (out[0] == 0).all(), dtype


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("case", list(WIDE_DECODE), ids=list(WIDE_DECODE))
def test_wide_head_dim_paged_decodes_match_plain(device, case, ps):
    """B5 + D2 over bf16 pools and B8 + D2 over int8 and e4m3 pools behind a
    permuted table, NaN at and past every length and in page 0."""
    d, hq, hkv, window, cap = WIDE_DECODE[case]
    gen = torch.Generator(device="cuda").manual_seed(280 + d + ps)
    lens = [0, 1, ps - 1, ps + 1, 1024, 777]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = randn(gen, len(lens), hq, 1, d)
    kw = dict(window=window, logit_softcap=cap)
    kp, vp, table = paged_pool(gen, ps, len(lens), hkv=hkv, d=d, lengths=lens)
    out, err = held(paged_attention.paged_attention_decode,
                    paged_attention.paged_attention_decode_plain, paged_attention.PAGED_DECODE,
                    q, kp, vp, lengths, table, **kw)
    assert out.shape == q.shape and err <= BF16_TOL and (out[0] == 0).all()
    for dtype in KV_DTYPES.values():
        k, v, table = quant_paged_pool(gen, ps, len(lens), dtype, lens, hkv=hkv, d=d)
        out, err = held(quant.paged_attention_decode_quantized,
                        quant.paged_attention_decode_quantized_plain, quant.QUANT_PAGED_DECODE,
                        q, k, v, lengths, table, **kw)
        assert err <= BF16_TOL and (out[0] == 0).all(), dtype


@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("ps", [16, 64])
def test_wide_head_dim_quant_paged_extend_matches_plain(device, ps, d, name):
    """B9 over NaN-poisoned quantized pools behind a permuted table: chunks
    of 130 rows at offsets off the tiles, an inactive row, once more with a
    window of 128 and the soft cap 50; 16 / 1 heads at D 512, 8 / 2 below."""
    hq, hkv = (16, 1) if d == 512 else (8, 2)
    gen = torch.Generator(device="cuda").manual_seed(290 + d + ps)
    offs = torch.tensor([0, 61, 599, 0, 200], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([130, 191, 729, 0, 330], dtype=torch.int32, device="cuda")
    k, v, table = quant_paged_pool(gen, ps, len(offs), KV_DTYPES[name], kvl.tolist(), hkv=hkv,
                                   d=d)
    q = randn(gen, len(offs), 130, hq, d).transpose(1, 2)
    for kw in ({}, {"window": 128, "logit_softcap": 50.0}):
        out, err = held(quant.paged_attention_extend_quantized,
                        quant.paged_attention_extend_quantized_plain, quant.QUANT_PAGED_EXTEND,
                        q, k, v, offs, kvl, table, **kw)
        assert out.shape == q.shape and out.stride(-2) == _build.row_pitch(d)
        assert err <= BF16_TOL and (out[3] == 0).all(), kw


@pytest.mark.parametrize("d", [264, 320, 512])
def test_wide_head_dim_appends_write_what_plain_writes(device, d):
    """The append of a 100-token chunk (a row across the end of its table,
    an inactive row) into bf16 pools, and QA into int8 / e4m3 pools and
    contiguous caches: the whole pools bit-identical to the plain
    versions'."""
    gen = torch.Generator(device="cuda").manual_seed(300 + d)
    starts = [0, 13, 1024 - 40, 37]
    new_k, new_v = (randn(gen, len(starts), 100, 2, d).transpose(1, 2) for _ in "kv")
    lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
    active = torch.tensor([1, 1, 1, 0], dtype=torch.bool, device="cuda")
    kp, vp, table = paged_pool(gen, 16, len(starts), hkv=2, d=d)
    ref_k, ref_v = kp.clone(), vp.clone()
    before = paged_cache.APPEND.launches
    paged_cache.paged_append_layer(kp, vp, new_k, new_v, table, lengths, active)
    torch.cuda.synchronize()
    assert paged_cache.APPEND.launches == before + 1
    paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
    assert torch.equal(kp, ref_k) and torch.equal(vp, ref_v)
    for dtype in KV_DTYPES.values():
        for paged in (True, False):
            if paged:
                k, v, table = quant_paged_pool(gen, 16, len(starts), dtype, [1024] * 4, hkv=2,
                                               d=d)
                rows = (lengths, table, active)
            else:
                k, v = (quant.quantize_kv(randn(gen, len(starts), 2, 1124, d), dtype)
                        for _ in "kv")
                rows = (lengths,)
            ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (k, v)]
            before = quant.QUANT_APPEND.launches
            quant.quantize_append(new_k, new_v, k, v, *rows)
            torch.cuda.synchronize()
            assert quant.QUANT_APPEND.launches == before + 1
            quant.quantize_append_plain(new_k, new_v, *ref, *rows)
            for got, want in zip((k, v), ref):
                assert torch.equal(got.values.view(torch.uint8), want.values.view(torch.uint8))
                assert torch.equal(got.scales.view(torch.int32), want.scales.view(torch.int32))
