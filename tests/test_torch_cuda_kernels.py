"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without an NVIDIA Hopper GPU (the decision
is taken in the `device` fixture). Run them on the card with
`python -m pytest -m cuda tests/test_torch_cuda_kernels.py`.

Shapes are the Llama-3-8B attention widths (Hq 32, Hkv 8, D 128) that
`chip_smoke.py` uses. Tolerances: kernel P and the decode output are bf16
results of fp32 arithmetic on bf16 inputs held against the fp32 plain
version: max |diff| <= 3e-2 (the repository's bf16 figure). D1's partials
are fp32 sums of the same bf16 inputs in another order: rtol 1e-4 with
atol 1e-3.
"""

import pytest
import torch

from flash_attention_cute_tpu_torch.ops import flash_decode, flash_fwd

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
    q = torch.zeros(1, 4, 64, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash_fwd.flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 64, 64, dtype=torch.float32, device="cuda")
    with pytest.raises(NotImplementedError, match="bf16/f16"):
        flash_fwd.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        flash_decode.flash_attention_decode(q, k, k, kv_length=torch.ones(1, device="cuda"))
