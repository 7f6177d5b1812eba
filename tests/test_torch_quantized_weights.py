"""The port's weight-only quantization (int8 and int4 weights, kernels B10 /
B11's plain versions) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. Quantization must be
bit-identical to the JAX package's (values and scales), the dequantized
images exactly equal. The plain products are held to the JAX products (the
Pallas kernels in interpret mode, and the "xla" form) at fp32 within 2e-4
(int8) and 5e-4 (int4), sums of the same products in another order; bf16
activations within one bf16 rounding of the result. Quantized trees made by
the JAX package cross through `params_from_jax`; the port's `forward`
logits must match the JAX `forward` within 5e-4 at fp32 on the tiny config,
and greedy generation and the serving engine must give the same tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.models import forward as jax_forward
from flash_attention_cute_tpu.models import init_params as jax_init
from flash_attention_cute_tpu.models.cache import KVCache as JaxKVCache
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.fuse import fuse_projections as jax_fuse
from flash_attention_cute_tpu.models.quantize import quantize_params as jax_quantize_params
from flash_attention_cute_tpu.ops import quantized_matmul as jqm
from flash_attention_cute_tpu.runtime.engine import ServingEngine as JaxServingEngine
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import params_from_jax
from flash_attention_cute_tpu_torch.models.fuse import fuse_projections, is_fused
from flash_attention_cute_tpu_torch.models.quantize import (
    dequantize_params,
    quantize_params,
    quantize_params_on_host,
)
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params
from flash_attention_cute_tpu_torch.ops import quantized_matmul as qm
from flash_attention_cute_tpu_torch.runtime import ServingEngine, greedy_generate

QUANTIZE = {8: (qm.quantize_weight, jqm.quantize_weight),
            4: (qm.quantize_weight_int4, jqm.quantize_weight_int4)}
DEQUANTIZE = {8: (qm.dequantize_weight, jqm.dequantize_weight),
              4: (qm.dequantize_weight4, jqm.dequantize_weight4)}
MATMUL_TOL = {8: 2e-4, 4: 5e-4}
POOL = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8)


def _half_steps(bits):
    """Columns whose scale is exactly 1 (amax = qmax in row 0) and whose
    other rows sit on half steps, to pin round-half-to-even."""
    qmax = 127.0 if bits == 8 else 7.0
    col = np.array([qmax, 2.5, -2.5, 0.5, -0.5, 1.5, -3.5, 6.5], np.float32)
    w = np.tile(col[:, None], (32, 24))  # 256 rows: two int4 groups
    return w * np.where(np.arange(24) % 2, 1.0, -1.0).astype(np.float32)


def _weight(case, bits):
    rng = np.random.default_rng(7)
    if case == "f32_300x520":
        return rng.standard_normal((300, 520)).astype(np.float32), None
    if case == "bf16_1280x384":
        return rng.standard_normal((1280, 384)).astype(np.float32), "bf16"
    if case == "zero_columns":
        w = rng.standard_normal((384, 200)).astype(np.float32)
        w[:, ::7] = 0.0
        w[:128, 3] = 0.0  # one int4 group of a column all zero
        return w, None
    if case == "half_steps":
        return _half_steps(bits), None
    return rng.standard_normal((3, 192, 136)).astype(np.float32), None  # stacked


def _both(w, kind):
    """The same weight as a JAX array and a torch tensor (bf16 bits equal)."""
    if kind == "bf16":
        jw = jnp.asarray(w).astype(jnp.bfloat16)
        return jw, torch.from_numpy(np.array(jw.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(w), torch.from_numpy(w)


@pytest.mark.parametrize("case", ["f32_300x520", "bf16_1280x384", "zero_columns",
                                  "half_steps", "stacked"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_bit_identical_to_jax(bits, case):
    w, kind = _weight(case, bits)
    jw, tw = _both(w, kind)
    port, ref = QUANTIZE[bits][0](tw), QUANTIZE[bits][1](jw)
    assert (port.in_dim, port.out) == (ref.in_dim, ref.out)
    assert port.values.dtype == torch.int8 and port.scales.dtype == torch.float32
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(port.scales.numpy().view(np.int32),
                                  np.asarray(ref.scales).view(np.int32))
    assert port.shape == tuple(ref.shape)
    port_dq, ref_dq = DEQUANTIZE[bits][0](port), DEQUANTIZE[bits][1](ref)
    np.testing.assert_array_equal(port_dq.numpy(), np.asarray(ref_dq))
    if case == "stacked":  # w[li] is layer li, a view, with the logical widths
        layer = port[1]
        assert layer.values.data_ptr() == port.values[1].data_ptr()
        assert torch.equal(layer.scales, port.scales[1])
        assert (layer.in_dim, layer.out, layer.impl) == (port.in_dim, port.out, port.impl)
    if case == "half_steps":
        np.testing.assert_array_equal(port_dq.numpy()[1:8, 1],
                                      [2.0, -2.0, 0.0, -0.0, 2.0, -4.0, 6.0])


# The shape matrices of the JAX package's own tests (tests/test_quantized_weights.py).
SHAPES = {8: [(8, 128, 256), (3, 300, 520), (1, 64, 130), (513, 1024, 384)],
          4: [(8, 256, 256), (3, 300, 520), (1, 64, 130), (257, 1152, 384)]}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("bits,t,k,n", [(b, *s) for b in (8, 4) for s in SHAPES[b]])
def test_plain_matmul_matches_jax(bits, t, k, n, impl):
    """Both JAX product forms; the port's leaf carries `impl` as JAX's does
    and computes the same product whatever it says."""
    rng = np.random.default_rng(t + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    want = jqm.quantized_matmul(jnp.asarray(x), QUANTIZE[bits][1](jnp.asarray(w), impl=impl))
    qw = dataclasses.replace(QUANTIZE[bits][0](torch.from_numpy(w)), impl=impl)
    got = qm.quantized_matmul(torch.from_numpy(x), qw)
    assert got.shape == (t, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MATMUL_TOL[bits], rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_matmul_bf16_activations_match_jax(bits):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((512, 384)) / np.sqrt(512)).astype(np.float32)
    jx = jnp.asarray(rng.standard_normal((2, 8, 512)).astype(np.float32)).astype(jnp.bfloat16)
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    want = jqm.quantized_matmul(jx, QUANTIZE[bits][1](jnp.asarray(w)))
    got = qm.quantized_matmul(x, QUANTIZE[bits][0](torch.from_numpy(w)))
    assert got.shape == (2, 8, 384) and got.dtype == torch.bfloat16
    # Both round an fp32 sum to bf16 once: at most one bf16 step apart.
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("bits", [8, 4])
def test_fuse_then_quantize_equals_quantize_unfused(bits):
    cfg = tiny_test_config()
    params = init_params(cfg, seed=3, device="cpu")
    fused = fuse_projections(params)
    assert is_fused(fused) and not is_fused(params)
    qf, qu = quantize_params(fused, bits=bits), quantize_params(params, bits=bits)
    for key, parts in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                       ("gate_up_proj", ("gate_proj", "up_proj"))):
        f, c = qf["layers"][key], 0
        for name in parts:
            u = qu["layers"][name]
            assert f.in_dim == u.in_dim and f.values.shape[-2] == u.values.shape[-2]
            torch.testing.assert_close(f.values[..., c:c + u.out], u.values[..., :u.out],
                                       rtol=0, atol=0)
            torch.testing.assert_close(f.scales[..., c:c + u.out], u.scales[..., :u.out],
                                       rtol=0, atol=0)
            c += u.out
        assert c == f.out
    with pytest.raises(ValueError):
        fuse_projections(quantize_params(params, bits=bits))
    with pytest.raises(ValueError):
        fuse_projections(fused)


JAX_TREES = ["int8", "int4", "fused_int4"]


def _jax_tree(jparams, tree):
    if tree == "fused_int4":
        jparams = jax_fuse(jparams)
    return jax_quantize_params(jparams, bits=8 if tree == "int8" else 4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny()
    jparams = jax_init(jcfg, jax.random.key(0))
    trees = {}
    for tree in JAX_TREES:
        jq = _jax_tree(jparams, tree)
        trees[tree] = (jq, params_from_jax(jax.tree.map(np.asarray, jq), device="cpu"))
    return jcfg, tiny_test_config(), trees


def prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("tree", JAX_TREES)
def test_params_from_jax_quantized_forward_matches_jax(tiny, tree):
    jcfg, cfg, trees = tiny
    jq, params = trees[tree]
    cls = qm.QuantizedWeight if tree == "int8" else qm.QuantizedWeight4
    assert all(isinstance(params["layers"][k], cls)
               for k in jq["layers"] if k.endswith("proj"))
    assert isinstance(params["lm_head"], cls)
    ids, tok = prompt(2, 9, seed=4), np.array([[3], [250]], np.int32)
    j_logits, j_cache = jax_forward(jq, jcfg, jnp.asarray(ids), cache=JaxKVCache.create(jcfg, 2, 16),
                                    mode="prefill", interpret=True)
    logits, cache = forward(params, cfg, torch.from_numpy(ids),
                            cache=KVCache.create(cfg, 2, 16, device="cpu"), mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=5e-4, rtol=0)
    j_logits, _ = jax_forward(jq, jcfg, jnp.asarray(tok), cache=j_cache, mode="decode",
                              interpret=True)
    logits, _ = forward(params, cfg, torch.from_numpy(tok), cache=cache, mode="decode")
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=5e-4, rtol=0)


@pytest.mark.parametrize("tree", ["int8", "fused_int4"])
def test_greedy_generate_quantized_token_identical_to_jax(tiny, tree):
    jcfg, cfg, trees = tiny
    jq, params = trees[tree]
    ids = prompt(2, 9, seed=2)
    want = np.asarray(jax_greedy(jq, jcfg, jnp.asarray(ids), 10, interpret=True))
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_fused_int4_token_identical_to_jax(tiny):
    jcfg, cfg, trees = tiny
    jq, params = trees["fused_int4"]
    rng = np.random.default_rng(5)
    prompts = {rid: rng.integers(0, 256, n).tolist() for rid, n in ((1, 9), (2, 13), (3, 5))}
    jeng = JaxServingEngine(jq, jcfg, **POOL, interpret=True)
    eng = ServingEngine(params, cfg, **POOL)
    for e in (jeng, eng):
        for rid, p in prompts.items():
            e.submit(rid, p, 5)
    got = eng.run()
    assert got == jeng.run()
    assert eng.native and not eng.failed


def test_tied_embeddings_keep_a_dense_lm_head():
    jcfg = jax_tiny(tie_word_embeddings=True)
    jq = jax_quantize_params(jax_init(jcfg, jax.random.key(1)), bits=4)
    cfg = tiny_test_config(tie_word_embeddings=True)
    params = quantize_params(init_params(cfg, seed=1, device="cpu"), bits=4)
    assert "lm_head" not in params and "lm_head" not in jq
    assert isinstance(params["embed"], torch.Tensor)
    ported = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    ids = prompt(1, 7, seed=1)
    want, _ = jax_forward(jq, jcfg, jnp.asarray(ids), interpret=True)
    got, _ = forward(ported, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_on_host_and_dequantized_image(bits):
    cfg = tiny_test_config()
    qp = quantize_params_on_host(lambda: init_params(cfg, seed=2, device="cpu"), device="cpu",
                                 bits=bits)
    ref = quantize_params(init_params(cfg, seed=2, device="cpu"), bits=bits)
    for k, v in ref["layers"].items():
        got = qp["layers"][k]
        if isinstance(v, qm.QUANTIZED):
            assert type(got) is type(v) and torch.equal(got.values, v.values)
        else:
            assert torch.equal(got, v)
    dq = dequantize_params(qp, torch.float32)
    stacked = qm.dequantize_weight4 if bits == 4 else qm.dequantize_weight
    for k in ("q_proj", "down_proj"):
        assert dq["layers"][k].shape == (cfg.num_layers,) + tuple(
            init_params(cfg, device="cpu")["layers"][k].shape[1:])
        torch.testing.assert_close(dq["layers"][k], stacked(qp["layers"][k]), rtol=0, atol=0)
    ids = torch.from_numpy(prompt(2, 6, seed=3))
    torch.testing.assert_close(forward(qp, cfg, ids)[0], forward(dq, cfg, ids)[0],
                               rtol=0, atol=5e-4)
    with pytest.raises(IndexError):
        qp["layers"]["q_proj"][0][0]  # one layer is not indexed again


def test_quantize_rejects_unknown_options():
    w = torch.ones(8, 8)
    with pytest.raises(ValueError):
        quantize_params(init_params(tiny_test_config(), device="cpu"), bits=2)
    assert dataclasses.replace(qm.quantize_weight(w), impl="xla").impl == "xla"


# The kernels' plan (`qmm_plan`, pure Python) at every projection of the
# Llama-3-8B int8 and fused int4 trees, at decode rows and T 2048, either
# side of the decode / prefill crossover, and for x rows TMA cannot take.
PLAN_SHAPES = {
    8: {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
        "down": (14336, 4096), "lm_head": (4096, 128256)},
    4: {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096), "lm_head": (4096, 128256)},
}
PLAN_CASES = (
    [(b, k, n, t, True) for b, shapes in PLAN_SHAPES.items() for k, n in shapes.values()
     for t in ((4 if b == 8 else 8), 2048)]
    + [(b, 4096, 4096, t, True) for b in (8, 4) for t in (16, 17, 20, 63, 64, 256)]
    + [(b, 300, 520, t, False) for b in (8, 4) for t in (5, 2048)])


def _padded(bits, k, n):
    """K_pad and N_pad of a quantized [k, n] weight (the packages' rule)."""
    if bits == 8:
        return (qm._round_up(k, min(qm.BLOCK_K, qm._round_up(k, qm.LANES))),
                qm._round_up(n, min(qm.BLOCK_N8, qm._round_up(n, qm.LANES))))
    return (qm._round_up(k, min(qm.BLOCK_K, qm._round_up(k, 2 * qm.GROUP4))),
            qm._round_up(n, min(qm.BLOCK_N, qm._round_up(n, qm.LANES))))


@pytest.mark.parametrize("bits,k,n,t,aligned", PLAN_CASES,
                         ids=[f"int{b}_k{k}_n{n}_t{t}_{'aligned' if a else 'unaligned'}"
                              for b, k, n, t, a in PLAN_CASES])
def test_qmm_plan_splits_cover_k_and_fill_the_card(bits, k, n, t, aligned):
    k_pad, n_pad = _padded(bits, k, n)
    plan = qm.qmm_plan(t, k, n, k_pad, n_pad, bits == 4, aligned)
    # Routes follow T and alignment.
    assert plan.route == ("prefill" if t > qm.DECODE_MAX_T and aligned else "decode")
    # The tiles walk K exactly: int8 the 64-row tiles up to the logical K
    # (the decode design in pairs: its stages), int4 every packed row (its
    # pack blocks interleave the halves).
    if bits == 8 and plan.route == "prefill":
        assert plan.unit == 1 and (plan.tiles - 1) * qm.TILE_ROWS < k <= plan.tiles * qm.TILE_ROWS
    elif bits == 8:
        step = 2 * qm.TILE_ROWS
        assert plan.unit == 2 and (plan.tiles - 2) * qm.TILE_ROWS < k <= plan.tiles * qm.TILE_ROWS
        assert plan.tiles * qm.TILE_ROWS <= k_pad and plan.tiles * qm.TILE_ROWS % step == 0
    else:
        assert plan.unit == 2 and plan.tiles * qm.TILE_ROWS == k_pad // 2
    # The splits cover the tiles once, in order, in whole units (int4: pairs
    # of tiles, so a group's two 64-row halves stay in one split).
    ranges = [plan.split_tiles(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e > b and (e - b) % plan.unit == 0 and b % plan.unit == 0 for b, e in ranges)
    # The grid: decode about one block per SM; prefill one pass over K
    # unless the tiles of y cover fewer than half the SMs.
    base = plan.col_tiles * plan.row_tiles
    wide = plan.route == "decode" and -(-n // qm.TILE_N) > qm.SMS
    assert plan.tile_n == (2 * qm.TILE_N if wide else qm.TILE_N)
    assert plan.col_tiles == -(-n // plan.tile_n)
    rows = qm.DECODE_ROWS if plan.route == "decode" else qm.PREFILL_ROWS
    assert plan.row_tiles == -(-t // rows)
    units = plan.tiles // plan.unit
    if plan.route == "decode":
        if base >= qm.SMS:
            assert plan.splits == 1
        else:
            assert plan.splits == units or qm.SMS // 2 <= plan.blocks <= 3 * qm.SMS // 2
    elif 2 * base >= qm.SMS:
        assert plan.splits == 1
    else:
        assert plan.blocks >= qm.SMS or plan.splits == units


def test_qmm_plan_refuses_what_the_kernels_cannot_run():
    for bits in (8, 4):  # the pads the plan cases use are the quantizers' own
        values = QUANTIZE[bits][0](torch.zeros(300, 520)).values
        assert _padded(bits, 300, 520) == (values.shape[0] * (2 if bits == 4 else 1),
                                           values.shape[1])
    with pytest.raises(ValueError, match="prefill"):
        qm.qmm_plan(2048, 300, 520, 384, 640, False, False, route="prefill")
    with pytest.raises(ValueError, match="splits"):
        qm.qmm_plan(4, 4096, 4096, 4096, 4096, False, True, splits=65)
    with pytest.raises(ValueError, match="splits"):
        qm.qmm_plan(4, 4096, 4096, 4096, 4096, True, True, splits=0)
    forced = qm.qmm_plan(4, 4096, 4096, 4096, 4096, True, True, route="prefill", splits=16)
    assert (forced.route, forced.splits, forced.unit) == ("prefill", 16, 2)
