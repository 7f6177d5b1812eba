"""The port's HF surface against the JAX package's, on the CPU.

`interop.torch_patch` (the port's custom op
`flash_attention_cute_tpu_torch::forward` in HF Llama / Qwen2 attention),
the HF state-dict converters and `load_hf_model`, the task heads,
`forward(return_hidden=True)`, `init_params_host` and
`KVCache.update_layer` / `advance`, each held to its JAX counterpart on the
same inputs. HF models are tiny, random-weight and built in process (a
checkpoint is `save_pretrained` into `tmp_path`); nothing is downloaded.
CPU tensors take the kernels' plain versions.

Tolerances: fp32 logits of the port-patched and the JAX-patched model at
atol 1e-5 (the same attention in other summation orders), of a patched
and the unpatched eager model at atol 2e-4 / rtol 2e-3 (the JAX patch's
own test); heads and hidden states 1e-5; tokens, converted parameters,
`init_params_host` and cache contents exactly (bf16 compared bit for
bit). Every patch of an HF class is undone in a `finally`.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from transformers.models.llama import modeling_llama
from transformers.models.qwen2 import modeling_qwen2

from flash_attention_cute_tpu.interop import torch_patch as jax_patch
from flash_attention_cute_tpu.models import convert as jax_convert
from flash_attention_cute_tpu.models import heads as jax_heads
from flash_attention_cute_tpu.models.cache import KVCache as JaxKVCache
from flash_attention_cute_tpu.models.config import tiny_test_config as jax_tiny
from flash_attention_cute_tpu.models.gemma2 import gemma2_config_from_hf as jax_gemma2_hf
from flash_attention_cute_tpu.models.llama import llama_config_from_hf as jax_llama_hf
from flash_attention_cute_tpu.models.mistral import mistral_config_from_hf as jax_mistral_hf
from flash_attention_cute_tpu.models.qwen2 import qwen2_config_from_hf as jax_qwen2_hf
from flash_attention_cute_tpu.models.transformer import forward as jax_forward
from flash_attention_cute_tpu.models.transformer import init_params as jax_init
from flash_attention_cute_tpu.models.transformer import init_params_host as jax_init_host
from flash_attention_cute_tpu.runtime.generate import greedy_generate as jax_greedy
from flash_attention_cute_tpu_torch import models
from flash_attention_cute_tpu_torch.interop import torch_patch
from flash_attention_cute_tpu_torch.models import heads
from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.convert import (
    head_params_from_state_dict,
    load_hf_model,
    params_from_jax,
    params_from_state_dict,
)
from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_config_from_hf
from flash_attention_cute_tpu_torch.models.llama import llama_config_from_hf
from flash_attention_cute_tpu_torch.models.mistral import mistral_config_from_hf
from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_config_from_hf
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params_host
from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

ATTENTION = {"llama": modeling_llama.LlamaAttention, "qwen2": modeling_qwen2.Qwen2Attention}


@contextlib.contextmanager
def patched(cls, fwd):
    """cls.forward = fwd inside the block, the original restored after."""
    orig = cls.forward
    cls.forward = fwd
    try:
        yield
    finally:
        cls.forward = orig


def run_three_ways(model, family, fn):
    """fn() on the unpatched model, under the JAX patch and under the port's."""
    cls = ATTENTION[family]
    with torch.no_grad():
        eager = fn()
        with patched(cls, jax_patch.attention_forward):
            jax_out = fn()
        with patched(cls, torch_patch.attention_forward):
            port = fn()
    return eager, jax_out, port


def tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        attn_implementation="eager")
    torch.manual_seed(0)
    with torch.device("cpu"):
        return transformers.LlamaForCausalLM(cfg).eval()


def tiny_qwen2(window=None):
    kw = dict(use_sliding_window=True, sliding_window=window, max_window_layers=1) if window else {}
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        attn_implementation="eager", **kw)
    torch.manual_seed(1)
    with torch.device("cpu"):
        model = transformers.Qwen2ForCausalLM(cfg).eval()
    for name, p in model.named_parameters():  # non-zero q/k/v biases
        if name.endswith("_proj.bias"):
            torch.nn.init.normal_(p, std=0.5)
    return model


def test_patched_llama_logits_match_jax_patch_and_eager():
    model = tiny_llama()
    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11, 4], [8, 6, 4, 2, 1, 3, 5, 7]])
    eager, jax_out, port = run_three_ways(model, "llama", lambda: model(ids).logits.float())
    np.testing.assert_allclose(port.numpy(), jax_out.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.numpy(), eager.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("window", [None, 4])
def test_patched_qwen2_generate_matches_jax_patch(window):
    """Greedy `generate` (a prefill, then decode steps over HF's growing
    cache) gives the JAX patch's tokens; with a window of 4 on layer 1 of 2
    (`max_window_layers` 1), shorter than the prompt."""
    model = tiny_qwen2(window)
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    assert ids.shape[1] > (window or 0)
    gen = lambda: model.generate(ids, max_new_tokens=8, do_sample=False, pad_token_id=0)  # noqa: E731
    eager, jax_out, port = run_three_ways(model, "qwen2", gen)
    np.testing.assert_array_equal(port.numpy(), jax_out.numpy())
    if window is None:
        np.testing.assert_array_equal(port.numpy(), eager.numpy())


def test_patched_llama_right_padded_batch_matches_jax_patch():
    model = tiny_llama()
    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11, 4], [6, 2, 8, 3, 0, 0, 0, 0],
                        [9, 0, 0, 0, 0, 0, 0, 0]])
    mask = (torch.arange(8)[None, :] < torch.tensor([8, 4, 1])[:, None]).long()
    eager, jax_out, port = run_three_ways(
        model, "llama", lambda: model(ids, attention_mask=mask).logits.float())
    for row, n in enumerate((8, 4, 1)):  # pad positions are garbage either way
        np.testing.assert_allclose(port[row, :n].numpy(), jax_out[row, :n].numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(port[row, :n].numpy(), eager[row, :n].numpy(), atol=2e-4,
                                   rtol=2e-3)


def test_patched_llama_left_padding_raises():
    model = tiny_llama()
    ids = torch.tensor([[0, 0, 0, 6, 2, 8, 3, 9]])
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1]])
    with patched(ATTENTION["llama"], torch_patch.attention_forward), torch.no_grad():
        with pytest.raises(NotImplementedError, match="RIGHT-padded"):
            model(ids, attention_mask=mask)


def masks_2d():
    ar = torch.arange(8)[None, :]
    return {
        "unpadded": torch.ones(3, 8, dtype=torch.long),
        "right-padded": (ar < torch.tensor([8, 5, 1])[:, None]).long(),
        "left-padded": (ar >= torch.tensor([0, 3, 7])[:, None]).long(),
        "arbitrary": torch.tensor([[1, 1, 0, 1, 1, 1, 1, 1]] * 3),
        "zero-length": (ar < torch.tensor([8, 0, 3])[:, None]).long(),
    }


def additive_4d(valid):
    """HF's processed [B, 1, S, S] mask whose last row is `valid`, causal above."""
    b, s = valid.shape
    keep = torch.tril(torch.ones(s, s, dtype=torch.bool))[None] & valid[:, None, :].bool()
    neg = torch.finfo(torch.float32).min
    return torch.where(keep, 0.0, neg)[:, None]


@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("case", list(masks_2d()))
def test_padding_kv_lengths_matches_jax(case, rank):
    """Unpadded -> None, right-padded -> JAX's lengths as a contiguous int32
    [B] tensor on the mask's device; left-padded, arbitrary and zero-length
    masks raise NotImplementedError as JAX's do."""
    mask = masks_2d()[case]
    if rank == 4:
        mask = additive_4d(mask)

    def call(fn):
        try:
            return fn(mask, 8, None)
        except NotImplementedError as e:
            return e

    want, got = call(jax_patch._padding_kv_lengths), call(torch_patch._padding_kv_lengths)
    if isinstance(want, NotImplementedError):
        assert isinstance(got, NotImplementedError), got
        if case == "zero-length":
            assert "length 0" in str(got)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == torch.int32 and got.is_contiguous() and got.device == mask.device
        assert got.tolist() == want.tolist()


def test_padding_kv_lengths_window_mask_is_unpadded():
    """A sliding-window causal mask without padding needs no lengths: the
    kernels apply the window; the same mask without the window is refused."""
    s, w = 8, 3
    i = torch.arange(s)
    keep = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
    mask = torch.where(keep, 0.0, torch.finfo(torch.float32).min)[None, None].expand(2, 1, s, s)
    assert torch_patch._padding_kv_lengths(mask, s, w) is None
    assert jax_patch._padding_kv_lengths(mask, s, w) is None
    with pytest.raises(NotImplementedError):
        torch_patch._padding_kv_lengths(mask, s, None)


def op_samples():
    g = torch.Generator().manual_seed(0)
    qkv = lambda sq, skv: (torch.randn(2, 4, sq, 16, generator=g),  # noqa: E731
                           torch.randn(2, 2, skv, 16, generator=g),
                           torch.randn(2, 2, skv, 16, generator=g))
    lengths = torch.tensor([7, 3], dtype=torch.int32)
    return {"prefill": (*qkv(7, 7), 0.25, True, 0, None),
            "window": (*qkv(7, 7), 0.25, True, 3, None),
            "right-padded": (*qkv(7, 7), 0.25, True, 0, lengths),
            "decode": (*qkv(1, 9), 0.25, True, 0, lengths + 2)}


@pytest.mark.parametrize("case", list(op_samples()))
def test_custom_op_matches_jax_op_and_passes_opcheck(case):
    """The port's op and the JAX op register side by side in one process,
    agree on each route, and the port's passes `torch.library.opcheck`
    (schema, fake kernel, autograd registration, AOT dispatch)."""
    args = op_samples()[case]
    got = torch_patch._get_custom_op()(*args)
    want = jax_patch._get_custom_op()(*args)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.ops.flash_attention_cute_tpu_torch.forward is not None
    assert torch.ops.flash_attention_cute_tpu.forward is not None
    torch.library.opcheck(torch.ops.flash_attention_cute_tpu_torch.forward.default, args)


def test_custom_op_fake_kernel_traces():
    """Under FakeTensorMode the op returns a contiguous fake of q's shape and
    dtype without running attention, also for a transposed q."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch_patch._get_custom_op()
    with FakeTensorMode():
        q = torch.empty(1, 8, 4, 64).transpose(1, 2)
        k = torch.empty(1, 2, 8, 64)
        o = op(q, k, k, 0.125, True, 0)
        assert o.shape == q.shape and o.dtype == q.dtype and o.is_contiguous()


def test_patched_llama_torch_compile():
    """The patched model runs under torch.compile (inductor) and gives the
    eager patched logits."""
    model = tiny_llama()
    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11, 4]])
    with patched(ATTENTION["llama"], torch_patch.attention_forward), torch.no_grad():
        want = model(ids).logits
        torch._dynamo.reset()
        got = torch.compile(model, dynamic=False)(ids).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-3)


# --- conversion -----------------------------------------------------------

def hf_family(name, tied=False):
    """(HF model class, config, the port's and JAX's config mappings)."""
    common = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                  tie_word_embeddings=tied)
    if name == "llama":
        return (transformers.LlamaForCausalLM, transformers.LlamaConfig(**common),
                llama_config_from_hf, jax_llama_hf)
    if name == "qwen2":
        return (transformers.Qwen2ForCausalLM,
                transformers.Qwen2Config(**common, use_sliding_window=True, sliding_window=4,
                                         max_window_layers=1),
                qwen2_config_from_hf, jax_qwen2_hf)
    if name == "mistral":
        return (transformers.MistralForCausalLM,
                transformers.MistralConfig(**common, sliding_window=4),
                mistral_config_from_hf, jax_mistral_hf)
    common.update(head_dim=8, tie_word_embeddings=True, sliding_window=4,
                  query_pre_attn_scalar=8, hidden_activation="gelu_pytorch_tanh")
    return (transformers.Gemma2ForCausalLM, transformers.Gemma2Config(**common),
            gemma2_config_from_hf, jax_gemma2_hf)


def random_state_dict(name, tied=False, seed=0):
    """An HF state dict of the family with every value random (norms and
    biases too), plus the three task heads' weights."""
    cls, hf_cfg, port_map, jax_map = hf_family(name, tied)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in cls(hf_cfg).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    e = hf_cfg.hidden_size
    sd.update({"score.weight": torch.randn(3, e, generator=g),
               "score.bias": torch.randn(3, generator=g),
               "qa_outputs.weight": torch.randn(2, e, generator=g),
               "qa_outputs.bias": torch.randn(2, generator=g)})
    return sd, hf_cfg, port_map, jax_map


def as_numpy(t):
    """A port tensor as numpy; bf16 as its raw bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jax_as_numpy(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(port, want):
    assert set(port) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            assert_trees_equal(port[key], want[key])
        else:
            assert tuple(port[key].shape) == tuple(np.shape(want[key])), key
            np.testing.assert_array_equal(as_numpy(port[key]), jax_as_numpy(want[key]), key)


FAMILIES = [("llama", False), ("llama", True), ("qwen2", False), ("mistral", False),
            ("gemma2", True)]


@pytest.mark.parametrize("with_lm_head", [True, False])
@pytest.mark.parametrize("name,tied", FAMILIES)
def test_params_from_state_dict_equals_jax(name, tied, with_lm_head):
    """Every leaf equal to JAX's in bf16 bit for bit (the cast from fp32,
    Gemma's +1 added in fp32 first) and in fp32, from torch tensors and
    from numpy arrays."""
    sd, hf_cfg, port_map, jax_map = random_state_dict(name, tied)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        cfg, jcfg = port_map(hf_cfg, dtype=dtype), jax_map(hf_cfg, dtype=jdtype)
        want = jax_convert.params_from_state_dict(sd, jcfg, with_lm_head=with_lm_head)
        got = params_from_state_dict(sd, cfg, with_lm_head=with_lm_head, device="cpu")
        assert_trees_equal(got, want)
        assert ("lm_head" in got) == (with_lm_head and not tied)
    got = params_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg, device="cpu")
    assert_trees_equal(got, jax_convert.params_from_state_dict(sd, jcfg))


@pytest.mark.parametrize("head", ["sequence_classification", "token_classification",
                                  "question_answering"])
@pytest.mark.parametrize("name", ["llama", "qwen2"])
def test_head_params_from_state_dict_equals_jax(name, head):
    sd, hf_cfg, port_map, jax_map = random_state_dict(name)
    want = jax_convert.head_params_from_state_dict(sd, jax_map(hf_cfg, dtype=jnp.bfloat16), head)
    got = head_params_from_state_dict(sd, port_map(hf_cfg), head, device="cpu")
    assert_trees_equal(got, want)
    with pytest.raises(ValueError):
        head_params_from_state_dict(sd, port_map(hf_cfg), "masked_lm", device="cpu")


def config_fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = None
    return d


@pytest.mark.parametrize("name", ["llama", "gemma2"])
def test_load_hf_model_equals_jax_and_generates_its_tokens(name, tmp_path):
    """A `save_pretrained` checkpoint: the same config and parameters as
    JAX's `load_hf_model` (bf16, bit for bit), then in fp32 greedy tokens
    identical to JAX `greedy_generate` on the JAX-loaded parameters."""
    cls, hf_cfg, _, _ = hf_family(name)
    torch.manual_seed(5)
    with torch.device("cpu"):
        model = cls(hf_cfg).eval()
    for key, p in model.named_parameters():  # HF initialises Gemma's norms to 0
        if key.endswith("norm.weight"):
            torch.nn.init.normal_(p, std=0.3)
    model.save_pretrained(tmp_path)
    del model
    cfg, params = load_hf_model(str(tmp_path), device="cpu")
    jcfg, jparams = jax_convert.load_hf_model(str(tmp_path))
    assert config_fields(cfg) == config_fields(jcfg) and cfg.dtype == torch.bfloat16
    assert_trees_equal(params, jparams)

    cfg, params = load_hf_model(str(tmp_path), dtype=torch.float32, device="cpu")
    jcfg, jparams = jax_convert.load_hf_model(str(tmp_path), dtype=jnp.float32)
    ids = np.random.default_rng(3).integers(0, hf_cfg.vocab_size, (2, 7)).astype(np.int32)
    got = greedy_generate(params, cfg, torch.from_numpy(ids), 6, cache_capacity=16)
    want = jax_greedy(jparams, jcfg, jnp.asarray(ids), 6, cache_capacity=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="local"):
        load_hf_model(str(tmp_path / "absent"), device="cpu")


def test_new_entry_points_default_to_cuda():
    import inspect

    for fn in (init_params_host, params_from_state_dict, head_params_from_state_dict,
               load_hf_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# --- heads, the hidden state, init_params_host, the cache -----------------

@pytest.fixture(scope="module")
def tiny_heads():
    """Tiny fp32 trunk from JAX's init_params, with random head weights of
    std fan_in ** -0.5 (the trunk's projections' scale), in both packages."""
    jcfg = jax_tiny()
    rng = np.random.default_rng(11)
    jparams = dict(jax_init(jcfg, jax.random.key(0)))
    e = jcfg.hidden_size
    for key, shape in (("score", (e, 3)), ("score_bias", (3,)), ("qa_outputs", (e, 2)),
                       ("qa_outputs_bias", (2,))):
        jparams[key] = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * e ** -0.5)
    np_params = jax.tree.map(np.asarray, jparams)
    params = {k: v for k, v in np_params.items() if k not in ("score", "score_bias",
                                                              "qa_outputs", "qa_outputs_bias")}
    params = params_from_jax(params, device="cpu")
    for key in ("score", "score_bias", "qa_outputs", "qa_outputs_bias"):
        params[key] = torch.from_numpy(np.array(np_params[key]))
    pad = 0
    ids = np.random.default_rng(12).integers(1, 256, (4, 9)).astype(np.int32)
    ids[1, 6:] = pad  # pad-pooled rows, right padding
    ids[2, 1:] = pad
    ids[3, 0] = pad  # a pad first: HF's rule wraps -1 to the last position
    return jcfg, jparams, tiny_test_config(), params, ids, pad


def test_sequence_and_token_classification_heads_match_jax(tiny_heads):
    jcfg, jparams, cfg, params, ids, pad = tiny_heads
    for pad_id in (pad, None):
        want = jax_heads.sequence_classification_forward(jparams, jcfg, jnp.asarray(ids), pad_id)
        got = heads.sequence_classification_forward(params, cfg, torch.from_numpy(ids), pad_id)
        assert got.dtype == torch.float32 and got.shape == (4, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want = jax_heads.token_classification_forward(jparams, jcfg, jnp.asarray(ids))
    got = heads.token_classification_forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert models.sequence_classification_forward is heads.sequence_classification_forward


@pytest.mark.parametrize("pooling", ["mean", "last", "cls"])
def test_embedding_pooling_matches_jax(tiny_heads, pooling):
    jcfg, jparams, cfg, params, ids, pad = tiny_heads
    for pad_id, normalize in ((pad, True), (None, False)):
        want = jax_heads.embedding_pooling_forward(jparams, jcfg, jnp.asarray(ids), pooling,
                                                   pad_id, normalize)
        got = heads.embedding_pooling_forward(params, cfg, torch.from_numpy(ids), pooling,
                                              pad_id, normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_question_answering_head_matches_jax(tiny_heads):
    jcfg, jparams, cfg, params, ids, _ = tiny_heads
    want = jax_heads.question_answering_forward(jparams, jcfg, jnp.asarray(ids))
    got = heads.question_answering_forward(params, cfg, torch.from_numpy(ids))
    for a, b in zip(got, want):
        assert a.shape == (4, 9)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_forward_return_hidden_matches_jax(tiny_heads):
    """The final-norm hidden state in prefill (with and without a cache) and
    decode modes."""
    jcfg, jparams, cfg, params, ids, _ = tiny_heads
    want, jcache = jax_forward(jparams, jcfg, jnp.asarray(ids), return_hidden=True)
    got, cache = forward(params, cfg, torch.from_numpy(ids), return_hidden=True)
    assert cache is None and got.shape == (4, 9, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want, jcache = jax_forward(jparams, jcfg, jnp.asarray(ids),
                               cache=JaxKVCache.create(jcfg, 4, 12), return_hidden=True)
    got, cache = forward(params, cfg, torch.from_numpy(ids),
                         cache=KVCache.create(cfg, 4, 12, device="cpu"), return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    tok = ids[:, :1]
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(tok), cache=jcache, mode="decode",
                          return_hidden=True)
    got, cache = forward(params, cfg, torch.from_numpy(tok), cache=cache, mode="decode",
                         return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert cache.lengths.tolist() == [10] * 4


@pytest.mark.parametrize("overrides", [
    {}, {"dtype": "bfloat16"},
    {"dtype": "bfloat16", "attention_bias": True, "tie_word_embeddings": True},
    {"sandwich_norms": True},
])
def test_init_params_host_equals_jax_bit_for_bit(overrides):
    overrides = dict(overrides)
    dt = overrides.pop("dtype", None)
    jcfg = jax_tiny(**overrides, **({"dtype": jnp.bfloat16} if dt else {}))
    cfg = tiny_test_config(**overrides, **({"dtype": torch.bfloat16} if dt else {}))
    got = init_params_host(cfg, seed=3, device="cpu")
    assert_trees_equal(got, jax_init_host(jcfg, 3))


def test_kv_cache_update_layer_and_advance_match_jax():
    """Writes at each row's length (a start past C - S clamped, as JAX's
    dynamic_update_slice), lengths advanced by an int and by a [B] array."""
    jcfg, cfg = jax_tiny(), tiny_test_config()
    rng = np.random.default_rng(4)
    jcache = JaxKVCache.create(jcfg, 3, 10)
    cache = KVCache.create(cfg, 3, 10, device="cpu")
    cache.k.zero_()
    cache.v.zero_()
    for layer, s, step in ((0, 4, 4), (1, 4, np.array([1, 3, 5], np.int32)), (0, 3, 2)):
        k = rng.standard_normal((3, cfg.num_kv_heads, s, cfg.head_dim), dtype=np.float32)
        v = rng.standard_normal(k.shape, dtype=np.float32)
        jcache = jcache.update_layer(layer, jnp.asarray(k), jnp.asarray(v)).advance(
            jnp.asarray(step))
        same = cache.update_layer(layer, torch.from_numpy(k), torch.from_numpy(v))
        assert same is cache
        cache = cache.advance(torch.as_tensor(step))
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
        assert cache.lengths.tolist() == np.asarray(jcache.lengths).tolist()
    assert cache.lengths.tolist() == [7, 9, 11]  # the last write's start 9 clamped to 7
