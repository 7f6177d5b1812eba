"""Weight-only quantization of a parameter dict.

Port of flash_attention_cute_tpu/models/quantize.py. `quantize_params`
replaces every projection (q/k/v/o, the three MLP products, or the fused
qkv_proj / gate_up_proj) and an untied lm_head with an int8
`QuantizedWeight` (bits=8, one scale per output column) or an int4
`QuantizedWeight4` (bits=4, one scale per 128-row group and column),
layer-stacked like the dense weights. Norms and the embedding table (a
gather, not a product) keep their dtype; tied embeddings keep a dense
lm_head, since the table must stay gatherable. `models.layers.dense`
dispatches on the leaf type, so the quantized dict drops into `forward`,
`greedy_generate` and `ServingEngine` unchanged.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.ops.quantized_matmul import (
    QUANTIZED,
    QuantizedWeight4,
    dequantize_weight,
    dequantize_weight4,
    quantize_weight,
    quantize_weight_int4,
)

PROJ_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "qkv_proj", "gate_up_proj",  # the fused layout (models/fuse.py)
)


def quantize_params(params: dict, bits: int = 8) -> dict:
    """New parameter dict with the projections (and an untied lm_head)
    quantized to int8 (bits=8) or packed int4 (bits=4), on the tensors'
    own device."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qf = quantize_weight if bits == 8 else quantize_weight_int4
    layers = dict(params["layers"])
    for k in PROJ_KEYS:
        if k in layers:
            layers[k] = qf(layers[k])
    out = {**params, "layers": layers}
    if params.get("lm_head") is not None:
        out["lm_head"] = qf(params["lm_head"])
    return out


def params_to(params: dict, device) -> dict:
    """Every tensor and quantized leaf of a parameter dict moved to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def quantize_params_on_host(init_fn, device="cuda", bits: int = 8) -> dict:
    """Build and quantize the parameters on the CPU, then move them to
    `device`: the way onto a card for a model whose dense image does not fit
    it. `init_fn()` must build the dense dict on the CPU (for example
    `lambda: init_params(cfg, device="cpu")`); factory calls that name no
    device land there too."""
    with torch.device("cpu"):
        qp = quantize_params(init_fn(), bits=bits)
    return params_to(qp, device)


def dequantize_params(params: dict, dtype=torch.bfloat16) -> dict:
    """The exact dense image of a quantized dict: the parity oracle that
    separates kernel faults from quantization error."""
    def dq(v):
        if not isinstance(v, QUANTIZED):
            return v
        f = dequantize_weight4 if isinstance(v, QuantizedWeight4) else dequantize_weight
        if v.values.ndim == 2:
            return f(v, dtype)
        # One layer at a time: the fp32 working copy stays one layer's size.
        out = torch.empty(tuple(v.values.shape[:-2]) + (v.in_dim, v.out), dtype=dtype,
                          device=v.device)
        for i in range(out.shape[0]):
            out[i] = dq(v[i])
        return out

    out = {**params, "layers": {k: dq(v) for k, v in params["layers"].items()}}
    if isinstance(params.get("lm_head"), QUANTIZED):
        out["lm_head"] = dq(params["lm_head"])
    return out
