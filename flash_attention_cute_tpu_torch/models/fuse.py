"""Projection fusion: q/k/v into one product and gate/up into another.

Port of flash_attention_cute_tpu/models/fuse.py. Concatenating along the
output axis turns 7 weight streams per layer into 4 (qkv_proj, o_proj,
gate_up_proj, down_proj); each output column sees the same dot product.
Fuse before `models.quantize.quantize_params`: per-column int8 scales and
per-(group, column) int4 scales do not change under an output-axis
concatenation, so quantizing the fused tree gives the same columns as
quantizing each projection. `models.layers` dispatches on the keys, so a
fused tree drops into `forward`, `greedy_generate` and `ServingEngine`.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.ops.quantized_matmul import QUANTIZED


def is_fused(params: dict) -> bool:
    return "qkv_proj" in params["layers"]


def fuse_projections(params: dict) -> dict:
    """New parameter dict with q/k/v and gate/up concatenated along the
    output axis (new tensors; the input is left as it is). Dense trees
    only: fuse first, then quantize."""
    if is_fused(params):
        raise ValueError("the parameters are already fused")
    layers = dict(params["layers"])
    for k in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        if isinstance(layers[k], QUANTIZED):
            raise ValueError(f"{k} is quantized: fuse before quantize_params")
    layers["qkv_proj"] = torch.cat(
        [layers.pop("q_proj"), layers.pop("k_proj"), layers.pop("v_proj")], dim=-1)
    if "q_bias" in layers:
        layers["qkv_bias"] = torch.cat(
            [layers.pop("q_bias"), layers.pop("k_bias"), layers.pop("v_bias")], dim=-1)
    layers["gate_up_proj"] = torch.cat([layers.pop("gate_proj"), layers.pop("up_proj")], dim=-1)
    return {**params, "layers": layers}
