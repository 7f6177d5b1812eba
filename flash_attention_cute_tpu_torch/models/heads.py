"""Non-generative task heads over the causal-LM trunk.

Port of the JAX package's `models/heads.py`: thin functional heads over
`transformer.forward(return_hidden=True)`, so every attention kernel and
cache mode of the trunk is shared, with HF's pooling semantics:

* Sequence classification pools each row's LAST non-pad token: with no
  pad_token_id the last position; otherwise `argmax(input_ids == pad) - 1
  (mod S)`, HF's rule, where a row without padding wraps -1 to S - 1.
* Question answering projects every position to (start, end) logits.

Weights convert with `models.convert.head_params_from_state_dict`.
`plain_attention=True` runs the trunk's attention through the kernels'
plain versions whatever the device (the comparison path; the JAX heads'
`interpret`).
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.transformer import forward


def _hidden(params, cfg, input_ids, plain_attention):
    return forward(params, cfg, input_ids, return_hidden=True,
                   plain_attention=plain_attention)[0]


def _last_non_pad(input_ids: torch.Tensor, pad_token_id: int | None) -> torch.Tensor:
    """Each row's last non-pad position [B] by HF's rule."""
    b, s = input_ids.shape
    if pad_token_id is None:
        return torch.full((b,), s - 1, dtype=torch.long, device=input_ids.device)
    is_pad = (input_ids == pad_token_id).to(torch.int32)
    return (is_pad.argmax(dim=-1) - 1) % s


def sequence_classification_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    pad_token_id: int | None = None,
    plain_attention: bool = False,
) -> torch.Tensor:
    """Pooled classification logits [B, num_labels] fp32: the `score` head
    (HF `LlamaForSequenceClassification`, no bias) at each row's last
    non-pad position."""
    hidden = _hidden(params, cfg, input_ids, plain_attention)
    logits = (hidden @ params["score"].to(hidden.dtype)).float()  # [B, S, num_labels]
    idx = _last_non_pad(input_ids, pad_token_id)
    return logits[torch.arange(input_ids.shape[0], device=logits.device), idx]


def token_classification_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    plain_attention: bool = False,
) -> torch.Tensor:
    """Per-position label logits [B, S, num_labels] fp32 (HF
    `LlamaForTokenClassification`: a `score` Linear with bias; its dropout
    is an inference no-op)."""
    hidden = _hidden(params, cfg, input_ids, plain_attention)
    return (hidden @ params["score"].to(hidden.dtype)
            + params["score_bias"].to(hidden.dtype)).float()


def embedding_pooling_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    pooling: str = "mean",  # "mean" | "last" | "cls"
    pad_token_id: int | None = None,
    normalize: bool = True,
    plain_attention: bool = False,
) -> torch.Tensor:
    """Sentence embeddings [B, hidden] fp32 from the trunk: the mean over
    non-pad positions, the last non-pad token, or the first token ("cls"),
    L2-normalized with `normalize`. Right padding is assumed."""
    if pooling not in ("mean", "last", "cls"):
        raise ValueError(f"unknown pooling {pooling!r}")
    hidden = _hidden(params, cfg, input_ids, plain_attention).float()
    b, s = input_ids.shape
    if pad_token_id is None:
        valid = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    else:
        valid = (input_ids != pad_token_id).float()
    if pooling == "mean":
        denom = valid.sum(dim=1, keepdim=True).clamp_min(1.0)
        emb = (hidden * valid[..., None]).sum(dim=1) / denom
    elif pooling == "last":
        emb = hidden[torch.arange(b, device=hidden.device), _last_non_pad(input_ids, pad_token_id)]
    else:
        emb = hidden[:, 0]
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-9)
    return emb


def question_answering_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    plain_attention: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extractive-QA (start_logits, end_logits), each [B, S] fp32 (HF
    `LlamaForQuestionAnswering`: a 2-output `qa_outputs` Linear with bias)."""
    hidden = _hidden(params, cfg, input_ids, plain_attention)
    logits = (hidden @ params["qa_outputs"].to(hidden.dtype)
              + params["qa_outputs_bias"].to(hidden.dtype)).float()  # [B, S, 2]
    return logits[..., 0], logits[..., 1]
