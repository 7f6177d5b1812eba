#!/usr/bin/env python3
"""Device times of the port's attention kernels on one NVIDIA H100, for
comparing two trees of the repository in one call:

    cd <tree> && python3 <this script> [prefill] [decode] [paged] [extends] [backward] [int8] \
        [layouts] [groups] [partials] [copies]

The package is imported from the current directory; the arguments pick
groups of kernels to time (all without any). Llama / Mistral shapes
(Hq 32, Hkv 8, D 128, bf16, causal): P at the Llama-3-8B greedy prefill
(B 4, S 512) and the training step (B 2, S 2048), with its lse where the
tree has `return_lse`; P at Qwen2-7B's 28 / 4 heads (B 4, S 512), at D 64
(B 2, S 1024), non-causal (B 1, S 2048) and ragged (B 2, S 1000); B2 at
Mistral-7B's greedy prefill (B 2, S 5120, window 4096); D1 and B7 (+ D2, the
wrapper's own splits; B7 over int8) at the greedy middle decode steps of
Llama-3-8B (B 4, 544 of 576 positions), Mistral-7B ("W": B 2, 5136 of 5152,
window 4096) and Gemma-2-9B ("G": B 2, 4624 of 4640, 16 / 8 heads, D 256,
cap 50; B7 also over e4m3), each with its "bound" (q read, the output
written, the visible K / V rows and B7's scales read once at 3.35 TB/s, or
4 D operations a visible key and q head at the bf16 peak, whichever is
longer), its "SDPA" yardstick (one SDPA call over a GQA-expanded bf16 copy,
dequantized for B7, with the lengths and the window as a boolean mask,
without the cap) and its "call" time (host overhead included); B5 and
B8 (+ D2) at serving run A's / D's decode (8 rows of 174-923 keys,
page_size 128; B8 over int8), run B's / E's (the same rows at page_size
16; B8 over e4m3), Mistral-7B run M1's ("W": 4 rows of 4200-5000 + 24
keys, page_size 128, window 4096) and Gemma-2-9B run G1's ("G": the same
rows at 16 / 8 heads, D 256, cap 50, every key; B8 over int8), each with
its "bound" (q read, the output written and the visible K / V rows, their
scales and the page-table entries read once at 3.35 TB/s, or 4 D
operations a visible key and q head at the bf16 peak, whichever is longer)
and its "SDPA" yardstick (one SDPA call over a contiguous, GQA-expanded
bf16 copy, dequantized for B8, with the lengths and the window as a
boolean mask, without the cap; the copy not timed);
B4 at a verify round (B 4, S 5, capacity 640; and chip_smoke.py's: capacity
582, q_offset 571), a chunk (B 4, S 256, offsets 0-768, capacity 1100) and
Mistral-7B's window ("W": B 2, S 256, offsets 4608 / 4864, W 4096); B12 over
8 packed causal sequences of 100-2048 tokens and over chip_smoke.py's 32
(35874 tokens); B4 (a verify round and a chunk, capacity 4640) and B12
(the 32 sequences) at Gemma-2-9B's widths with and without the cap 50; B12
over the 32 sequences at Phi-3-mini's widths ("phi3": 32 / 32 heads, D 96
in D 128's layout; null in a tree that refuses D 96).
Every P / B2, B4 and B12 shape also has a "bound" entry: 4 D operations per
visible (row, key) pair and q head at the bf16 peak, or its bytes (q, the
live k / v read once, the output written once) at 3.35 TB/s, whichever is
longer. Gemma-2-9B shapes (Hq 16, Hkv 8, D 256, scale
256 ** -0.5) with and without the soft cap 50, where the tree takes them
(null where it raises NotImplementedError): P at B 2, S 4608; B2 with
window 4096 there. The paged extends B6
(bf16 pages) and B9 (quantized pages), page_size 16, each with its
"bound" (operations as above, or q read, the output written and the live
K / V rows read once): at serving run B's / E's extend (B 8, S 256,
offsets 0-768; B9 over e4m3; B6 also at Gemma's widths, with and without
the cap), at Mistral-7B run M2's extend ("W": B 4, S 512, offsets
3584-4608, window 4096; B9 over e4m3) and at Gemma-2-9B run G2's ("G": the
same rows at Gemma's widths with the cap 50; B9 over int8).
The backward kernels B13a (dK, dV) and B13b (dQ), each launched alone
through `flash_bwd.launch` (causal, bf16, q / k / v / dO contiguous, the
kernel forward's o and lse): at the training step's attention (B 2, S 2048,
32 / 8 heads, D 128), at D 64 (B 2, S 1024), with the window of 4096 at B 1,
S 5120, at Qwen2-7B's 28 / 4 heads (B 1, S 1024), and non-causal at B 1, S
2048 (as many visible pairs as the training shape, in blocks of equal
work), and at the global layer of Gemma-2-9B's training step (B 1, S 4608,
16 / 8 heads, D 256; null in a tree whose backward refuses D 256), and at
Phi-3-mini's training step ("phi3": B 2, S 2040, 32 / 32 heads, D 96 in D
128's layout; null in a tree whose backward refuses D 96). Their
bounds ("bound" entries, the same for every tree): B13a 8 D
and B13b 6 D operations per visible (row, key) pair and q head at the bf16
peak, or their bytes (inputs and outputs once) at 3.35 TB/s, whichever is
longer. int8 scores (where the tree takes `score_dtype`), at chip_smoke.py's
phase 5e shapes (Llama-3-8B B 4 S 512 and B 1 S 8192, Mistral-7B's B 2 S
5120 W 4096, Gemma-2-9B's B 2 S 4608 with the cap 50; causal, transposed
views): "int8 ..." the wrapper's call (K8 + P-i8 / B2-i8), "int8 kernel
..." P-i8 / B2-i8 alone over K8's output, "bf16 ..." P / B2 at the same
inputs, "K8 ..." K8 alone, and "bound int8 ..." (QK^T at the int8 peak
plus PV at the bf16 peak, or the bytes of q, K8's K and scales, v and the
output, whichever is longer). "layouts": QA (quantize-and-append) at run
D's decode (8 rows of one token into int8 pages of 128, 8 kv heads) and
the paged append of run A's decode (the same rows into bf16 pages of 128)
at D 64, 128 and 256, and B7 + D2 (int8, Llama's middle decode step), B8 + D2 (e4m3,
run E's decode at page_size 16), B9 (int8, run E's extend) and B4 (the
smoke's last verify round, and a chunk of 256) and B12 (the 32 sequences,
causal) at D 64 (32 / 8 heads), the head dim of the layout the other groups
do not time them at. "groups": D1, B7, B5 and B8 (+ D2; int8 values) over
8 rows of 2048 keys at GQA groups 16 (128 / 8 heads), 32 (32 / 1), 48 (48
/ 1) and 71 (71 / 1, D 64), null where a tree refuses the group.
"partials": B4 at ring attention's steps (Llama-3.1-8B's 32 / 8 heads, D
128, B 1, a rank's 4096 rows of a 32768-token sequence over 8 ranks): a
non-causal step (4096 keys, q_offset 4096), a zig-zag step (the low stripe
of 2048 keys) and the own pair's two calls (2048 rows against 2048 keys at
q_offset 0, and against 4096 at 2048), each with its (o, m, l) partials
("partials ...", null in a tree that refuses them) and normalised ("B4
..."), with its "bound" (4 D operations a visible (row, key) pair and q
head at the bf16 peak, or q, k, v read and the partials written once at
3.35 TB/s). "copies": the padded copy `_build.rows` makes of a caller's
tensor whose rows break TMA's 16-byte stride rule, at a model's v at D 100
(the projection's [B, S, Hkv, D] transposed: rows of 200 bytes, copied to
a pitch of 104; B 4, 8 kv heads) at a prefill of S 512 and at a decode
step (S 1); null in a tree without `_build.rows`. Prints one JSON line
with the card's name and power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flash_attention_cute_tpu_torch import dispatch  # noqa: E402
from flash_attention_cute_tpu_torch.ops import flash_bwd, flash_chunked, flash_decode, flash_fwd  # noqa: E402
from flash_attention_cute_tpu_torch.ops import flash_varlen  # noqa: E402
from flash_attention_cute_tpu_torch.ops import paged_attention as pa  # noqa: E402
from flash_attention_cute_tpu_torch.ops import quantized as qz  # noqa: E402
from flash_attention_cute_tpu_torch.runtime import paged_cache  # noqa: E402
from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms  # noqa: E402

PEAK_BF16, PEAK_I8, PEAK_BYTES = 989e12, 1979e12, 3.35e12


def visible_pairs(s: int, causal: bool, window: int | None) -> int:
    """(row, key) pairs a head sees at Sq = Skv = s."""
    if not causal:
        return s * s
    w = window or s
    return sum(min(m + 1, w) for m in range(s))


def varlen_batch(count=32):
    """chip_smoke.py's packed batch: numpy-seeded lengths in [100, 2048],
    one of a single token, the total not a multiple of 64."""
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 2049, count)
    lens[5] = 1
    if lens.sum() % 64 == 0:
        lens[-1] -= 1
    return [int(x) for x in lens]


def extends_and_varlen(randn, timed, out):
    """B4 (contiguous extend) and B12 (packed sequences), each with its
    bound."""
    for name, b, s, cap_len, offs, hq, d, w, caps in (
            ("B4 verify B4 S5 C640", 4, 5, 640, [0, 200, 400, 600], 32, 128, None, (None,)),
            ("B4 verify B4 S5 C582 q_offset 571", 4, 5, 582, [571] * 4, 32, 128, None, (None,)),
            ("B4 chunk B4 S256 C1100", 4, 256, 1100, [0, 256, 512, 768], 32, 128, None, (None,)),
            ("B4 W B2 S256 C5152 W4096", 2, 256, 5152, [4608, 4864], 32, 128, 4096, (None,)),
            ("gemma2 B4 verify B2 S5 C4640", 2, 5, 4640, [4600, 4600], 16, 256, None,
             (None, 50.0)),
            ("gemma2 B4 chunk B2 S256 C4640", 2, 256, 4640, [4096, 4352], 16, 256, None,
             (None, 50.0))):
        q = randn(b, s, hq, d).transpose(1, 2)
        kc, vc = randn(b, 8, cap_len, d), randn(b, 8, cap_len, d)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        for cap in caps:
            label = name + (f" cap {cap:g}" if cap else "")
            out[label] = timed(lambda: flash_chunked.flash_attention_chunked(
                q, kc, vc, off, off + s, window=w, **capped(cap)), 20)
        pairs = sum(min(o + r + 1, w or o + r + 1) for o in offs for r in range(s))
        live = sum(min(o + s, (w or o + s) + s - 1) for o in offs)  # keys some row sees
        out[f"bound {name}"] = 1e3 * max(4 * d * hq * pairs / PEAK_BF16,
                                          (2 * 2 * q.numel() + 2 * 2 * 8 * d * live) / PEAK_BYTES)
        del q, kc, vc
    lens = [1800, 100, 2048, 731, 1024, 333, 1500, 600]
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)
    q, k, v = randn(sum(lens), 32, 128), randn(sum(lens), 8, 128), randn(sum(lens), 8, 128)
    out["B12 8 sequences causal"] = timed(lambda: flash_varlen.flash_attention_varlen(
        q, k, v, cu, causal=True), 20)
    lens = varlen_batch()
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    for name, hq, hkv, d, caps in (("B12 32 sequences causal", 32, 8, 128, (None,)),
                                   ("gemma2 B12 32 sequences causal", 16, 8, 256, (None, 50.0)),
                                   ("phi3 B12 D96 32 sequences causal", 32, 32, 96, (None,))):
        q, k, v = randn(sum(lens), hq, d), randn(sum(lens), hkv, d), randn(sum(lens), hkv, d)
        for cap in caps:
            label = name + (f" cap {cap:g}" if cap else "")
            out[label] = timed(lambda: flash_varlen.flash_attention_varlen(
                q, k, v, cu, causal=True, **capped(cap)), 10)
        out[f"bound {name}"] = 1e3 * max(4 * d * hq * pairs / PEAK_BF16,
                                          2 * (2 * q.numel() + 2 * k.numel()) / PEAK_BYTES)
        del q, k, v


def paged_extends(randn, pool, timed, out):
    """B6 and B9 at run B's / E's, M2's ("W") and G2's ("G") extends."""
    for name, b, s, offs, hq, d, w, caps, values in (
            ("B8 S256 ps16", 8, 256, [0, 256, 512, 768] * 2, 32, 128, None, (None,), "e4m3"),
            ("gemma2 B8 S256 ps16", 8, 256, [0, 256, 512, 768] * 2, 16, 256, None, (None, 50.0),
             None),
            ("W B4 S512 ps16 W4096", 4, 512, [3584, 4096, 4096, 4608], 32, 128, 4096, (None,),
             "e4m3"),
            ("G gemma2 B4 S512 ps16", 4, 512, [3584, 4096, 4096, 4608], 16, 256, None, (50.0,),
             "int8")):
        pps = -(-(max(offs) + s) // 16)
        kp, vp, table = pool(b, 16, pps, 8, d)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        q = randn(b, s, hq, d).transpose(1, 2)
        quant = values and tuple(qz.quantize_kv(x, getattr(torch, {"e4m3": "float8_e4m3fn"}.get(
            values, values))) for x in (kp, vp))
        pairs = sum(min(o + r + 1, w or o + r + 1) for o in offs for r in range(s))
        live = sum(min(o + s, (w or o + s) + s - 1) for o in offs)  # keys some row sees
        for cap in caps:
            label = name + (f" cap {cap:g}" if cap else "")
            out["B6 " + label] = timed(lambda: pa.paged_attention_extend(
                q, kp, vp, off, off + s, table, window=w, **capped(cap)), 20)
            if quant:
                out[f"B9 {values} " + label] = timed(lambda: qz.paged_attention_extend_quantized(
                    q, *quant, off, off + s, table, window=w, **capped(cap)), 20)
        io = 2 * 2 * q.numel() + 4 * 2 * b
        for kname, row_bytes in (("B6", 2 * 2 * 8 * d), ("B9", 2 * 8 * (d + 4))):
            out[f"bound {kname} {name}"] = 1e3 * max(4 * d * hq * pairs / PEAK_BF16,
                                                     (io + row_bytes * live) / PEAK_BYTES)
        del kp, vp, quant


def contiguous_decodes(randn, timed, out):
    """D1 and B7 (+ D2) at the greedy decode steps of Llama-3-8B, Mistral-7B
    ("W") and Gemma-2-9B ("G"), each with its bound, its SDPA yardstick and
    its time per call with the host's overhead ("call")."""
    f = torch.nn.functional
    for name, b, hq, cap_len, live, d, w, cap, values in (
            ("Llama B4 C576 L544", 4, 32, 576, 544, 128, None, None, ("int8",)),
            ("W B2 C5152 L5136 W4096", 2, 32, 5152, 5136, 128, 4096, None, ("int8",)),
            ("G gemma2 B2 C4640 L4624", 2, 16, 4640, 4624, 256, None, 50.0,
             ("int8", "float8_e4m3fn"))):
        kc, vc, q = randn(b, 8, cap_len, d), randn(b, 8, cap_len, d), randn(b, hq, 1, d)
        lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
        label = name + (f" cap {cap:g}" if cap else "")
        kw = dict(kv_length=lengths, window=w, **capped(cap))
        runs = {"D1": (lambda: flash_decode.flash_attention_decode(q, kc, vc, **kw), (kc, vc))}
        for vname in values:
            quant = tuple(qz.quantize_kv(x, getattr(torch, vname)) for x in (kc, vc))
            runs[f"B7 {vname}"] = (
                lambda quant=quant: qz.flash_attention_decode_quantized(q, *quant, **kw),
                tuple(qz.dequantize_kv(x, torch.bfloat16) for x in quant))
        pos = torch.arange(cap_len, device="cuda")
        mask = ((pos < live) & (pos >= live - (w or live)))[None, None, None, :]
        visible = min(live, w or live)
        for kname, (fn, dense) in runs.items():
            out[f"{kname} {label} (+ D2)"] = timed(fn, 50)
            try:
                out[f"call {kname} {label} (+ D2)"] = call_time_ms(fn, 50)
            except (NotImplementedError, TypeError):  # a tree that refuses the shape
                out[f"call {kname} {label} (+ D2)"] = None
            kr, vr = (x.repeat_interleave(hq // 8, dim=1) for x in dense)
            out[f"SDPA {kname} {name}"] = timed(lambda: f.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask), 50)
            del kr, vr
            row_bytes = 2 * 2 * d if kname == "D1" else 2 * (d + 4)
            io = 2 * 2 * q.numel() + 4 * b + row_bytes * 8 * b * visible
            out[f"bound {kname} {name}"] = 1e3 * max(4 * d * hq * b * visible / PEAK_BF16,
                                                     io / PEAK_BYTES)
        del kc, vc, runs


def paged_decodes(randn, pool, timed, out):
    """B5 and B8 at run A's / D's, B's / E's, M1's ("W") and G1's ("G")
    decodes, with their bounds and SDPA yardsticks."""
    f = torch.nn.functional
    run_a = [923, 731, 618, 401, 436, 196, 227, 174]  # chip_smoke.serving_requests' first 8, 32 in
    mistral = (np.random.default_rng(0).integers(4200, 5001, 8)[:4] + 24).tolist()  # M1 / G1
    for name, lens_list, ps, hq, d, w, cap, values in (
            ("B8 ps128", run_a, 128, 32, 128, None, None, "int8"),
            ("B8 ps16", run_a, 16, 32, 128, None, None, "float8_e4m3fn"),
            ("W B4 ps128 W4096", mistral, 128, 32, 128, 4096, None, "int8"),
            ("G gemma2 B4 ps128", mistral, 128, 16, 256, None, 50.0, "int8")):
        b, pps = len(lens_list), 5120 // ps if w or cap else 2048 // ps
        kp, vp, table = pool(b, ps, pps, 8, d)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        q = randn(b, hq, 1, d)
        quant = tuple(qz.quantize_kv(x, getattr(torch, values)) for x in (kp, vp))
        label = name + (f" cap {cap:g}" if cap else "")
        out[f"B5 {label} (+ D2)"] = timed(lambda: pa.paged_attention_decode(
            q, kp, vp, lens, table, window=w, **capped(cap)), 50)
        out[f"B8 {values} {label} (+ D2)"] = timed(lambda: qz.paged_attention_decode_quantized(
            q, *quant, lens, table, window=w, **capped(cap)), 50)
        pos = torch.arange(pps * ps, device="cuda")[None, :]
        mask = ((pos < lens[:, None]) & (pos >= lens[:, None] - (w or pps * ps)))[:, None, None]
        for kname, kv in (("B5", (kp, vp)), ("B8", quant)):
            dense = tuple((pa.gather_pages(x, table) if kname == "B5" else
                           qz._gather_dequantized(x, table).bfloat16())
                          .repeat_interleave(hq // 8, dim=1) for x in kv)
            out[f"SDPA {kname} {name}"] = timed(lambda: f.scaled_dot_product_attention(
                q, *dense, attn_mask=mask), 50)
            del dense
        live = sum(min(n, w or n) for n in lens_list)
        io = 2 * 2 * q.numel() + 4 * (b + sum(-(-n // ps) for n in lens_list))
        for kname, row_bytes in (("B5", 2 * 2 * d), ("B8", 2 * (d + 4))):
            out[f"bound {kname} {name}"] = 1e3 * max(4 * d * hq * live / PEAK_BF16,
                                                     (io + 8 * row_bytes * live) / PEAK_BYTES)
        del kp, vp, quant


def layouts(randn, pool, timed, out):
    """QA and the paged append at D 64, 128 and 256, and B7, B8, B9 and B4
    at D 64 (module docstring, "layouts")."""
    run_a = [923, 731, 618, 401, 436, 196, 227, 174]  # chip_smoke.serving_requests' first 8, 32 in
    lens = torch.tensor(run_a, dtype=torch.int32, device="cuda")
    for d in (64, 128, 256):
        kp, vp, table = pool(8, 128, 16, 8, d)
        quant = tuple(qz.quantize_kv(x, torch.int8) for x in (kp, vp))
        nk, nv = (randn(8, 1, 8, d).transpose(1, 2) for _ in "kv")
        active = torch.ones(8, dtype=torch.bool, device="cuda")
        out[f"QA D{d} B8 S1 ps128"] = timed(lambda: qz.quantize_append(
            nk, nv, *quant, lens, table, active), 50)
        out[f"append D{d} B8 S1 ps128"] = timed(lambda: paged_cache.paged_append_layer(
            kp, vp, nk, nv, table, lens, active), 50)
        del kp, vp, quant
    d, hq = 64, 32
    kc, vc, q = randn(4, 8, 576, d), randn(4, 8, 576, d), randn(4, hq, 1, d)
    quant = tuple(qz.quantize_kv(x, torch.int8) for x in (kc, vc))
    lengths = torch.full((4,), 544, dtype=torch.int32, device="cuda")
    out["B7 int8 D64 B4 C576 L544 (+ D2)"] = timed(lambda: qz.flash_attention_decode_quantized(
        q, *quant, kv_length=lengths), 50)
    kp, vp, table = pool(8, 16, 128, 8, d)
    quant = tuple(qz.quantize_kv(x, torch.float8_e4m3fn) for x in (kp, vp))
    q = randn(8, hq, 1, d)
    out["B8 e4m3 D64 B8 ps16 (+ D2)"] = timed(lambda: qz.paged_attention_decode_quantized(
        q, *quant, lens, table), 50)
    quant = tuple(qz.quantize_kv(x, torch.int8) for x in (kp, vp))
    off = torch.tensor([0, 256, 512, 768] * 2, dtype=torch.int32, device="cuda")
    q = randn(8, 256, hq, d).transpose(1, 2)
    out["B9 int8 D64 B8 S256 ps16"] = timed(lambda: qz.paged_attention_extend_quantized(
        q, *quant, off, off + 256, table), 20)
    del kp, vp, quant
    lens = varlen_batch()
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)
    qv, kv, vv = randn(sum(lens), hq, d), randn(sum(lens), 8, d), randn(sum(lens), 8, d)
    out["B12 D64 32 sequences causal"] = timed(lambda: flash_varlen.flash_attention_varlen(
        qv, kv, vv, cu, causal=True), 10)
    del qv, kv, vv
    for name, s, cap_len, offs in (("B4 verify D64 B4 S5 C582 q_offset 571", 5, 582, [571] * 4),
                                   ("B4 chunk D64 B4 S256 C1100", 256, 1100,
                                    [0, 256, 512, 768])):
        q = randn(4, s, hq, d).transpose(1, 2)
        kc, vc = randn(4, 8, cap_len, d), randn(4, 8, cap_len, d)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        out[name] = timed(lambda: flash_chunked.flash_attention_chunked(q, kc, vc, off, off + s),
                          20)
        del q, kc, vc


def large_groups(randn, pool, timed, out):
    """D1, B7 (int8), B5 and B8 (int8) (+ D2) at GQA groups 16 (Llama-3.1-405B's
    128 / 8 heads), 32 (32 / 1), 48 (StarCoder's 48 / 1) and 71 (Falcon-7B's
    71 / 1, D 64): a decode of B 8 over 2048 keys a row (every key live;
    pages of 16). Null in a tree that refuses the group."""
    for name, hq, hkv, d in (("G16 128/8", 128, 8, 128), ("G32 32/1", 32, 1, 128),
                             ("G48 48/1", 48, 1, 128), ("G71 71/1 D64", 71, 1, 64)):
        b, cap_len = 8, 2048
        q = randn(b, hq, 1, d)
        lengths = torch.full((b,), cap_len, dtype=torch.int32, device="cuda")
        kc, vc = randn(b, hkv, cap_len, d), randn(b, hkv, cap_len, d)
        quant = tuple(qz.quantize_kv(x, torch.int8) for x in (kc, vc))
        out[f"D1 {name} B8 C2048 (+ D2)"] = timed(lambda: flash_decode.flash_attention_decode(
            q, kc, vc, kv_length=lengths), 50)
        out[f"B7 int8 {name} B8 C2048 (+ D2)"] = timed(
            lambda: qz.flash_attention_decode_quantized(q, *quant, kv_length=lengths), 50)
        del kc, vc, quant
        kp, vp, table = pool(b, 16, cap_len // 16, hkv, d)
        quant = tuple(qz.quantize_kv(x, torch.int8) for x in (kp, vp))
        out[f"B5 {name} B8 ps16 L2048 (+ D2)"] = timed(lambda: pa.paged_attention_decode(
            q, kp, vp, lengths, table), 50)
        out[f"B8 int8 {name} B8 ps16 L2048 (+ D2)"] = timed(
            lambda: qz.paged_attention_decode_quantized(q, *quant, lengths, table), 50)
        del kp, vp, quant


def ring_partials(randn, timed, out):
    """B4 with and without its partials at ring attention's steps (module
    docstring, "partials")."""
    hq, hkv, d = 32, 8, 128
    for name, rows, keys, offset in (("step non-causal 4096x4096", 4096, 4096, 4096),
                                     ("step zig-zag 4096x2048", 4096, 2048, 4096),
                                     ("own pair diagonal 2048x2048", 2048, 2048, 0),
                                     ("own pair high 2048x4096", 2048, 4096, 2048)):
        q, k, v = randn(1, hq, rows, d), randn(1, hkv, keys, d), randn(1, hkv, keys, d)
        off = torch.full((1,), offset, dtype=torch.int32, device="cuda")
        kvl = torch.full((1,), keys, dtype=torch.int32, device="cuda")
        out[f"partials {name}"] = timed(lambda: flash_chunked.flash_attention_chunked(
            q, k, v, off, kvl, return_partials=True), 20)
        out[f"B4 {name}"] = timed(lambda: flash_chunked.flash_attention_chunked(
            q, k, v, off, kvl), 20)
        pairs = sum(min(keys, r + offset + 1) for r in range(rows))
        nbytes = 2 * (q.numel() + k.numel() + v.numel()) + 4 * q.numel() + 8 * hq * rows
        out[f"bound {name}"] = 1e3 * max(4 * d * hq * pairs / PEAK_BF16, nbytes / PEAK_BYTES)
        del q, k, v


def capped(cap):  # no keyword at all without a cap: older trees lack it
    return {} if cap is None else {"logit_softcap": cap}


def backward_times(randn, timed, out):
    for name, b, hq, s, d, causal, w in (("B2 S2048", 2, 32, 2048, 128, True, None),
                                         ("D64 B2 S1024", 2, 32, 1024, 64, True, None),
                                         ("W4096 B1 S5120", 1, 32, 5120, 128, True, 4096),
                                         ("qwen2 28/4 B1 S1024", 1, 28, 1024, 128, True, None),
                                         ("non-causal B1 S2048", 1, 32, 2048, 128, False, None),
                                         ("gemma2 D256 B1 S4608", 1, 16, 4608, 256, True, None),
                                         ("phi3 D96 B2 S2040", 2, 32, 2040, 96, True, None)):
        hkv = 4 if hq == 28 else 32 if d == 96 else 8
        # A tree whose backward refuses this head dim (D 256 before its
        # layout, D 96 before the head-dim rule: `launch` does not check it).
        if d not in getattr(flash_bwd, "HEAD_DIMS", (d,)):
            out[f"B13a {name}"] = out[f"B13b {name}"] = None
            continue
        q, do = randn(b, hq, s, d), randn(b, hq, s, d)
        k, v = randn(b, hkv, s, d), randn(b, hkv, s, d)
        o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=w, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        pairs = b * hq * visible_pairs(s, causal, w)
        io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * 2 * lse.numel()
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        for kname, kernel, outs, ops, out_bytes in (
                ("B13a", flash_bwd.DKV, (dk, dv), 8, 4 * k.numel()),
                ("B13b", flash_bwd.DQ, (dq, None), 6, 2 * q.numel())):
            label = f"{kname} {name}"
            out[label] = timed(lambda: flash_bwd.launch(kernel, q, k, v, do, lse, delta, *outs,
                                                        d ** -0.5, causal, w or 0), 20)
            out[f"bound {label}"] = 1e3 * max(ops * d * pairs / PEAK_BF16,
                                              (io + out_bytes) / PEAK_BYTES)
        del q, k, v, do, o, lse, delta, dk, dv, dq


def int8_times(randn, timed, out):
    if "score_dtype" not in flash_fwd.flash_attention_fwd.__code__.co_varnames:
        return  # a tree without int8 scores
    for name, b, hq, hkv, s, d, w, cap in (("B4 S512", 4, 32, 8, 512, 128, None, None),
                                           ("B1 S8192", 1, 32, 8, 8192, 128, None, None),
                                           ("B2 S5120 W4096", 2, 32, 8, 5120, 128, 4096, None),
                                           ("gemma2 B2 S4608 cap 50", 2, 16, 8, 4608, 256, None,
                                            50.0)):
        q = randn(b, s, hq, d).transpose(1, 2)
        k, v = randn(b, s, hkv, d).transpose(1, 2), randn(b, s, hkv, d).transpose(1, 2)
        kw = dict(causal=True, window=w, **capped(cap))
        out[f"int8 {name}"] = timed(lambda: flash_fwd.flash_attention_fwd(
            q, k, v, score_dtype="int8", **kw), 20)
        k8, kscale = flash_fwd._quantize_k_padded(k)
        o = torch.empty((b, hq, s, d), dtype=q.dtype, device="cuda")
        softcap = 0.0 if cap is None else cap * 1.4426950408889634
        out[f"int8 kernel {name}"] = timed(lambda: flash_fwd.launch_int8(
            q, k8, kscale, v, o, None, d ** -0.5, True, w or 0, softcap), 20)
        out[f"bf16 {name}"] = timed(lambda: flash_fwd.flash_attention_fwd(q, k, v, **kw), 20)
        out[f"K8 {name}"] = timed(lambda: flash_fwd._quantize_k_padded(k), 20)
        pairs = b * hq * visible_pairs(s, True, w)
        io = 2 * q.numel() + k8.numel() + 4 * kscale.numel() + 2 * v.numel() + 2 * o.numel()
        out[f"bound int8 {name}"] = 1e3 * max(2 * d * pairs / PEAK_I8 + 2 * d * pairs / PEAK_BF16,
                                               io / PEAK_BYTES)
        del q, k, v, k8, kscale, o


def copy_times(randn, timed, out):
    """The padded copy `_build.rows` makes of a caller's tensor whose rows
    break TMA's 16-byte stride rule (module docstring, "copies")."""
    from flash_attention_cute_tpu_torch.ops import _build

    for s in (512, 1):
        v = randn(4, s, 8, 100).transpose(1, 2)  # the projection's view: rows of 200 bytes
        out[f"copy v D100 B4 S{s}"] = (timed(lambda: _build.rows("v", v), 50)
                                       if hasattr(_build, "rows") else None)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def pool(b, ps, pps, hkv, d):
        num_pages = b * pps + 1
        table = (torch.randperm(num_pages - 1, generator=gen, device="cuda")[: b * pps] + 1)
        return (randn(hkv, num_pages, ps, d), randn(hkv, num_pages, ps, d),
                table.view(b, pps).to(torch.int32).contiguous())

    def timed(fn, iters):
        try:
            return cuda_time_ms(fn, iters)
        except (NotImplementedError, TypeError):  # a tree without the cap or D 256
            return None

    # Groups to time (all by default): prefill, decode, paged, extends,
    # backward, int8, layouts, groups, partials, copies.
    groups = set(sys.argv[1:]) or {"prefill", "decode", "paged", "extends", "backward", "int8",
                                   "layouts", "groups", "partials", "copies"}
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "tree": os.getcwd()}
    lse = "return_lse" in flash_fwd.flash_attention_fwd.__code__.co_varnames
    for name, b, hq, hkv, s, d, causal, w in () if "prefill" not in groups else (
            ("P B4 S512", 4, 32, 8, 512, 128, True, None),
            ("P B2 S2048", 2, 32, 8, 2048, 128, True, None),
            ("P qwen2 28/4 B4 S512", 4, 28, 4, 512, 128, True, None),
            ("P D64 B2 S1024", 2, 32, 8, 1024, 64, True, None),
            ("P non-causal B1 S2048", 1, 32, 8, 2048, 128, False, None),
            ("P ragged B2 S1000", 2, 32, 8, 1000, 128, True, None),
            ("B2 B2 S5120 W4096", 2, 32, 8, 5120, 128, True, 4096),
            ("gemma2 P B2 S4608", 2, 16, 8, 4608, 256, True, None),
            ("gemma2 B2 B2 S4608 W4096", 2, 16, 8, 4608, 256, True, 4096)):
        q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        caps = (None, 50.0) if d == 256 else (None,)
        for cap in caps:
            label = name + (f" cap {cap:g}" if cap else "")
            out[label] = timed(lambda: flash_fwd.flash_attention_fwd(
                q, k, v, causal=causal, window=w, **capped(cap)), 20)
        if lse and name in ("P B4 S512", "P B2 S2048"):
            out[name + " with lse"] = timed(lambda: flash_fwd.flash_attention_fwd(
                q, k, v, causal=True, return_lse=True), 20)
        io = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read, the output written
        out[f"bound {name}"] = 1e3 * max(4 * d * b * hq * visible_pairs(s, causal, w) / PEAK_BF16,
                                          io / PEAK_BYTES)
        del q, k, v

    if "decode" in groups:
        contiguous_decodes(randn, timed, out)
        paged_decodes(randn, pool, timed, out)
    if "paged" in groups:
        paged_extends(randn, pool, timed, out)
    if "extends" in groups:
        extends_and_varlen(randn, timed, out)
    if "backward" in groups:
        backward_times(randn, timed, out)
    if "int8" in groups:
        int8_times(randn, timed, out)
    if "layouts" in groups:
        layouts(randn, pool, timed, out)
    if "groups" in groups:
        large_groups(randn, pool, timed, out)
    if "partials" in groups:
        ring_partials(randn, timed, out)
    if "copies" in groups:
        copy_times(randn, timed, out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
