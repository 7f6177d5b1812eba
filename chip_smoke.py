#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flash_attention_cute_tpu_torch) on
one NVIDIA Hopper card.

    python3 chip_smoke.py              # full Llama-3-8B depth
    python3 chip_smoke.py --layers 4   # depth cut (printed), widths unchanged

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card of compute capability 9.0; its name and power limit.
  2. build: every kernel of the main path from csrc/ (one nvcc per source,
     all at once), with the ptxas register / shared-memory / spill report.
  3. kernels vs plain: P, D1 and D2 at Llama-3-8B attention widths against
     their plain PyTorch versions on the card (bf16; tolerance below).
  4. main path: greedy generation of Llama-3-8B (random weights from a
     seeded CUDA generator) at B 4, prompt 512, 64 new tokens; launch
     counters show the kernels carried it; teacher-forced logits of the
     kernel path agree with the plain-attention path.
  5. numbers: per-kernel times, bounds and library times as one JSON line;
     prefill and decode times; peak memory; the card's name and power limit.
The last line is {"ok": true, "device": {...}}.

Tolerances: kernel outputs are bf16 results of fp32 arithmetic on bf16
inputs, held against the fp32 plain version at max |diff| <= 3e-2 (the
repository's bf16 figure). Teacher-forced logits of the kernel path and
the plain-attention path: max |diff| <= 1.0 and mean |diff| <= 0.1. The
logits have std about 1 with these weights, so a wrong kernel moves them by
O(1) on average; the two paths differ only by bf16 roundings (P rounded
to bf16 before PV) compounded over 32 layers, which stay an order of
magnitude below that (0.008 mean at 2 layers on an H100).

Kernel times ("ms") are device times from CUDA events with the host's
launch overhead hidden; "call_ms" is the time per call of back-to-back
calls, host overhead included (utils/timing.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 3e-2
LOGIT_MAX_TOL, LOGIT_MEAN_TOL = 1.0, 0.1
# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
B, PROMPT, NEW, CAPACITY = 4, 512, 64, 576


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_kernels(torch, flash_fwd, flash_decode, errs):
    """P, D1, D2 against their plain versions (Hq 32, Hkv 8, D 128, bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for name, (b, sq, skv) in {
        "B2 S1024 causal": (2, 1024, 1024),
        "S1000 ragged": (1, 1000, 1000),
        "Sq256 Skv1024 offset": (1, 256, 1024),
        "Sq1024 Skv256 zero rows": (1, 1024, 256),
        "B4 S512 main path": (4, 512, 512),
    }.items():
        q, k, v = randn(b, 32, sq, 128), randn(b, 8, skv, 128), randn(b, 8, skv, 128)
        out = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
        ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True)
        e = max_err(out, ref)
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), e)
        print(f"  P {name}: max|diff| {e:.3e}")
        check(e <= BF16_TOL, f"P {name} within {BF16_TOL}")
        if sq > skv:
            check(bool((out[:, :, : sq - skv] == 0).all()), "P rows with no key are 0")

    lens = [576, 513, 37, 0]
    kc, vc = randn(4, 4, 8, 576, 128), randn(4, 4, 8, 576, 128)
    for i, n in enumerate(lens):  # uninitialised cache tail
        kc[:, i, :, n:] = float("nan")
        vc[:, i, :, n:] = float("nan")
    q = randn(4, 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5
    for splits in (5, 2):
        acc, m, l = flash_decode.decode_partials(q, kc[2], vc[2], lengths, scale, splits)
        ref = flash_decode.decode_partials_plain(q, kc[2], vc[2], lengths, scale, splits)
        e1 = max(max_err(x, y) for x, y in zip((acc, m, l), ref))
        o = flash_decode.decode_combine(acc, m, l, torch.bfloat16)
        e2 = max_err(o, flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16))
        out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths,
                                                  num_splits=splits, layer=2)
        e12 = max_err(out, flash_decode.flash_attention_decode_plain(
            q, kc, vc, kv_length=lengths, num_splits=splits, layer=2))
        errs["decode_partials"] = max(errs.get("decode_partials", 0.0), e1)
        errs["decode_combine"] = max(errs.get("decode_combine", 0.0), e2)
        print(f"  D1 splits {splits}: partials max|diff| {e1:.3e}; D2 {e2:.3e}; "
              f"D1+D2 vs fp32 plain {e12:.3e}")
        check(e1 <= 1e-2, "D1 partials (fp32 sums of the same inputs) within 1e-2")
        check(e2 <= BF16_TOL and e12 <= BF16_TOL, f"D2 and D1+D2 within {BF16_TOL}")
        check(bool(torch.isfinite(out).all()), "decode output finite over a NaN tail")
        check(bool((out[3] == 0).all()), "decode row of length 0 is 0")


def phase_main_path(torch, cfg, params, kernels, counts):
    from flash_attention_cute_tpu_torch.models.cache import KVCache
    from flash_attention_cute_tpu_torch.models.transformer import forward
    from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
    import numpy as np

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT))
    ids = torch.from_numpy(ids).to("cuda")

    # Teacher forcing: the same prompt, then the same next token, through the
    # kernel path and the plain-attention path.
    diffs = []
    with torch.no_grad():
        caches, last = {}, {}
        for plain in (False, True):
            cache = KVCache.create(cfg, B, CAPACITY)
            logits, caches[plain] = forward(params, cfg, ids, cache=cache, mode="prefill",
                                            plain_attention=plain)
            last[plain] = logits
        diffs.append(("prefill", last[False], last[True]))
        tok = last[True][:, -1].argmax(-1)[:, None]
        del last
        step = {p: forward(params, cfg, tok, cache=caches[p], mode="decode",
                           plain_attention=p)[0] for p in (False, True)}
        diffs.append(("decode step", step[False], step[True]))
        del caches, step
    for name, a, b in diffs:
        check(bool(torch.isfinite(a).all()), f"{name} logits finite")
        d = (a - b).abs()
        print(f"  teacher-forced {name} logits {tuple(a.shape)}: max|diff| "
              f"{d.max().item():.4f}, mean|diff| {d.mean().item():.5f}, ref std "
              f"{b.std().item():.3f}, argmax agree "
              f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.4f}")
        check(d.max().item() <= LOGIT_MAX_TOL and d.mean().item() <= LOGIT_MEAN_TOL,
              f"{name} logits within max {LOGIT_MAX_TOL} / mean {LOGIT_MEAN_TOL}")
    del diffs
    torch.cuda.empty_cache()

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        tokens = greedy_generate(params, cfg, ids, NEW, cache_capacity=CAPACITY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update({name: k.launches for name, k in kernels.items()})
    print(f"  greedy_generate B{B} prompt {PROMPT} new {NEW}: {wall:.3f} s, launches {counts}")
    check(tuple(tokens.shape) == (B, NEW), "token shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens in vocab")
    n = cfg.num_layers
    check(counts["flash_fwd"] == n, f"P launched once per layer in prefill ({n})")
    for name in ("decode_partials", "decode_combine"):
        check(counts[name] == n * (NEW - 1), f"{name} launched {n} x {NEW - 1}")
    return ids


def phase_numbers(torch, cfg, params, ids, flash_fwd, flash_decode, errs, counts):
    from flash_attention_cute_tpu_torch.runtime.generate import decode_loop, prefill
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms, wall_time_s

    f = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # P at the main path's prefill shape.
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = randn(B, hq, PROMPT, d), randn(B, hkv, PROMPT, d), randn(B, hkv, PROMPT, d)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    pairs = PROMPT * (PROMPT + 1) // 2  # visible (query, key) pairs per head
    p_ops = 4 * B * hq * pairs * d
    p_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    rows = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:595",
        "ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True)),
        "call_ms": call_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True)),
        "plain_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True), 5),
        "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(q, kr, vr, is_causal=True)),
        "ops": p_ops, "bytes": p_bytes, "peak": PEAK_BF16,
    }]

    # D1 and D2 at the middle decode step: every row holds 512 + 32 keys.
    kc, vc = randn(B, hkv, CAPACITY, d), randn(B, hkv, CAPACITY, d)
    qd = randn(B, hq, 1, d)
    live = PROMPT + NEW // 2
    lengths = torch.full((B,), live, dtype=torch.int32, device="cuda")
    from flash_attention_cute_tpu_torch import dispatch
    splits = dispatch.decode_num_splits(B, hkv, CAPACITY)
    scale = d ** -0.5
    acc, m, l = flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits)
    part_bytes = 4 * (acc.numel() + m.numel() + l.numel())
    rows.append({
        "name": "decode_partials", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_decode.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_decode.py:42",
        "ms": cuda_time_ms(lambda: flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits), 50),
        "call_ms": call_time_ms(lambda: flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits), 50),
        "plain_ms": cuda_time_ms(lambda: flash_decode.decode_partials_plain(qd, kc, vc, lengths, scale, splits), 10),
        "library_ms": None,  # no single PyTorch call computes split partials
        "ops": 4 * B * hq * live * d,
        "bytes": 2 * qd.numel() + 2 * 2 * B * hkv * live * d + 4 * B + part_bytes,
        "peak": PEAK_F32,
    })
    rows.append({
        "name": "decode_combine", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_decode.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_decode.py:345",
        "ms": cuda_time_ms(lambda: flash_decode.decode_combine(acc, m, l, torch.bfloat16), 50),
        "call_ms": call_time_ms(lambda: flash_decode.decode_combine(acc, m, l, torch.bfloat16), 50),
        "plain_ms": cuda_time_ms(lambda: flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16), 10),
        "library_ms": None,  # no single PyTorch call merges split partials
        "ops": 4 * acc.numel(), "bytes": part_bytes + 2 * qd.numel(), "peak": PEAK_F32,
    })
    # Context only (not a kernel row): the whole decode attention, D1 + D2,
    # beside one SDPA call over the length-masked cache.
    mask = (torch.arange(CAPACITY, device="cuda") < live)[None, None, None, :]
    kcr, vcr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kc, vc))
    dec_ms = cuda_time_ms(lambda: flash_decode.flash_attention_decode(qd, kc, vc, lengths), 50)
    dec_call_ms = call_time_ms(lambda: flash_decode.flash_attention_decode(qd, kc, vc, lengths), 50)
    sdpa_dec_ms = cuda_time_ms(lambda: f.scaled_dot_product_attention(qd, kcr, vcr, attn_mask=mask), 50)
    del kcr, vcr, kr, vr

    kernels = []
    for r in rows:
        t_ops, t_bytes = r["ops"] / r["peak"], r["bytes"] / PEAK_BYTES
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": r["library_ms"],
        })

    # Main-path phases on the host clock, each ending in a synchronise.
    with torch.no_grad():
        (last, cache), pre_s = wall_time_s(lambda: prefill(params, cfg, ids, CAPACITY))
        first = last.argmax(-1).to(torch.int32)
        _, dec_s = wall_time_s(lambda: decode_loop(params, cfg, first, cache, NEW - 1))
        # decode_loop wrote the buffers in place but `cache` still holds the
        # prompt's lengths: profile a few steps from there.
        profile = profile_decode(torch, params, cfg, cache, first[:, None])
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    return kernels, {
        "prefill_ms": 1e3 * pre_s,
        "prefill_tokens_per_s": B * PROMPT / pre_s,
        "decode_ms_per_token": 1e3 * dec_s / (NEW - 1),
        "decode_device_busy_share": (
            profile["device_busy_ms_per_step"] / (1e3 * dec_s / (NEW - 1))
            if "device_busy_ms_per_step" in profile else None),
        "decode_tokens_per_s": B * (NEW - 1) / dec_s,
        "weights_gb": weight_bytes / 1e9,
        "weights_floor_ms_per_token": 1e3 * weight_bytes / PEAK_BYTES,
        "decode_attention_ms": dec_ms,
        "decode_attention_call_ms": dec_call_ms,
        "decode_attention_sdpa_ms": sdpa_dec_ms,
        "decode_num_splits": splits,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "layers": cfg.num_layers,
    }, profile


def profile_decode(torch, params, cfg, cache, tok, steps=4):
    """Device time per decode step and its top kernels, from torch.profiler
    (which slows the host side, so its wall time is reported apart)."""
    from torch.profiler import ProfilerActivity, profile
    from flash_attention_cute_tpu_torch.models.transformer import forward

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = forward(params, cfg, tok, cache=cache, mode="decode")
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Device-side events only: a CPU op also carries its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        return {"decode_profile": "not measured: the profiler recorded no device time"}
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=lambda e: -dev_us(e))[:12]
    return {
        "profiled_decode_steps": steps,
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "top_device_kernels_ms_per_step": [
            [e.key[:70], dev_us(e) / 1e3 / steps, e.count // steps] for e in top
        ],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=0,
                        help="cut the model's depth to this many layers (0 = full)")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "flash_attention_cute_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA Hopper card", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability()
    check(cap == (9, 0), f"compute capability 9.0 (Hopper), got {cap}")
    card = nvidia_smi()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from flash_attention_cute_tpu_torch.ops import _build, flash_decode, flash_fwd

    t0 = time.perf_counter()
    reports = _build.build(["flash_fwd.cu", "flash_decode.cu"])
    print(f"[2] build: {time.perf_counter() - t0:.1f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # 3. kernels vs plain
    errs: dict = {}
    print("[3] kernels vs plain (bf16, Hq 32 Hkv 8 D 128)")
    phase_kernels(torch, flash_fwd, flash_decode, errs)
    torch.cuda.synchronize()

    # 4. main path
    from flash_attention_cute_tpu_torch.models.llama import llama3_8b_config
    from flash_attention_cute_tpu_torch.models.transformer import init_params
    import dataclasses

    cfg = llama3_8b_config()
    if args.layers:
        print(f"  depth cut: {cfg.num_layers} -> {args.layers} layers (widths unchanged)")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[4] main path: Llama-3-8B widths, {cfg.num_layers} layers, random weights "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    kernels = {"flash_fwd": flash_fwd.PREFILL, "decode_partials": flash_decode.PARTIALS,
               "decode_combine": flash_decode.COMBINE}
    counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    ids = phase_main_path(torch, cfg, params, kernels, counts)

    # 5. numbers
    print("[5] numbers (CUDA events for kernels, host clock + synchronise for phases)")
    rows, numbers, profile = phase_numbers(torch, cfg, params, ids, flash_fwd, flash_decode,
                                           errs, counts)
    print(json.dumps(profile))
    print(json.dumps(numbers))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
