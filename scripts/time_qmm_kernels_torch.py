#!/usr/bin/env python3
"""Device times of the port's weight-only quantized products B10 (int8) and
B11 (int4) on one NVIDIA H100, for comparing two trees of the repository in
one call:

    cd <tree> && python3 <path of this script>

The package is imported from the current directory, so one call can time
the parent tree and the change in turns (parent, change, change, parent).
Shapes: every projection (K, N) of the Llama-3-8B trees the kernels serve,
the unfused int8 tree (q / o, k / v, gate / up, down, lm_head) at T 4 (the
greedy batch) and the fused int4 tree (qkv, o, gate_up, down, lm_head) at
T 8 (a serving round), each also at T 2048 (the greedy prefill, 4 x 512).
x is bf16 at unit scale, weights normal with std K ** -0.5 from a seeded
generator, quantized on the card. Each timing cycles over copies of the
weight totalling at least 100 MB (twice the 50 MB L2), so the weight comes
from device memory as it does when a model streams its layers; `library`
is one bf16 `x @ w` over dequantized copies. Prints one JSON line with the
card's name and power limit.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from flash_attention_cute_tpu_torch.ops import quantized_matmul as qmm  # noqa: E402
from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms  # noqa: E402

ROTATE = 100e6
TREES = {
    8: (4, {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
            "down": (14336, 4096), "lm_head": (4096, 128256)}),
    4: (8, {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
            "down": (14336, 4096), "lm_head": (4096, 128256)}),
}


def cycling(fn, items):
    it = itertools.cycle(items)
    return lambda: fn(next(it))


def cycles(iters, copies):
    """Whole cycles over the copies, about `iters` calls: far more would
    fill the launch queue, and the host's pace would be timed."""
    return copies * max(1, round(iters / copies))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "tree": os.getcwd(),
        "ms": {}, "library_ms": {}}
    for bits, (t_dec, shapes) in TREES.items():
        quantize = qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4
        dequantize = qmm.dequantize_weight if bits == 8 else qmm.dequantize_weight4
        for name, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
            qw = quantize(w)
            del w
            copies = [qw] + [dataclasses.replace(qw, values=qw.values.clone(),
                                                 scales=qw.scales.clone())
                             for _ in range(-(-int(ROTATE) // qw.nbytes) - 1)]
            dense = [dequantize(qw, torch.bfloat16)]
            dense += [dense[0].clone() for _ in range(-(-int(ROTATE) // (2 * k * n)) - 1)]
            for t in (t_dec, 2048):
                x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
                iters = 50 if t == t_dec else 10
                label = f"int{bits} {name} T{t} K{k} N{n}"
                out["ms"][label] = cuda_time_ms(
                    cycling(lambda w_: qmm.quantized_matmul(x, w_), copies),
                    cycles(iters, len(copies)))
                out["library_ms"][label] = cuda_time_ms(
                    cycling(lambda d_: x @ d_, dense), cycles(iters, len(dense)))
                del x
            del qw, copies, dense
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
