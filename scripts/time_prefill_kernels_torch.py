#!/usr/bin/env python3
"""Device times of the port's prefill kernels P and B2 (and P with its lse,
where the package has `return_lse`) on one NVIDIA H100, for comparing two
trees of the repository in one call:

    cd <tree> && python3 <this script>

The package is imported from the current directory. Shapes: P at the
Llama-3-8B greedy prefill (B 4, S 512) and the training step (B 2, S 2048),
B2 at Mistral-7B's greedy prefill (B 2, S 5120, window 4096); Hq 32, Hkv 8,
D 128, bf16, causal. Prints one JSON line with the card's name and power
limit.
"""

import inspect
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from flash_attention_cute_tpu_torch.ops import flash_fwd  # noqa: E402
from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lse = "return_lse" in inspect.signature(flash_fwd.flash_attention_fwd).parameters
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "tree": os.getcwd()}
    for name, b, s, w in (("P B4 S512", 4, 512, None), ("P B2 S2048", 2, 2048, None),
                          ("B2 B2 S5120 W4096", 2, 5120, 4096)):
        q = torch.randn((b, 32, s, 128), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, 8, s, 128), generator=gen, device="cuda").bfloat16()
                for _ in "kv")
        out[name] = cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(
            q, k, v, causal=True, window=w), 20)
        if lse:
            out[name + " with lse"] = cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(
                q, k, v, causal=True, window=w, return_lse=True), 20)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
