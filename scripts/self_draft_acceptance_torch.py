#!/usr/bin/env python3
"""Self-draft acceptance of speculative generation on one NVIDIA H100, for
comparing two trees of the repository in one call:

    cd <tree> && python3 <this script> [--phi3] [--plain] [prompt seeds ...]

The package is imported from the current directory. Full-depth Llama-3-8B
with `chip_smoke.py`'s random weights (a CUDA generator seeded 0) drafts
for itself at B 4, prompt 512, 64 new tokens, gamma 4, as `chip_smoke.py`
run 4e (i) does; with `--phi3` the model at Phi-3-mini's widths of
`chip_smoke.py` phase 4n (weights seeded 10; prompt seed 10 is that
phase's prompt). Each prompt seed (default 0-4; seed 0 is run 4e's
prompt) draws the B x 512 prompt ids with numpy. With `--plain` every
attention call runs its plain PyTorch version (`forward(plain_attention=
True)`), the yardstick of the kernels' share in the result. Greedy acceptance depends
on near-ties between the draft's decode logits (D1 + D2) and the verify's
extend logits (B4), so it moves with any change in their roundings: the
seeds show how far it moves from one prompt to the next, a second run of a
tree whether it repeats. Prints one JSON line: the card's name and power
limit, and per seed the rounds, accepted drafts and the share accepted /
(rounds x gamma x B).
"""

import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flash_attention_cute_tpu_torch.models import transformer  # noqa: E402
from flash_attention_cute_tpu_torch.models.llama import llama3_8b_config  # noqa: E402
from flash_attention_cute_tpu_torch.runtime import generate, speculative  # noqa: E402

B, PROMPT, NEW, GAMMA = 4, 512, 64, 4


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    args = sys.argv[1:]
    phi3, plain = "--phi3" in args, "--plain" in args
    seeds = [int(a) for a in args if not a.startswith("--")] or list(range(5))
    if phi3:
        from chip_smoke import phi3_mini_widths_config
        cfg, weight_seed = phi3_mini_widths_config(), 10
    else:
        cfg, weight_seed = llama3_8b_config(), 0
    if plain:  # the prefills, the draft's steps and the verify alike
        route = functools.partial(transformer.forward, plain_attention=True)
        generate.forward = speculative.forward = route
    params = transformer.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(weight_seed))
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "tree": os.getcwd(),
        "model": "phi3-widths" if phi3 else "llama3-8b", "plain_attention": plain}
    with torch.no_grad():
        for seed in seeds:
            ids = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (B, PROMPT))).to("cuda")
            _, stats = speculative.speculative_generate(params, cfg, params, cfg, ids, NEW,
                                                        gamma=GAMMA, return_stats=True)
            out[str(seed)] = {"rounds": stats["rounds"], "accepted": stats["accepted_drafts"],
                              "share": stats["accepted_drafts"] / (stats["rounds"] * GAMMA * B)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
