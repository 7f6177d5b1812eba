#!/usr/bin/env python3
"""Compare the SASS of kernel libraries built from two trees of the
repository, function by function:

    python3 scripts/compare_sass_torch.py [--sub-in-b PATTERN REPLACEMENT] \
        <tree A> <tree B> flash_decode.cu \
        quantized.cu flash_fwd.cu flash_chunked.cu paged_attention.cu quant_paged_extend.cu

Each source is built in each tree by that tree's own build code
(`flash_attention_cute_tpu_torch/ops/_build.py`, into the tree's `_build/`),
and the libraries are disassembled with `cuobjdump -sass`. Prints one JSON
line: for each source, the kernel functions whose SASS is byte-identical,
and for each one that differs, whether it is identical once the offsets
into the kernel's parameter bank (`c[0x0][...]`) are masked, i.e. whether
only the layout of its argument struct moved, and otherwise its first
differing instruction (jump targets masked too) beside the index of its
last tensor-core product. `--sub-in-b PATTERN REPLACEMENT` rewrites tree
B's mangled kernel names by a regular expression (`re.sub`) before they are
matched with tree A's: a kernel that gained a template argument in B is
then compared with its old self (a `false`, `Lb0E`, anywhere: `--sub-in-b
Lb0E ''`; B4's kPartials, its last argument: `--sub-in-b 'Lb0E(EEv)'
'\\1'`). Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""

import json
import os
import re
import shutil
import subprocess
import sys

_LIB_PATH = (
    "import sys; sys.path.insert(0, '.'); "
    "from flash_attention_cute_tpu_torch.ops import _build; "
    "_build.build(sys.argv[1:]); "
    "print('\\n'.join(str(_build._library_path(s)) for s in sys.argv[1:]))"
)


def build(tree: str, sources: list[str]) -> list[str]:
    out = subprocess.run([sys.executable, "-c", _LIB_PATH, *sources], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-len(sources):]


def cuobjdump() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin",
                                                              "cuobjdump"),
                 shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def functions(lib: str) -> dict[str, str]:
    """{mangled kernel name: its SASS text} of one library. Each line's
    address is written without padding and its runs of blanks are cut to
    one: cuobjdump pads a whole listing's address column to its longest
    function, so an unchanged kernel would otherwise read as changed in a
    library that gained a larger one."""
    text = subprocess.run([cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name is not None:
            line = re.sub(r"/\*([0-9a-f]+)\*/", lambda a: f"/*{int(a.group(1), 16):x}*/", line)
            out[name] += " ".join(line.split()) + "\n"
    return out


def masked(sass: str) -> str:
    """SASS with parameter-bank offsets and instruction encodings masked."""
    sass = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", sass)
    return re.sub(r"/\* 0x[0-9a-f]+ \*/", "", sass)


def instructions(sass: str) -> list[str]:
    """A function's instructions in order, masked as `masked` does and with
    the targets of its jumps and calls masked too: code that grows late in
    a function moves every target past it."""
    out = []
    for line in masked(sass).splitlines():
        m = re.match(r"/\*[0-9a-f]+\*/ (.*?) ;", line)
        if m:
            ins = m.group(1)
            if re.search(r"\b(BRA|BRX|CALL|BSSY|JMP|JMX)\b", ins):
                ins = re.sub(r"0x[0-9a-f]+", "0x.", ins)
            out.append(ins)
    return out


def where(sass_a: str, sass_b: str) -> str:
    """Where two versions of a function part: the first instruction that
    differs once offsets and targets are masked, against the last tensor
    core product (HGMMA / HMMA) of A, so that a change confined to a
    kernel's epilogue shows as such."""
    a, b = instructions(sass_a), instructions(sass_b)
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    mma = [i for i, x in enumerate(a) if "MMA" in x.split()[0 if not x.startswith("@") else 1]]
    return (f"differs from instruction {first} of {len(a)} ({len(b)} in B); A's last tensor "
            f"core product is instruction {mma[-1] if mma else None}")


def main() -> None:
    args, sub = sys.argv[1:], None
    if args[0] == "--sub-in-b":
        sub, args = (args[1], args[2]), args[3:]
    tree_a, tree_b, sources = args[0], args[1], args[2:]
    libs_a, libs_b = build(tree_a, sources), build(tree_b, sources)
    report = {}
    for src, la, lb in zip(sources, libs_a, libs_b):
        fa, fb = functions(la), functions(lb)
        if sub:
            fb = {re.sub(*sub, name): sass for name, sass in fb.items()}
        same, differ = [], {}
        for name in sorted(set(fa) | set(fb)):
            if fa.get(name) == fb.get(name):
                same.append(name)
            elif name in fa and name in fb:
                differ[name] = ("differs only in parameter offsets"
                                if masked(fa[name]) == masked(fb[name])
                                else where(fa[name], fb[name]))
            else:
                differ[name] = "only in " + ("A" if name in fa else "B")
        report[src] = {"identical": len(same), "of": len(set(fa) | set(fb)), "differing": differ}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
