"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each `csrc/*.cu` source becomes one shared library with a plain C interface,
compiled for Hopper (`sm_90a`) at first use into `_build/` beside this
package (listed in `.gitignore`) and named by a hash of the sources, so an
edited source rebuilds and an unchanged one is reused. No PyTorch headers
are included, which keeps a build to seconds.

`Kernel` is one C entry point: calling it launches on the current CUDA
stream, raises if the launch is refused (`cudaGetLastError()` is returned by
the C side after every launch), and counts the launch in `launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Element type codes understood by the C entry points (csrc/common.cuh):
# q, the output and a dense cache; the values of a quantized cache.
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
KV_DTYPE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
LOG2E = math.log2(math.e)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(source: str) -> pathlib.Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source not yet built, one nvcc each, all at once.

    Returns {source: ptxas report} for the sources compiled by this call
    (registers, shared memory and spills per kernel). Raises on a failed
    build with the compiler's output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not _library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for src in todo:
            out = pathlib.Path(tmp) / _library_path(src).name
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / src)]
            procs[src] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        reports, failed = {}, []
        for src, (out, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            reports[src] = log
            os.replace(out, _library_path(src))  # atomic publish
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The library built from `source`, building it if needed."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(_library_path(source)))
        lib.fact_error_string.argtypes = [ctypes.c_int]
        lib.fact_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def runtime_report(source: str, symbol: str) -> str:
    """The report a `csrc` source's C function `symbol` writes: registers,
    spill bytes and shared memory of its kernel instantiations, as the
    card's runtime gives them (builds the library if needed; needs the
    card)."""
    fn = getattr(load(source), symbol)
    fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_int], ctypes.c_int
    buf = ctypes.create_string_buffer(16384)
    fn(buf, len(buf))
    return buf.value.decode()


P = ctypes.c_void_p  # every pointer and the stream: a c_int would cut them to 32 bits
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


class Kernel:
    """One C launch function of a `csrc` source, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (fn, lib)
        fn, lib = self._fn
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed: {lib.fact_error_string(err).decode()}"
            )
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, aligned: bool = True) -> None:
    """Raise unless `t` can be handed to a kernel as a strided pointer:
    on the GPU, head dim contiguous, and (`aligned`, for the kernels that
    read or write whole 16-byte chunks) 16-byte aligned rows."""
    _check_placed(name, t, dtype)
    if aligned and not _aligned(t):
        raise ValueError(
            f"{name} rows must be 16-byte aligned (pointer {t.data_ptr():#x}, "
            f"strides {t.stride()})"
        )


def _check_placed(name: str, t: torch.Tensor, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim, strides {t.stride()}")


def _aligned(t: torch.Tensor) -> bool:
    """A 16-byte aligned pointer and every stride (of a dim above 1) a
    whole number of 16 bytes: TMA's rule."""
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return t.data_ptr() % 16 == 0 and not any(s * t.element_size() % 16 for s in strides)


def window_arg(window: int | None) -> int:
    """A sliding window as the kernels take it: W >= 1, or 0 for none."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be a positive key count, got {window}")
    return int(window)


def softcap_arg(logit_softcap: float | None) -> float:
    """A tanh soft cap c as the kernels take it: c * log2(e), in the base-2
    units of their scores, or 0 for none."""
    if logit_softcap is None:
        return 0.0
    if not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be positive, got {logit_softcap}")
    return float(logit_softcap) * LOG2E


# Head dims a kernel lays out natively: each kernel is compiled for these.
LAYOUT_HEAD_DIMS = (64, 128, 256)
# The wide layouts (csrc/attention_wgmma.cuh: P / B2, B4 with its
# partials, B6, B9 and B12; csrc/paged_decode.cuh: D1, B5, B7 and B8;
# csrc/flash_bwd.cu: B13a / B13b; and D2, the paged append and QA, which
# take any row): d 257-512.
WIDE_HEAD_DIM = 512
HEAD_DIM_ITEM = "ROADMAP.md A14"  # the roadmap item of the head dims above 256


def padded_head_dim(d: int, what: str = "this", elem_bytes: int = 2, wide: bool = False) -> int:
    """The head-dim rule of every attention kernel (P / B2 and P-i8 /
    B2-i8, K8, D1 + D2, B4, B5, B6, B12, B13a / B13b, the paged append and,
    over one-byte (int8 / e4m3) rows, B7, B8, B9 and QA): a head dim d from
    1 to 256 runs in the layout of the least of `LAYOUT_HEAD_DIMS` at or
    above it, with the columns past d read as zeros (csrc/common.cuh
    `padded_head_dim`). `wide` (every kernel but the int8 scores P-i8 /
    B2-i8 / K8) also takes d from 257 to 512, in the layout of
    `WIDE_HEAD_DIM`. Its
    rows lie at `row_pitch(d, elem_bytes)`, which meets TMA's 16-byte
    stride rule for every d. Returns that layout's head dim; d 0 or above
    256 (512 with `wide`) raises, naming the roadmap item, before a
    launch."""
    top = WIDE_HEAD_DIM if wide else LAYOUT_HEAD_DIMS[-1]
    if not (isinstance(d, int) and 1 <= d <= top):
        raise NotImplementedError(
            f"{what} kernel takes a head_dim from 1 to {top}, got {d} (head dims above {top}: "
            f"{HEAD_DIM_ITEM})")
    return next(x for x in (*LAYOUT_HEAD_DIMS, WIDE_HEAD_DIM) if d <= x)


def row_pitch(d: int, elem_bytes: int = 2) -> int:
    """Elements from one row of head dim d to the next in a buffer the
    kernels read through TMA: d rounded up to a whole 16 bytes
    (csrc/common.cuh `row_pitch`). The kernels that store rows of d
    columns in pairs (P / B2, B4, B6 / B9, B12, B13a / B13b) write their
    outputs at `row_pitch(d, 2)`, whatever the output's element size."""
    step = 16 // elem_bytes
    return -(-d // step) * step


def empty_rows(shape, dtype, device, pitch: int | None = None, zero: bool = False):
    """A tensor of `shape` whose last dim d lies at a row pitch (default
    `row_pitch(d, dtype.itemsize)`): a view `[..., :d]` of a buffer of the
    pitch's width, whose pitch columns are zeros. `zero` zeroes the d
    columns too. At d == pitch it is a contiguous tensor, as torch.empty /
    torch.zeros give it."""
    *lead, d = shape
    if pitch is None:
        pitch = row_pitch(d, dtype.itemsize)
    alloc = torch.zeros if zero else torch.empty
    buf = alloc((*lead, pitch), dtype=dtype, device=device)
    if pitch == d:
        return buf
    if not zero:
        buf[..., d:].zero_()
    return buf[..., :d]


def out_rows(shape, dtype, device, pitch: int | None = None):
    """`empty_rows` for a kernel's output, with nothing zeroed first: the
    kernels that store rows at the pitch (P / B2 and P-i8 / B2-i8, K8, B4
    and its partials, B6 / B9, B12, B13a / B13b) write the pitch columns
    too, as zeros."""
    *lead, d = shape
    if pitch is None:
        pitch = row_pitch(d, dtype.itemsize)
    buf = torch.empty((*lead, pitch), dtype=dtype, device=device)
    return buf if pitch == d else buf[..., :d]


def check_out_rows(name: str, t: torch.Tensor, pitch: int) -> None:
    """Raise unless the output `t` lies as `out_rows(..., pitch)` lays it
    (rows `pitch` apart, otherwise contiguous), where a kernel that stores
    rows of the pitch writes it."""
    want, step = [], 1
    for n in reversed((*t.shape[:-1], pitch)):
        want.append(step)
        step *= n
    if t.stride() != tuple(reversed(want)) or t.shape[-1] > pitch:
        raise ValueError(f"{name} must lie at rows of {pitch} elements (`out_rows`), got "
                         f"strides {t.stride()}")


# Padded copies `pad_rows` made, by kind: "activation" (q, k, v, dO handed in
# by the caller) and "cache" (a caller's cache or pool read by a kernel).
copies = {"activation": 0, "cache": 0}


def rows(name: str, t: torch.Tensor, dtype=None, kind: str = "activation") -> torch.Tensor:
    """`t` as a kernel reads it (`pad_rows`). Raises, as `check_cuda_tensor`,
    for a tensor off the GPU, of another dtype or with a strided head dim."""
    _check_placed(name, t, dtype)
    return pad_rows(t, kind)


def pad_rows(t: torch.Tensor, kind: str = "activation") -> torch.Tensor:
    """`t` itself where its rows meet TMA's 16-byte rule (as
    `check_cuda_tensor` asks), else one padded copy into a buffer at
    `row_pitch` (`out_rows`: no kernel reads the pitch columns as data),
    counted in `copies[kind]`."""
    if _aligned(t):
        return t
    out = out_rows(t.shape, t.dtype, t.device)
    out.copy_(t)
    copies[kind] += 1
    return out
