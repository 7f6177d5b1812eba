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
# Element type codes understood by the C entry points (csrc/common.cuh).
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}

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


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None) -> None:
    """Raise unless `t` can be handed to a kernel as a strided pointer:
    on the GPU, head dim contiguous, 16-byte aligned rows."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim, strides {t.stride()}")
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in strides):
        raise ValueError(
            f"{name} rows must be 16-byte aligned (pointer {t.data_ptr():#x}, "
            f"strides {t.stride()})"
        )
