"""Build at first use and ctypes binding of the native serving runtime.

Port of flash_attention_cute_tpu/runtime/native.py. The native library is the
host-side part of the serving loop: the page allocator and the continuous-
batching scheduler (FCFS within priority classes, decode-OOM preemption).
Its source, `csrc/page_allocator.cpp`, is a byte-identical copy of the JAX
package's (a test holds the two equal), so both engines schedule alike.

`g++` builds it at first use into `_build/` beside this package (listed in
`.gitignore`), named by a hash of the source; a failed build raises with the
compiler's output. There is no Python fallback switch: the engine always
takes the native scheduler, and `engine._PyScheduler` is its lockstep twin
for the tests. The library's prefix-cache entry points (page sharing, pins,
prefix grants) are not bound: the prefix cache is ROADMAP A7b.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "page_allocator.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None

_c_void, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "pa_create": ([_c_int, _c_int, _c_int], _c_void),
    "pa_destroy": ([_c_void], None),
    "pa_num_free": ([_c_void], _c_int),
    "pa_pages_needed": ([_c_void, _c_int, _c_int], _c_int),
    "pa_allocate": ([_c_void, _c_i64, _c_int, _c_int], _c_int),
    "pa_release": ([_c_void, _c_i64], None),
    "pa_table_row": ([_c_void, _c_i64, _c_i32p, _c_int], _c_int),
    "sched_create": ([_c_int, _c_int, _c_int, _c_int], _c_void),
    "sched_destroy": ([_c_void], None),
    "sched_submit_priority": ([_c_void, _c_i64, _c_int, _c_int, _c_int], None),
    "sched_admit": ([_c_void], _c_int),
    "sched_step_slot": ([_c_void, _c_int], _c_int),
    "sched_finished": ([_c_void, _c_int], _c_int),
    "sched_release_slot": ([_c_void, _c_int, _c_int], None),
    "sched_preempt_youngest": ([_c_void], _c_int),
    "sched_slot_id": ([_c_void, _c_int], _c_i64),
    "sched_slot_generated": ([_c_void, _c_int], _c_int),
    "sched_num_waiting": ([_c_void], _c_int),
    "sched_table_row": ([_c_void, _c_i64, _c_i32p, _c_int], _c_int),
    "sched_num_free_pages": ([_c_void], _c_int),
}


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SRC.stem}-{digest}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built; raise with g++'s output on
    failure. Concurrent builds publish atomically."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = pathlib.Path(tmp) / so.name
        res = subprocess.run(
            ["g++", *CXX_FLAGS, str(SRC), "-o", str(out)],
            capture_output=True, text=True, timeout=300,
        )
        if res.returncode != 0:
            raise RuntimeError(f"building {SRC.name} failed:\n{res.stdout}{res.stderr}")
        os.replace(out, so)
    return so


def load() -> ctypes.CDLL:
    """The native library, built and bound on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def _table_row(fn, handle, seq_id: int, pages_per_seq: int) -> np.ndarray:
    out = np.zeros((pages_per_seq,), np.int32)
    fn(handle, seq_id, out.ctypes.data_as(_c_i32p), pages_per_seq)
    return out


class NativePageAllocator:
    """ctypes facade with the API of runtime.paged_cache.PageAllocator."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int):
        self._lib = load()
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self._h = self._lib.pa_create(num_pages, page_size, pages_per_seq)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pa_destroy(self._h)

    @property
    def num_free(self) -> int:
        return self._lib.pa_num_free(self._h)

    def pages_needed(self, cur_len: int, new_tokens: int) -> int:
        return self._lib.pa_pages_needed(self._h, cur_len, new_tokens)

    def allocate(self, seq_id: int, cur_len: int, new_tokens: int) -> bool:
        return bool(self._lib.pa_allocate(self._h, seq_id, cur_len, new_tokens))

    def release(self, seq_id: int) -> None:
        self._lib.pa_release(self._h, seq_id)

    def table_row(self, seq_id: int) -> np.ndarray:
        return _table_row(self._lib.pa_table_row, self._h, seq_id, self.pages_per_seq)


class NativeScheduler:
    """Continuous-batching scheduler (FCFS within priority, decode-OOM
    preemption of the lowest-priority, youngest request)."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int, slots: int):
        self._lib = load()
        self.slots = slots
        self.pages_per_seq = pages_per_seq
        self._h = self._lib.sched_create(num_pages, page_size, pages_per_seq, slots)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)

    def submit(self, req_id: int, prompt_len: int, max_new_tokens: int, priority: int = 0):
        self._lib.sched_submit_priority(self._h, req_id, prompt_len, max_new_tokens, priority)

    def admit(self) -> int:
        return self._lib.sched_admit(self._h)

    def step_slot(self, slot: int) -> int:
        return self._lib.sched_step_slot(self._h, slot)

    def finished(self, slot: int) -> bool:
        return bool(self._lib.sched_finished(self._h, slot))

    def release_slot(self, slot: int, requeue: bool = False):
        self._lib.sched_release_slot(self._h, slot, int(requeue))

    def preempt_youngest(self) -> int:
        return self._lib.sched_preempt_youngest(self._h)

    def slot_id(self, slot: int) -> int:
        return self._lib.sched_slot_id(self._h, slot)

    def slot_generated(self, slot: int) -> int:
        return self._lib.sched_slot_generated(self._h, slot)

    @property
    def num_waiting(self) -> int:
        return self._lib.sched_num_waiting(self._h)

    @property
    def num_free_pages(self) -> int:
        return self._lib.sched_num_free_pages(self._h)

    def table_row(self, seq_id: int) -> np.ndarray:
        return _table_row(self._lib.sched_table_row, self._h, seq_id, self.pages_per_seq)


def make_page_allocator(num_pages: int, page_size: int, pages_per_seq: int):
    """The native page allocator (its build raises rather than falling back)."""
    return NativePageAllocator(num_pages, page_size, pages_per_seq)
