"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``lite_llama_tpu_torch/build/`` and loaded with ``ctypes``. No PyTorch headers
are involved, so a build takes seconds. The library's file name carries a
hash of its source and of every header it includes (``csrc/common.cuh``),
so an edited source or header is never served by a stale build.

Every C entry point takes raw device pointers (``ctypes.c_void_p``) plus the
current CUDA stream, launches without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Set, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("paged_decode", "flash_prefill_chunked", "qmatmul", "norms")
# Head dims the attention sources take: every even one from 16 to 128, and
# 256 (csrc/flash_prefill_chunked.cu, fresh and chunked prefill, pads each to
# the mma k-step of 16, csrc/paged_decode.cu masks the lanes past it), with
# up to MAX_GROUP query heads per kv head. Odd dims, 130-254 and wider groups
# are refused: no published Llama-, Qwen2- or Qwen3-family checkpoint has
# them, and each further width is another instance of both templates.
HEAD_DIMS = (*range(16, 129, 2), 256)
MAX_GROUP = 16

# --split-compile=0: each nvcc optimises its kernels on every core, not one
# (the attention sources' 74 template instances are most of a build;
# chip_smoke.py phase 2 prints each source's seconds).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--split-compile=0",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_declared: Set[Tuple[str, str]] = set()  # (source, entry) with argtypes set


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(path: Path, seen: Set[Path]) -> bytes:
    """The file's bytes followed by those of every header it includes from
    ``csrc/`` (``#include "..."``), each once, depth first."""
    seen.add(path)
    text = path.read_bytes()
    out = [text]
    for inc in _INCLUDE.findall(text):
        header = CSRC_DIR / inc.decode()
        if header not in seen:
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def _lib_path(name: str) -> Path:
    src = _source_bytes(CSRC_DIR / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no current build, one ``nvcc``
    per source, all started together. Returns seconds per source built;
    raises with the compiler's output if any build fails. The ptxas report
    (registers, shared memory, spills) is kept in ``build/<name>.log``."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out,
        )
    seconds = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with the C signature of ``entry`` declared. One library may serve
    several entries; each gets its own signature the first time it is
    asked for (an undeclared entry would get ctypes' default conversion,
    which cuts 64-bit device pointers to 32 bits)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    if (name, entry) not in _declared:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _declared.add((name, entry))
    return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, which every C
    entry takes: what ``torch.cuda.current_stream(device).cuda_stream``
    gives, without making a Stream object at each launch (the eager launch
    path is host-bound; chip_smoke.py ``host_costs`` times both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
