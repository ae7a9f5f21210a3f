"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a`` (H100), and loaded with
``ctypes``; pointers and the stream are passed as ``c_void_p``.  Nothing
includes PyTorch's headers, so a build takes seconds.

The build runs at the first launch of any kernel (or at ``build_all()``),
with one ``nvcc`` per source, all started together.  Libraries go into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
under a name that carries the hash of the source, the shared header and
the flags, so an edited source is rebuilt and an unchanged one is not.

Every launch function returns ``cudaGetLastError()``; ``check`` raises
when that is not 0, naming the CUDA error.

Building and loading are safe across threads: one module lock covers
``build_all`` and the loading of a library, so threads that launch a
kernel first together run nvcc once and load each library once.  A
temporary library is named by process and thread.

No source is built with ``--use_fast_math``: divisions stay correctly
rounded.  nvcc still contracts ``a * b + c`` into one FMA by default;
``neutron_matmul.cu``, whose int8 epilogue must round as numpy does,
writes each rounding with ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``,
which are never contracted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_decode",
           "neutron_matmul", "ssd_chunk", "ssd_chunk_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# held while building, loading or typing a library's function; reentrant,
# since loading builds what is missing
_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# nvcc's output (ptxas register and shared-memory report) per source,
# for the sources built by this process.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built on the machine that has the GPU")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, one nvcc each, all
    started together.  Returns the seconds it took; raises on a failed
    build with nvcc's output."""
    with _lock:
        return _build_missing()


def _build_missing() -> float:
    t0 = time.monotonic()
    todo = [(n, _library_path(n)) for n in SOURCES]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return time.monotonic() - t0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_name(
            f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.monotonic() - t0


TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")


def tensor_core_ops(name: str) -> Dict[str, Dict[str, int]]:
    """The tensor-core instructions in the SASS of each kernel of library
    ``name``, by mangled kernel name and mnemonic (``HMMA``/``HGMMA`` for
    bf16 and f16, ``IMMA``/``IGMMA`` for int8), read with ``cuobjdump
    -sass`` from the toolkit beside nvcc.  Builds first."""
    so = _library_path(name)
    if not so.exists():
        build_all()
    out = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass",
                          str(so)], capture_output=True, text=True,
                         check=True).stdout
    pattern = re.compile(r"\b(" + "|".join(TENSOR_CORE_OPS) + r")\b")
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(TENSOR_CORE_OPS, 0)
        elif fn is not None:
            op = pattern.search(line)
            if op:
                counts[fn][op.group(1)] += 1
    return counts


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            so = _library_path(name)
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The launch function ``symbol`` of library ``lib``, typed."""
    key = f"{lib}.{symbol}"
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        if key not in _fns:
            fn = getattr(_library(lib), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
        return _fns[key]


def check(rc: int, lib: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = _library(lib).rt_error_string(rc).decode()
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, with its data 16-byte aligned (for 16-byte
    loads); copied only where it is not already both."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
