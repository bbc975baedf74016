"""Build and load the port's CUDA kernels.

The sources under `flexflow_tpu_torch/csrc/` are compiled at first use
with `nvcc -gencode arch=compute_90a,code=sm_90a`, one `nvcc` per source,
all started together, then linked into ONE shared library with a plain C
interface, loaded through ctypes. No PyTorch header is compiled, so a
build takes seconds. The library lands in `flexflow_tpu_torch/_build/`
(ignored by git) under a name keyed by the hash of the sources and flags:
an edited source rebuilds, an unchanged one loads the existing library.

Nothing here runs at import: a CPU-only machine can import every kernel
module; only a launch on a CUDA tensor builds. Processes that share the
checkout (the ranks of a mesh) build under an exclusive lock on
`_build/build.lock`, so no two write the same object file; a launcher
builds once before it starts its ranks, which then load the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh FFDtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds, whether it compiled, ptxas's
# register / shared-memory report per source
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of flexflow_tpu_torch are built from csrc/ at first "
            "use and need the CUDA toolkit")
    return path


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link the shared library; return
    its path. Reuses a library built from identical sources. Holds an
    exclusive file lock on the build directory meanwhile: a second
    process waits, then finds the library built."""
    tag = _digest(sorted(CSRC.glob("*.cu*")))
    lib_path = BUILD_DIR / f"libffkernels_{tag}.so"
    if lib_path.exists():
        BUILD_INFO.update(compiled=False, library=str(lib_path))
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib_path.exists():
            BUILD_INFO.update(compiled=False, library=str(lib_path))
            return lib_path
        return _compile(tag, lib_path)


def _compile(tag: str, lib_path: Path) -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, _, proc in jobs:  # wait for every compile before raising
        logs[src.name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp)]
        + [str(obj) for _, obj, _ in jobs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(compiled=True, library=str(lib_path),
                      seconds=time.perf_counter() - t0, ptxas=logs)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ff_decode_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f,
                                        i, i, i, i, i, i, i, p]
    lib.ff_decode_attention.restype = i
    lib.ff_layernorm_fwd.argtypes = [p, p, p, p, p, p, i, i, f, i, p, i, i,
                                     i, i]
    lib.ff_layernorm_fwd.restype = i
    lib.ff_softmax_fwd.argtypes = [p, p, i, i, i, p, i, i, i, i, i, i]
    lib.ff_softmax_fwd.restype = i
    lib.ff_softmax_max_active_clusters.argtypes = [i, i, i, i]
    lib.ff_softmax_max_active_clusters.restype = i
    lib.ff_layernorm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                     p, i, i, i, i]
    lib.ff_layernorm_bwd.restype = i
    lib.ff_softmax_bwd.argtypes = [p, p, p, i, i, i, p, i, i, i, i, i, i]
    lib.ff_softmax_bwd.restype = i
    lib.ff_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, i,
                                 i, i, p]
    lib.ff_flash_fwd.restype = i
    lib.ff_flash_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                 i, f, i, i, i, i, p]
    lib.ff_flash_bwd.restype = i
    lib.ff_rmsnorm_fwd.argtypes = [p, p, p, p, i, i, f, i, p, i, i, i, i]
    lib.ff_rmsnorm_fwd.restype = i
    lib.ff_rmsnorm_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, p, i, i,
                                   i, i]
    lib.ff_rmsnorm_bwd.restype = i
    lib.ff_reduce.argtypes = [p, ctypes.c_longlong, i, i, p, p, i, p, i, i,
                              i, i]
    lib.ff_reduce.restype = i
    lib.ff_cumsum.argtypes = [p, p, ctypes.c_longlong, ctypes.c_longlong, i,
                              i, p, i, ctypes.c_longlong, i, p]
    lib.ff_cumsum.restype = i
    pp, lp = ctypes.POINTER(p), ctypes.POINTER(ctypes.c_longlong)
    lib.ff_adam.argtypes = [pp, pp, pp, pp, lp, i, p, p, f, f, f, f, f, f,
                            i, p]
    lib.ff_adam.restype = i
    lib.ff_sgd.argtypes = [pp, pp, pp, lp, i, p, f, i, f, p]
    lib.ff_sgd.restype = i
    lib.ff_optimizer_max_tensors.argtypes = []
    lib.ff_optimizer_max_tensors.restype = i
    lib.ff_flash_tc_smem_bytes.argtypes = [i, i, i, i]
    lib.ff_flash_tc_smem_bytes.restype = ctypes.c_longlong
    lib.ff_error_string.argtypes = [i]
    lib.ff_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


# template arguments a kernel of csrc/ takes, as they are mangled
_TEMPLATE_ARG = r"Li(-?\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)"


def _kernel_name(mangled: str) -> str:
    """`name<args>` of a mangled kernel, at namespace scope or in a
    (possibly anonymous) namespace, whose template arguments are ints,
    bools, float or bf16 (`_Z16flash_bwd_dkv_tcILi64ELi2EEvPK...` ->
    `flash_bwd_dkv_tc<64, 2>`, `_ZN..19rmsnorm_warp_kernelI13__nv_bfloat16
    Li4EEEv...` -> `rmsnorm_warp_kernel<bf16, 4>`, `..17reduce_cta_kernelI
    fLb1ELi4EEEv...` -> `reduce_cta_kernel<float, true, 4>`); a kernel
    that is no template by its name alone; anything else as mangled."""
    nested = mangled.startswith("_ZN")
    if not mangled.startswith("_Z"):
        return mangled
    pos, ident = 3 if nested else 2, None
    if mangled[pos:pos + 1] == "L":  # internal linkage
        pos += 1
    while True:  # the length-prefixed names, the innermost last
        num = re.match(r"\d+", mangled[pos:])
        if num is None:
            break
        pos += len(num.group())
        ident = mangled[pos:pos + int(num.group())]
        pos += int(num.group())
        if not nested:
            break
    if ident is None:
        return mangled
    args = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", mangled[pos:])
    if args is None:
        return ident
    names = [num or {"1": "true", "0": "false"}.get(flag)
             or ("float" if f else "bf16")
             for num, flag, f, _ in re.findall(_TEMPLATE_ARG,
                                               args.group(1))]
    return f"{ident}<" + ", ".join(names) + ">"


def ptxas_report(source: str) -> List[Dict[str, object]]:
    """What ptxas said of each kernel of `source` (a csrc/ file name) in
    the build of this process: the kernel (`name<template args>`),
    registers, stack, spill stores and loads in bytes. Empty when this
    process loaded a library built earlier."""
    log = BUILD_INFO.get("ptxas", {}).get(source, "")
    out: List[Dict[str, object]] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            out.append({"kernel": _kernel_name(entry.group(1))})
            continue
        if not out:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            out[-1].update(stack=int(frame.group(1)),
                           spill_stores=int(frame.group(2)),
                           spill_loads=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[-1]["registers"] = int(regs.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().ff_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
