"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` source has a plain C interface. They are
compiled for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into one shared library under ``build/`` at the repo
root (a directory ``.gitignore`` lists). The library's name carries a hash
of the sources, the ``csrc/*.cuh`` headers they include and the flags, so
an edited source or header is rebuilt and a stale library is never
loaded. A build failure raises: nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_fns = {}                # bound C entry points, by name
build_seconds = None     # wall time of the build in this process (None: cached)
build_log = ""           # nvcc's -Xptxas -v report (registers, spills, smem)


def count(module, by=None):
    """Add one to a wrapper module's ``launches`` (and to its
    ``launches_by[by]`` when ``by`` is given), under one lock: replicas
    step from threads, and the launch call releases the GIL."""
    with _count_lock:
        module.launches += 1
        if by is not None:
            module.launches_by[by] += 1


def sources(pkg: Path = _PKG):
    """Every file the library is built from under ``pkg``: the ``.cu``
    sources nvcc compiles and the ``.cuh`` headers they include."""
    return sorted([*pkg.glob("*/csrc/*.cu"), *pkg.glob("*/csrc/*.cuh")])


def rows16(t) -> bool:
    """Whether a kernel may copy ``t``'s rows 16 bytes at a time: unit
    last stride, every other stride (of a dim longer than 1) and the base
    address 16-byte aligned."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and (t.shape[-1] == 1 or t.stride(-1) == 1)
            and all(n == 1 or s % per == 0
                    for n, s in zip(t.shape[:-1], t.stride()[:-1])))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels of repro_torch are built at first use")
    return path


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _build(srcs, target: Path):
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for s in (s for s in srcs if s.suffix == ".cu"):
            obj = os.path.join(tmp, s.stem + ".o")
            objs.append(obj)
            procs.append((s, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(s), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for s, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        so_tmp = os.path.join(tmp, target.name)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", so_tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(so_tmp, target)
    (BUILD_DIR / (target.stem + ".log")).write_text(build_log)
    build_seconds = time.time() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = sources()
            target = BUILD_DIR / f"repro_torch_kernels_{_digest(srcs)}.so"
            if not target.exists():
                _build(srcs, target)
            _lib = ctypes.CDLL(str(target))
        return _lib


def kernel(name: str, argtypes):
    """C entry point ``name`` with its argument types set, bound once a
    process; it returns the launch's ``cudaError_t`` as an int."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def refuse_grad(what: str, tensors, why: str):
    """Raise ``NotImplementedError`` when autograd would record a kernel
    that has no backward (grad mode on, an input requiring grad): the
    kernel's output would carry no gradient, and a loss's backward would
    silently miss it. ``why`` says what is missing."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(f"{what}: an input requires grad, but the "
                                  f"CUDA kernel has no backward ({why}); "
                                  f"run it under torch.no_grad()")


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
