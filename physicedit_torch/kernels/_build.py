"""Build the CUDA sources in ``physicedit_torch/csrc`` at first use and load
them with ``ctypes``.

Each ``<name>.cu`` becomes ``build/physicedit_torch/<name>-<hash>.so`` at the
root of the checkout, where the hash covers every source in ``csrc/`` and
the compiler flags, so an edited kernel is rebuilt and an unchanged one is
reused.  The sources have a plain C interface (no PyTorch headers), which
keeps a build to a few seconds of ``nvcc``.  Pointers and the stream cross
as ``ctypes.c_void_p``; each entry point returns ``cudaGetLastError()``,
which :func:`launch` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "physicedit_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


def build_all(names) -> dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no up-to-date
    library, one ``nvcc`` per source, all started together.

    The compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<library>.log``.  A library is written to a temporary
    name and renamed, so concurrent builders never load a partial file."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        Path(f"{todo[name]}.log").write_text(err)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        lib.physicedit_cuda_error_string.argtypes = [ctypes.c_int]
        lib.physicedit_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a C pointer (null for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(name: str, symbol: str, argtypes: list, *args) -> None:
    """Call the entry point ``symbol`` of ``csrc/<name>.cu`` with ``args``
    and the current CUDA stream, and raise if it returns a CUDA error.  The
    argument types (the stream last, added here) are set once."""
    import torch

    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        msg = load(name).physicedit_cuda_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
