"""Build the hand-written CUDA kernels of `csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
nvcc for sm_90a into `build/lib<name>-<hash>.so` at the repository
root (the hash is of the source, so an edited source rebuilds), then
loaded with ctypes. `build_all()` starts one nvcc per source at once.
Nothing here runs at import time.

Every C entry returns its launch's cudaError and takes PyTorch's
current stream as its last argument. `bind` sets an entry's argument
types once; `launch` calls it on a card's current stream and raises on
an error, so the kernel wrappers write out no calling convention.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argument codes of a C entry's signature: p a pointer, i an int, q a
# 64-bit int
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict = {}       # (library, entry) -> the entry, its types set


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{tag[:12]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every (or the named) kernel source that is not built
    yet, all nvcc processes in parallel. Returns {name: ptxas report}."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, built if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]


def bind(lib, entry: str, args: str):
    """The C entry `entry` of csrc/<lib>.cu (`lib` a name, built and
    loaded if needed, or a loaded library) with its argument types set
    once: one CTYPES code for each parameter before the stream, then the
    stream, and an int (cudaError) result."""
    key = (lib, entry)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(load(lib) if isinstance(lib, str) else lib, entry)
        fn.argtypes = [CTYPES[c] for c in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def launch(fn, index: int, *args, sets_device: bool = False) -> None:
    """Call the bound entry `fn` with `args` and PyTorch's current stream
    on card `index`. An entry that takes the card's index as its last
    argument before the stream makes the card current itself
    (`sets_device`: the index is passed); any other runs with the card
    made current around the call. Raises a RuntimeError naming the
    entry on a non-zero cudaError."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if sets_device:
        err = fn(*args, index, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed "
                           f"(cudaError {err})")
