"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/repro_torch_kernels/`` at the root of the checkout
(git-ignored). A library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.
`build` starts one ``nvcc`` per missing library, all at once.

Importing this module needs neither ``nvcc`` nor a GPU: the CPU tests
import it. Asking for a library where ``nvcc`` is missing raises.

``counts`` holds, per kernel, the ``nvcc`` builds and the library loads
of this process: what `repro_torch.analysis.guards.recompile_sentinel`
reads, as `repro`'s reads a jitted function's compile cache.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: kernel name -> its source under csrc/
SOURCES = {"graph_mix": "graph_mix.cu",
           "sparse_graph_mix": "sparse_graph_mix.cu",
           "compressed_graph_mix": "compressed_graph_mix.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_bwd_bf16": "flash_attention_bwd_bf16.cu",
           "ssd": "ssd.cu",
           "ssd_bwd": "ssd_bwd.cu",
           "rglru_scan": "rglru_scan.cu",
           "rglru_scan_bwd": "rglru_scan_bwd.cu",
           "cnn_features": "cnn_features.cu"}
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}
#: kernel name -> [nvcc builds, library loads] in this process
counts: Dict[str, List[int]] = {name: [0, 0] for name in SOURCES}


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled library: where it is, how long nvcc took (0 when it
    was already built) and what nvcc printed (ptxas register and shared
    memory use)."""
    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    # every source includes what it needs of the shared headers: hash them
    # all, so an edited header rebuilds its users
    src = b"".join(p.read_bytes() for p in
                   [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(todo: Dict[str, Path]) -> Dict[str, Tuple[float, str]]:
    """Run one ``nvcc`` a library of ``todo`` (name -> library path), all
    started together, each publishing its library atomically. Returns
    {name: (seconds since the start, nvcc's output)}; raises with nvcc's
    output if any compile fails."""
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    out, failures = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        # atomic publish: a concurrent builder never loads a partial file
        os.replace(tmp, todo[name])
        out[name] = (time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process each, started together. Raises with nvcc's
    output if any compile fails."""
    names = list(SOURCES if names is None else names)
    out: Dict[str, Built] = {}
    todo = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = Built(path, 0.0, "")
        else:
            todo[name] = path
    if todo:
        for name, (seconds, log) in _compile(todo).items():
            counts[name][0] += 1
            out[name] = Built(todo[name], seconds, log)
    return out


def _open(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _open(build([name])[name].path)
        counts[name][1] += 1
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel ``name``'s library, bound with
    ``argtypes`` and an int result (the ``cudaError_t`` of the launch).
    Pass ``ctypes.c_void_p`` for every pointer and the stream: an
    unannotated Python int would be cut to 32 bits."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


def check(name: str, err: int):
    """Raise if a launch of kernel ``name`` returned a CUDA error: a
    refused launch never runs, and no later synchronize reports it."""
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg(err).decode()})")
