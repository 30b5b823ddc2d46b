"""Builds of the port's native code at first use, into the git-ignored
`build/torch_kernels/` directory of the checkout.

Each source becomes a plain C-ABI shared library loaded with ctypes: the C++
route planner with g++, the CUDA kernels with nvcc for sm_90a.  A build that
fails raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

from carla_driving_rl_agent_torch import PACKAGE_DIR, REPO_ROOT

BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")

GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
# No --use_fast_math: log1p, exp and the divisions must stay IEEE-accurate
# for the render kernel's uint8 parity with its plain version.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _lib_path(name: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def compile_library(name: str, sources: Sequence[str], compiler: str,
                    extra_deps: Sequence[str] = (),
                    extra_flags: Sequence[str] = ()) -> str:
    """Compile `sources` into a shared library named by their content hash
    and return its path; an existing build of the same content is reused.
    `compiler` is "g++" or "nvcc"; `extra_flags` follow its default flags."""
    if compiler == "nvcc":
        cmd, flags = [_nvcc()], NVCC_FLAGS + list(extra_flags)
    elif compiler == "g++":
        cmd, flags = ["g++"], GXX_FLAGS + list(extra_flags)
    else:
        raise ValueError(f"unknown compiler {compiler!r}")
    path = _lib_path(name, list(sources) + list(extra_deps), flags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + list(flags) + ["-o", tmp] + list(sources),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed to build {name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library(name: str, sources: List[str], compiler: str,
                 signatures: Dict[str, Tuple[object, list]],
                 extra_deps: Sequence[str] = (),
                 extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process, declaring
    `signatures` {function: (restype, argtypes)} on first load."""
    key = f"{compiler}:{name}"
    if key not in _LOADED:
        lib = ctypes.CDLL(compile_library(name, sources, compiler, extra_deps,
                                          extra_flags))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[key] = lib
    return _LOADED[key]


def build_parallel(build_fns: Sequence) -> None:
    """Run the zero-argument `build_fns` (each builds and loads one library)
    on one thread each, so that their compilers run at the same time;
    re-raises the first failure."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, len(build_fns))) as pool:
        for fut in [pool.submit(fn) for fn in build_fns]:
            fut.result()


def csrc(*parts: str) -> str:
    return os.path.join(PACKAGE_DIR, "csrc", *parts)
