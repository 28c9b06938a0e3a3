"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, sharing
``csrc/*.cuh``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries go to a build directory
(``$EZAUDIO_TORCH_BUILD_DIR``, default ``build/ezaudio_tpu_torch`` beside
the package), named by a hash of source, headers and flags, and are reused while
that hash holds.  :func:`build_all` starts one ``nvcc`` per source at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("attention", "resunit")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("EZAUDIO_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "ezaudio_tpu_torch")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    """``lib<name>-<hash>.so``, hashed over the source, every shared header
    (``csrc/*.cuh``) and the flags, so an edited header is rebuilt."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(build_dir(), f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: compiler output}`` (with ptxas' register and
    spill report) for the builds it ran; raises with the compiler output if
    any build fails."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib


def count(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel on ``dtype`` inputs: ``wrapper.launches``
    and ``wrapper.launches_by_dtype[<dtype name>]`` each go up by one."""
    wrapper.launches += 1
    name = str(dtype).rsplit(".", 1)[-1]
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name, 0) + 1


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
