"""Build the repository's C++ host libraries (``native/*.cpp``) for the port.

Each source is compiled by ``g++`` into the port's build directory
(``ops/kernels/_build.py::build_dir``: ``$EZAUDIO_TORCH_BUILD_DIR``, default
``build/ezaudio_tpu_torch``), never beside the source.  The library's name
hashes the source and the flags, so an edited source is rebuilt.  The
compiler writes to a name private to the process, which is then renamed
into place: parallel first users (pytest-xdist workers, the ranks of a
distributed run) never load a half-written library.  Nothing runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

from ezaudio_tpu_torch.ops.kernels._build import build_dir

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def gxx() -> Optional[str]:
    return shutil.which("g++")


def lib_path(source: str, flags: Sequence[str]) -> str:
    """``lib<stem>-<hash>.so`` in the build directory."""
    h = hashlib.sha1(" ".join(flags).encode())
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}-{h.hexdigest()[:12]}.so")


def build(source: str, flags: Sequence[str], libs: Sequence[str] = (),
          timeout: float = 180.0) -> str:
    """Compile ``native/<source>`` with ``g++ <flags> <source> -o <lib> <libs>``
    unless its library exists; returns the library's path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails and
    ``FileNotFoundError`` without ``g++`` or the source."""
    src = os.path.join(NATIVE_DIR, source)
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    out = lib_path(source, flags)
    if os.path.exists(out):
        return out
    cc = gxx()
    if cc is None:
        raise FileNotFoundError("g++ not found")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *flags, src, "-o", tmp, *libs], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out
