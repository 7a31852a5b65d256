"""Build the port's native host-plane library with the host's C++ compiler.

``hostcomm.cpp`` and the headers beside it (``bf16.h``, ``crc32.h``,
``trace.h``) are the port's own copies of the JAX package's host-plane
sources, byte for byte, so the two packages speak one wire protocol.  They
compile once into ``_build/lib<name>-<digest>.so`` beside this file, where
the digest covers every source, every header and the flags: an edited
source builds anew, an unchanged one loads the library already built.
Nothing is built at import; the first ring made builds it
(``collectives/hostcomm.py``).

A missing compiler or a failed build raises :class:`NativeBuildError`;
there is no fallback.  ``CXX`` names another compiler than ``g++``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-Wextra", "-Werror=return-type")

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused a host-plane source."""


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where the library of ``sources`` (names beside this file) lives once
    built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in [HERE / s for s in sources] + sorted(HERE.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` into one shared library unless it is built
    already; returns its path."""
    out = library_path(name, sources)
    with _lock:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # A private name, then an atomic rename: ranks of one host may build
        # the same digest at once, and no reader sees half a library.
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS,
               *(str(HERE / s) for s in sources), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
        except OSError as e:
            raise NativeBuildError(f"cannot run {cmd[0]}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{cmd[0]} failed on {', '.join(sources)} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return str(out)
