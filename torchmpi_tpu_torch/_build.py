"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/<name>-<digest>.so``, where the digest covers the
source, every header beside it and the compiler flags: an edited source
builds anew, an unchanged one loads the library already built.  Nothing is
built at import: the first call of a kernel's wrapper builds it.  A tool's
source elsewhere (``tools/csrc``) builds the same way when its directory is
named.

A missing ``nvcc`` or a failed build raises :class:`BuildError`; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def sources() -> List[str]:
    """Names of every kernel source under ``ops/csrc`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise BuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                     "the port's CUDA kernels cannot be built")


def library_path(name: str, src_dir: Optional[Path] = None) -> Path:
    src_dir = src_dir or CSRC
    src = src_dir / f"{name}.cu"
    if not src.is_file():
        raise BuildError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(src_dir.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, src_dir: Optional[Path] = None) -> Path:
    """Build kernel source ``name`` (of ``src_dir``, by default
    ``ops/csrc``) unless it is built already; returns the library's path.
    Raises :class:`BuildError` with ``nvcc``'s output."""
    src_dir = src_dir or CSRC
    out = library_path(name, src_dir)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src_dir / f"{name}.cu")],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed on {name}.cu (exit {proc.returncode})"
                         f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: no reader sees half a .so
    return out


def build_all() -> List[Path]:
    """Build every kernel source at once, one ``nvcc`` for each, all started
    together; returns the libraries' paths in :func:`sources` order and
    raises the first :class:`BuildError`."""
    from concurrent.futures import ThreadPoolExecutor

    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(build, n) for n in names]
        return [f.result() for f in futures]


def load(name: str, src_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (of ``src_dir``), built
    first if need be."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name, src_dir)))
    return lib
