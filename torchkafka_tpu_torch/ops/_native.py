"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build
happens at first use, from the package's own sources only, into
``_build/`` beside this package (listed in ``.gitignore``), keyed by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and an unchanged one loads.
Processes that load at once build once: the build runs under
``utils.buildlock.build_lock(_build/)``, and a process that waited finds
the library there. Importing this module needs no ``nvcc``: nothing is built or loaded until
a kernel's wrapper first launches it on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from torchkafka_tpu_torch.utils.buildlock import build_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", *ARCH_FLAGS)
KERNELS = (
    "flash_fwd", "flash_bwd", "kvattn_dynlen", "kvattn_paged", "kvattn_full",
    "qmatmul",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "torchkafka_tpu_torch are built from csrc/ at first use"
    )


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, keyed by the source, every
    ``csrc/*.cuh`` it may include, and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is already built;
    returns (process, temporary output, final path) or None."""
    out = _target(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = KERNELS) -> None:
    """Build every kernel library, one ``nvcc`` per source, all started
    together, under the cross-process build lock (a library another
    process built meanwhile is not built again)."""
    with _lock:
        if all(_target(n).exists() for n in names):
            return
        with build_lock(BUILD):
            jobs = {n: _start_build(n) for n in names}
            for n, job in jobs.items():
                if job is not None:
                    _finish_build(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher (a
    refused launch never runs, and a later synchronize would not report
    it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
