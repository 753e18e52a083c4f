"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
``build/kernels/<name>-<hash>.so`` at the root of the checkout, and
loaded with ``ctypes``. The hash covers the source, the shared headers
and the flags, so an edited source is rebuilt and a stale library is
never loaded. Several sources build in parallel, one ``nvcc`` each.

No ``--use_fast_math``: the int8 cache's quantize-on-write needs IEEE
division and ``rintf`` to stay bitwise equal to the plain version, and
the norms' statistics use correctly rounded square roots. Where a kernel
must be bitwise equal to eager PyTorch (BatchNorm apply and dx), it
writes each float32 step with the ``_rn`` intrinsics, which nvcc never
contracts into an FMA.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) is an error here and not a silent
no-op.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel and nowhere else, so a caller can show
that a run went through the kernels (``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "layernorm_fwd": 0,
    "layernorm_bwd": 0,
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "append_attend": 0,
    "append_attend_int8": 0,
    "bn_stats": 0,
    "bn_apply": 0,
    "bn_bwd_reduce": 0,
    "bn_bwd_dx": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> Dict[str, Path]:
    """Kernel source name -> path, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels of horovod_tpu_torch build on the machine with the "
        "card")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 for one already built); raises with nvcc's
    output when a build fails. The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``<name>.log``."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for name in names:
        target = _target(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.hvd_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.hvd_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
