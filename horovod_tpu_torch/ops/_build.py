"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
``build/kernels/<name>-<hash>.so`` at the root of the checkout, and
loaded with ``ctypes``. The hash covers the source, the shared headers
and the flags, so an edited source is rebuilt and a stale library is
never loaded. Several sources build in parallel, one ``nvcc`` each; a
source in ``PARTS`` is compiled as several translation units at once,
each with ``-DHVD_PART=k`` (the source emits one share of its template
instantiations a part, and all of them without the define), then linked
into its one library, so its compile does not set the build's wall
time alone.

No ``--use_fast_math``: the int8 cache's quantize-on-write and the int8
wire's kernels need IEEE division and ``rintf`` to stay bitwise equal
to the plain versions, and the norms' statistics use correctly rounded
square roots. Where a kernel must be bitwise equal to eager PyTorch
(BatchNorm apply and dx), it writes each float32 step with the ``_rn``
intrinsics, which nvcc never contracts into an FMA.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) is an error here and not a silent
no-op.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one (``count_launch``) where it launches its kernel and nowhere else,
so a caller can show that a run went through the kernels
(``chip_smoke.py``). A fused computation-collective surface (the int8
wire's psum and reduce-scatter, the ring-row epilogues, the decode
append+attend) is recorded in the metrics once a process, at its first
launch on the card with metrics on (:func:`note_surface`): the JAX
package records it when it lowers the surface, and the port has no
lowering.
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

#: kernel source -> the translation units it is compiled as (see above)
PARTS = {"append_attend": 5, "layernorm_bwd": 2}

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
    "quant_rows": 0,
    "quant_ef_rows": 0,
    "accum_rows": 0,
    "dequant_flat": 0,
    "pack_rows": 0,
    "matmul_pack": 0,
}

#: CPU seconds (user + system, with the compiler's own children) of each
#: kernel source's last ``nvcc`` in this process
CPU_SECONDS: Dict[str, float] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_BUILDING = threading.Lock()


_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (under a lock: the emulated
    ranks of ``parallel/comm.run_ranks`` launch from several threads)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


#: the fused surfaces this process has recorded (``note_surface``)
_SURFACES: set = set()


def note_surface(surface: str) -> None:
    """``metrics.record_fused_collective(surface)`` at the surface's
    first launch on the card while metrics are on, then never again in
    this process; a caller launching its kernel calls it."""
    from ..utils import metrics

    if metrics.enabled() and surface not in _SURFACES:
        _SURFACES.add(surface)
        metrics.record_fused_collective(surface)


def reset_launches() -> None:
    with _COUNT_LOCK:
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
    h.update(str(PARTS.get(name, 1)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compiles(name: str, tmp: Path):
    """``[(command, output)]`` of one source's compile: one command
    writing the library, or one a part writing its object file."""
    src = str(CSRC / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        return [([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                  src], tmp)]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [([_nvcc(), *flags, f"-DHVD_PART={k}", "-c", "-I", str(CSRC),
              "-o", str(tmp.with_suffix(f".{k}.o")), src],
             tmp.with_suffix(f".{k}.o")) for k in range(n)]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 for one already built); raises with nvcc's
    output when a build fails. The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``<name>.log``."""
    names = list(sources()) if names is None else list(names)
    with _BUILDING:  # a build on another thread finishes first
        return _build(names)


def _build(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    jobs = {}  # name -> (tmp, target, t0, [(command, output)])
    for name in names:
        target = _target(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (tmp, target, time.perf_counter(), _compiles(name, tmp))
    results = {}  # (name, k) -> (exit code, output)
    tally = threading.Lock()  # not _LOCK, which library() holds here

    # the compiles at a lower priority than their caller, which may run
    # work of its own on the same cores meanwhile (nvcc's children
    # inherit it)
    nice = shutil.which("nice")
    prefix = [nice, "-n", "10"] if nice else []

    def run(name, k, cmd, t0):
        # each nvcc's own wall seconds and its CPU seconds, children
        # included; a split source's wall runs to its last part
        proc = subprocess.Popen(prefix + cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        out = proc.stdout.read()
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        cpu = usage.ru_utime + usage.ru_stime
        with tally:
            results[(name, k)] = (proc.returncode, out)
            seconds[name] = max(seconds.get(name, 0.0),
                                time.perf_counter() - t0)
            CPU_SECONDS[name] = CPU_SECONDS.get(name, 0.0) + cpu
            if len(jobs[name][3]) > 1:
                CPU_SECONDS[f"{name}.{k}"] = cpu

    for name in jobs:
        CPU_SECONDS.pop(name, None)
    waiters = [threading.Thread(target=run, args=(name, k, cmd, t0))
               for name, (_, _, t0, cmds) in jobs.items()
               for k, (cmd, _) in enumerate(cmds)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failures = []
    for name, (tmp, target, t0, cmds) in jobs.items():
        outs = [results[(name, k)] for k in range(len(cmds))]
        log = "".join(out for _, out in outs)
        ok = all(rc == 0 for rc, _ in outs)
        if ok and len(cmds) > 1:
            # the parts' objects into the one library
            link = subprocess.run(
                [_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                 *(str(o) for _, o in cmds)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            ok = link.returncode == 0
            seconds[name] = time.perf_counter() - t0
        for _, o in cmds:
            if o != tmp:
                o.unlink(missing_ok=True)
        (BUILD_DIR / f"{name}.log").write_text(log)
        if not ok:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
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


_SM_COUNT: Dict[int, int] = {}
_TICKETS: Dict[tuple, "torch.Tensor"] = {}


def sm_count(device) -> int:
    """The SM count of CUDA ``device`` (cached)."""
    import torch

    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def tickets(kernel: str, device, count: int):
    """At least ``count`` zeroed int32 counters for the last-block
    finish of ``kernel``, one set per (kernel, device, stream): launches
    on one stream run in order, and each kernel leaves its counters
    zeroed. A larger ``count`` replaces the set with a larger one (work
    that reuses the old one's memory is queued on the same stream, after
    the launches that counted with it)."""
    import torch

    key = (kernel, device.index, stream_handle(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t
