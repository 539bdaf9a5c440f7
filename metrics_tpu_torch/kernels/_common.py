"""Shared plumbing for the CUDA kernel modules.

Counterpart of ``metrics_tpu/kernels/_common.py``: the availability probe,
the dispatch counters (whose ``"cuda"`` path is each kernel's launch count)
and the build and load of the kernels' shared library.

The kernels are CUDA C++ for Hopper (``sm_90a``) under
``metrics_tpu_torch/csrc``. At first use, :func:`build_library` compiles
each source with ``nvcc`` (all at once, one process per source), links
them into one shared library named by a hash of the sources and flags, and
renames it into place under ``build/kernels/`` at the root of the checkout,
so a half-written library is never loaded. The library has a plain C
interface and is loaded with ``ctypes``: every pointer and the stream pass
as ``c_void_p``, and each entry returns the CUDA error of its launch (0 if
none), which :func:`check_launch` raises.

A wrapper's host time is most of a kernel call at the paths' sizes, so the
pieces every wrapper goes through are cheap after the first call: the
device's capability is asked once (:func:`require_capability`), a resolved
entry is read without a lock (:func:`kernel_function`), and the stream is
read as its raw handle (:func:`current_stream_handle`).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", *_ARCH_FLAGS)
#: the one device capability the library is built for (``sm_90a``)
_CAPABILITY = (9, 0)


def cuda_kernels_available() -> bool:
    """True when a CUDA device of the capability the kernels are built for is present."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability(0) == _CAPABILITY


#: indices of the CUDA devices that :func:`require_capability` has passed
_CAPABLE_DEVICES: Set[int] = set()


def require_capability(device: torch.device) -> None:
    """Raise unless ``device`` is a Hopper card the library is built for.

    A device index is asked once; later calls read the cached answer.
    """
    if device.index in _CAPABLE_DEVICES:
        return
    capability = torch.cuda.get_device_capability(device)
    if capability != _CAPABILITY:
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (capability {_CAPABILITY}), but {device} has {capability}"
        )
    if device.index is not None:
        _CAPABLE_DEVICES.add(device.index)


def current_stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, without
    building a ``torch.cuda.Stream`` object (which ``current_stream(device)
    .cuda_stream`` does, at about 20 times the host cost)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# --------------------------------------------------------------------------
# dispatch counters
# --------------------------------------------------------------------------

_DISPATCH_LOCK = threading.Lock()
#: ``{op: {"cuda": n, "torch": n}}``; ``"cuda"`` counts kernel launches
_DISPATCH_COUNTS: Dict[str, Dict[str, int]] = {}


def note_kernel_dispatch(op: str, path: str) -> None:
    """Record one dispatch of ``op``: ``path="cuda"`` where its kernel was
    launched, ``path="torch"`` where its plain version ran on the CPU."""
    with _DISPATCH_LOCK:
        by_path = _DISPATCH_COUNTS.setdefault(op, {})
        by_path[path] = by_path.get(path, 0) + 1


def dispatch_count(op: str, path: str) -> int:
    """Point read of one dispatch counter."""
    with _DISPATCH_LOCK:
        return _DISPATCH_COUNTS.get(op, {}).get(path, 0)


def launch_count(op: str) -> int:
    """How many times ``op``'s kernel was launched since the last reset."""
    return dispatch_count(op, "cuda")


def reset_dispatch_counters() -> None:
    """Zero every dispatch counter."""
    with _DISPATCH_LOCK:
        _DISPATCH_COUNTS.clear()


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")
    return nvcc


def _run(cmds: Sequence[List[str]]) -> str:
    """Run the commands at once; raise with the compiler's output if one fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n{output}")
    return "".join(outputs)


def build_library(build_dir: Path = _BUILD_DIR) -> Tuple[Path, str]:
    """Build the kernels' shared library unless it is built already.

    Returns its path and the compiler's output (``-Xptxas=-v``: registers,
    shared memory and spills of each kernel; empty when already built).
    """
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = build_dir / f"libmetrics_tpu_torch_{tag}.so"
    if lib_path.exists():
        return lib_path, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    unique = f"{os.getpid()}_{threading.get_ident()}"
    objects = [build_dir / f"{src.stem}_{tag}_{unique}.o" for src in sources]
    tmp_path = build_dir / f"{lib_path.name}.{unique}.tmp"
    try:
        log = _run([[nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in zip(sources, objects)])
        log += _run([[nvcc, *_ARCH_FLAGS, "-shared", *map(str, objects), "-o", str(tmp_path)]])
        os.replace(tmp_path, lib_path)
    finally:
        for path in (*objects, tmp_path):
            path.unlink(missing_ok=True)
    return lib_path, log


_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}


def kernel_function(name: str, argtypes: Sequence[type]) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the kernels' library, built and loaded at first use.

    A resolved entry is read without the lock; the lock guards the first
    build, load and resolution, and an entry is published fully typed.
    """
    fn = _FUNCTIONS.get(name)
    if fn is not None:
        return fn
    global _LIB
    with _LIB_LOCK:
        fn = _FUNCTIONS.get(name)
        if fn is None:
            if _LIB is None:
                _LIB = ctypes.CDLL(str(build_library()[0]))
            fn = getattr(_LIB, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCTIONS[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name}: the kernel launch failed with CUDA error {err}")
