"""Shared plumbing for the CUDA kernel modules.

Counterpart of ``metrics_tpu/kernels/_common.py``: the availability probe,
the dispatch counters (whose ``"cuda"`` path is each kernel's launch count,
read into ``observability.snapshot()["kernels"]`` by :func:`dispatch_summary`)
and the build and load of the kernels' shared library.

Launches inside a CUDA graph count when the graph runs: while a compiled
dispatch captures (:func:`capture_tally`), a wrapper's launch goes to that
graph's own tally instead of the counters (a capture launches nothing), and
every replay adds the tally to the ``"cuda"`` counts (:func:`note_replay`).
The JAX package notes a dispatch once per trace instead.

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
device is taken as it is (:func:`kernel_device`), a resolved entry is read
without a lock (:func:`kernel_function`), and the stream is read as its raw
handle (:func:`current_stream_handle`). Each C entry takes the device index
and makes that device current itself (``csrc/device_scope.cuh``), so no
wrapper enters a ``torch.cuda.device`` context.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

import torch
from torch._C import _functorch

from metrics_tpu_torch.utilities.data import resolve_device

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


def kernel_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` resolved: a ``torch.device`` that names its index, as the
    metrics pass theirs, is taken as it is (without a card no tensor lies on
    a CUDA device, so the wrappers' device check still raises); anything else
    goes through :func:`~metrics_tpu_torch.utilities.data.resolve_device`."""
    if type(device) is torch.device and device.index is not None:
        return device
    return resolve_device(device)


#: ``{device index: streaming multiprocessors}``, asked once per device
_SM_COUNTS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """How many streaming multiprocessors the CUDA ``device`` has (132 on an H100 SXM)."""
    count = _SM_COUNTS.get(device.index)
    if count is None:
        count = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return count


def batch_first(x: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """``x`` with its ``torch.func.vmap`` batch axis ``dim`` moved first, or
    broadcast to ``size`` along a new first axis where it has none (a vmap
    rule's inputs)."""
    return x.movedim(dim, 0) if dim is not None else x.expand((size,) + tuple(x.shape))


def vmap_stack(fn: Callable[..., Any], tensors: Sequence[torch.Tensor], *args: Any) -> Any:
    """The kernels' vmap rule: ``fn(*tensors, *args)`` for tensors batched by
    ``torch.func.vmap``, as one call of ``fn`` over the whole stack.

    Every vmap level that batches one of the tensors is taken off, innermost
    first: the tensors batched at a level are unwrapped with their batch axis
    moved first, and one that is not batched there is broadcast along a new
    first axis (:func:`batch_first`). The batch axes of nested vmaps are then
    flattened into one leading axis, ``fn`` runs once outside them all on
    that stack, and each output gets its leading axes back and is batched
    again, level by level. A level that batches none of the tensors is taken
    off and put back around ``fn`` as it is. A transform other than ``vmap``
    above a batched tensor is refused.

    This is what a ``torch.autograd.Function`` with a ``vmap`` staticmethod
    does, without the Function's dispatch, which cost more host time than
    the launch it leads to (``scripts/torch_hist_ab.py --rule-forms`` times
    the two forms). It uses functorch's interpreter stack
    (``torch._C._functorch``), which ``tests/test_torch_kernels.py`` pins.
    """
    xs = list(tensors)
    popped: List[Tuple[Any, int, Optional[int]]] = []  # (layer, level, batch size or None), innermost first
    try:
        while any(_functorch.is_batchedtensor(x) for x in xs):
            interpreter = _functorch.peek_interpreter_stack()
            if interpreter is None or interpreter.key() != _functorch.TransformType.Vmap:
                raise RuntimeError(
                    "the kernels' vmap rule takes tensors batched by torch.func.vmap alone, but the innermost"
                    f" transform is {None if interpreter is None else interpreter.key()}"
                )
            level = interpreter.level()
            inputs = [(_functorch.get_unwrapped(x), _functorch.maybe_get_bdim(x)) if _functorch.maybe_get_level(x) == level
                      else (x, None) for x in xs]
            size = next((x.shape[d] for x, d in inputs if d is not None), None)
            popped.append((_functorch.pop_dynamic_layer_stack(), level, size))
            if size is not None:
                xs = [batch_first(x, d, size) for x, d in inputs]
        lead = tuple(size for _, _, size in reversed(popped) if size is not None)
        if len(lead) > 1:
            xs = [x.reshape((-1,) + tuple(x.shape[len(lead):])) for x in xs]
        out = fn(*xs, *args)
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        if len(lead) > 1:
            outs = tuple(o.reshape(lead + tuple(o.shape[1:])) for o in outs)
    except BaseException:
        for layer, _, _ in reversed(popped):
            _functorch.push_dynamic_layer_stack(layer)
        raise
    for layer, level, size in reversed(popped):
        _functorch.push_dynamic_layer_stack(layer)
        if size is not None:
            outs = tuple(_functorch._add_batch_dim(o, 0, level) for o in outs)
    return outs[0] if isinstance(out, torch.Tensor) else outs


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


class _Capture(threading.local):
    #: ``{op: launches}`` of the graph this thread is capturing, else None
    tally: Optional[Dict[str, int]] = None


_CAPTURE = _Capture()


@contextmanager
def capture_tally() -> Iterator[Dict[str, int]]:
    """For the block (a CUDA graph's capture on this thread), collect the
    kernel launches the wrappers note into the yielded ``{op: launches}``
    tally instead of the counters; :func:`note_replay` counts it per replay."""
    saved, _CAPTURE.tally = _CAPTURE.tally, {}
    try:
        yield _CAPTURE.tally
    finally:
        _CAPTURE.tally = saved


def note_replay(tally: Dict[str, int]) -> None:
    """Count one replay of a captured graph: each op's launches in it."""
    if not tally:
        return
    with _DISPATCH_LOCK:
        for op, n in tally.items():
            by_path = _DISPATCH_COUNTS.setdefault(op, {})
            by_path["cuda"] = by_path.get("cuda", 0) + n


def note_kernel_dispatch(op: str, path: str) -> None:
    """Record one dispatch of ``op``: ``path="cuda"`` where its kernel was
    launched, ``path="torch"`` where its plain version ran on the CPU. A
    launch captured into a CUDA graph goes to the graph's tally
    (:func:`capture_tally`) and counts at each replay.

    Unlike the JAX package's counters, these count whether telemetry is on
    or off: the ``"cuda"`` count is the launch count that proves a path ran
    through its kernel (``launch_count``), and ``observability.reset()``
    leaves them as they are, as it leaves the JAX package's."""
    tally = _CAPTURE.tally
    if tally is not None and path == "cuda":
        tally[op] = tally.get(op, 0) + 1
        return
    with _DISPATCH_LOCK:
        by_path = _DISPATCH_COUNTS.setdefault(op, {})
        by_path[path] = by_path.get(path, 0) + 1


def dispatch_summary() -> Dict[str, Dict[str, Dict[str, int]]]:
    """The ``snapshot()["kernels"]`` section, ``{"dispatch": {op: {path: n}}}``
    in the JAX package's form (``"cuda"``/``"torch"`` where it has
    ``"pallas"``/``"xla"``)."""
    with _DISPATCH_LOCK:
        return {"dispatch": {op: dict(paths) for op, paths in _DISPATCH_COUNTS.items()}}


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
