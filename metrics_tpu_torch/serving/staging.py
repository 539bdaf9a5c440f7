"""Columnar staging for the admission queue: device-resident ingest.

Counterpart of ``metrics_tpu/serving/staging.py:42-360``. The unstaged
:class:`~metrics_tpu_torch.serving.queue.AdmissionQueue` keeps every resident
row as a Python tuple and pays for cohort formation inside the flush (a
per-row ``np.stack`` per column, a fresh pad block, a copy to the card from
pageable memory, which waits for the card once per column). The staged path
moves that work:

* **submit time** writes rows straight into a :class:`StagingRing`, one
  preallocated power-of-two circular numpy buffer per update-argument column
  (plus the id, submit-time and trace-cohort columns). Admission order is
  ring order, so cohort formation is a slice copy into a reusable
  :class:`slot <StagingSlot>`.
* **pop time** copies the cohort's rows from the ring into a free slot (one
  or two slice copies per column), under the admission lock.
* **stage time** (a prefetch job on the async ``staging`` lane, or the
  flushing thread) runs the vectorized quarantine scan over the slot, folds
  the power-of-two pad in place (ids ``-1``, zeroed columns) and copies the
  cohort to the card. On a CUDA device a slot's id and update columns are
  **pinned** host tensors, seen by the ring's numpy code through
  ``.numpy()`` views; the copy is ``non_blocking`` on the queue's side
  stream and ends in an event recorded there (:attr:`StagedCohort.event`),
  which the dispatch's stream waits on. A slot is taken for a new cohort
  only once its last copy has finished (:meth:`StagingSlot.wait_copied`).
  On the CPU a slot is plain numpy and the twin an owning
  ``torch.from_numpy(...).clone()``.
* **dispatch time** hands the target :class:`StagedColumn` views: ndarray
  views over the slot carrying their device twin (``device_tensor``). The
  keyed wrappers dispatch the twin; host-side readers (the id check, the
  traffic ledger, the scheduler's touched tenants) read the view, with no
  read from the card.

Ring-span safety: sequence numbers grow monotonically and the pending
window is one contiguous range. The queue copies a cohort's rows from the
ring into its slot at the moment it pops them, under the admission lock,
so only resident rows (at most ``capacity_rows``) ever live in the ring,
which the queue sizes at ``pow2(capacity_rows + slots * max_batch)``, the
JAX package's size. (The JAX queue copies a prefetched cohort out of the
ring later, on the staging lane; under ``shed_oldest`` at capacity the
producers can wrap the ring over its rows first, ROADMAP queue C.)

Pickling drops every buffer; the rebuilt object binds its layout again on
the first row it sees.
"""
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "StagedColumn",
    "StagedCohort",
    "StagingRing",
    "StagingSlot",
    "StagingSlotPool",
    "as_staged",
    "stage_layout",
]

#: layout entry per staged column: (dtype string, trailing shape)
Layout = Tuple[Tuple[str, Tuple[int, ...]], ...]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class StagedColumn(np.ndarray):
    """An ndarray view over a staging slot carrying its device twin.

    ``device_tensor`` is the tensor already copied to the queue's device.
    Any derived view, copy or unpickled array drops it: it belongs to the
    exact view the stager attached it to.
    """

    device_tensor: Optional[torch.Tensor] = None

    def __array_finalize__(self, obj: Optional[np.ndarray]) -> None:
        self.device_tensor = None


def as_staged(host: np.ndarray, device: Optional[torch.Tensor]) -> np.ndarray:
    """``host`` as a :class:`StagedColumn` carrying ``device``; with
    ``device=None`` the plain host array, untouched."""
    if device is None:
        return host
    view = host.view(StagedColumn)
    view.device_tensor = device
    return view


def stage_layout(cols: Sequence[np.ndarray]) -> Layout:
    """The schema a ring or slot binds to: per column, the dtype and the
    per-row shape (never the batch length)."""
    return tuple((str(c.dtype), tuple(c.shape[1:])) for c in cols)


class StagingRing:
    """Power-of-two columnar ring buffer: one circular array per column.

    The queue, under its admission lock, owns every ``alloc``; writes to
    disjoint index ranges are numpy slice stores and may race with reads of
    other ranges. The layout binds on the first write and again only through
    :meth:`bind` (which the queue allows with no live row).
    """

    def __init__(self, capacity_rows: int) -> None:
        if int(capacity_rows) < 1:
            raise ValueError(f"capacity_rows must be >= 1, got {capacity_rows}")
        self.capacity = _pow2_at_least(int(capacity_rows))
        self._mask = self.capacity - 1
        self.head = 0  # next sequence number to allocate
        self.layout: Optional[Layout] = None
        self.ids: Optional[np.ndarray] = None
        self.t_submit: Optional[np.ndarray] = None
        self.cohorts: Optional[np.ndarray] = None
        self.cols: List[np.ndarray] = []

    @property
    def bound(self) -> bool:
        return self.layout is not None

    def bind(self, layout: Layout) -> None:
        """(Re)allocate every column buffer for ``layout``."""
        self.layout = layout
        self.ids = np.empty(self.capacity, dtype=np.int32)
        self.t_submit = np.empty(self.capacity, dtype=np.float64)
        self.cohorts = np.empty(self.capacity, dtype=object)
        self.cols = [np.zeros((self.capacity,) + shape, dtype=dtype) for dtype, shape in layout]

    def alloc(self, n: int = 1) -> int:
        """Reserve ``n`` consecutive sequence numbers; returns the first."""
        seq0 = self.head
        self.head += n
        return seq0

    def write_row(self, seq: int, tenant: int, t: float, cohort: Optional[str], values: Sequence[Any]) -> None:
        i = seq & self._mask
        self.ids[i] = tenant
        self.t_submit[i] = t
        self.cohorts[i] = cohort
        for buf, v in zip(self.cols, values):
            buf[i] = v

    def write_rows(
        self, seq0: int, tenants: np.ndarray, t: float, cohort: Optional[str], columns: Sequence[np.ndarray]
    ) -> None:
        """Bulk write ``len(tenants)`` rows at ``[seq0, seq0 + n)``: at most
        two slice stores per column (the wraparound split)."""
        n = int(tenants.shape[0])
        if n == 0:
            return
        i = seq0 & self._mask
        k = min(n, self.capacity - i)
        self.ids[i:i + k] = tenants[:k]
        self.t_submit[i:i + k] = t
        self.cohorts[i:i + k] = cohort
        for buf, col in zip(self.cols, columns):
            buf[i:i + k] = col[:k]
        if k < n:
            rest = n - k
            self.ids[:rest] = tenants[k:]
            self.t_submit[:rest] = t
            self.cohorts[:rest] = cohort
            for buf, col in zip(self.cols, columns):
                buf[:rest] = col[k:]

    def read_ids(self, seq0: int, n: int) -> np.ndarray:
        """A copy of the id column for ``[seq0, seq0 + n)``."""
        out = np.empty(n, dtype=np.int32)
        i = seq0 & self._mask
        k = min(n, self.capacity - i)
        out[:k] = self.ids[i:i + k]
        if k < n:
            out[k:] = self.ids[: n - k]
        return out

    def copy_out(self, seq0: int, n: int, slot: "StagingSlot") -> None:
        """Copy rows ``[seq0, seq0 + n)`` into ``slot``'s leading rows: one
        or two contiguous slice copies per column."""
        i = seq0 & self._mask
        k = min(n, self.capacity - i)
        slot.ids[:k] = self.ids[i:i + k]
        slot.t_submit[:k] = self.t_submit[i:i + k]
        slot.cohorts[:k] = self.cohorts[i:i + k]
        for dst, src in zip(slot.cols, self.cols):
            dst[:k] = src[i:i + k]
        if k < n:
            rest = n - k
            slot.ids[k:n] = self.ids[:rest]
            slot.t_submit[k:n] = self.t_submit[:rest]
            slot.cohorts[k:n] = self.cohorts[:rest]
            for dst, src in zip(slot.cols, self.cols):
                dst[k:n] = src[:rest]

    def __getstate__(self) -> Dict[str, Any]:
        return {"capacity": self.capacity}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(state["capacity"])


def _host_buffer(shape: Tuple[int, ...], dtype: str, pin: bool) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """A zeroed host buffer: a pinned tensor and its numpy view when
    ``pin``, else a plain numpy array and ``None``."""
    if not pin:
        return np.zeros(shape, dtype=dtype), None
    tensor = torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype=dtype)).dtype, pin_memory=True)
    return tensor.numpy(), tensor


class StagingSlot:
    """One reusable cohort-sized buffer set (``rows`` rows per column).

    With ``pin`` the id and update columns are pinned host tensors
    (``tensors``: ids first), their numpy views in ``ids``/``cols``;
    ``event`` is the side-stream event of the slot's last copy to the card.
    """

    __slots__ = ("index", "generation", "rows", "ids", "t_submit", "cohorts", "cols", "tensors", "event")

    def __init__(self, index: int, generation: int, rows: int, layout: Layout, pin: bool = False) -> None:
        self.index = index
        self.generation = generation
        self.rows = rows
        self.ids, ids_tensor = _host_buffer((rows,), "int32", pin)
        self.t_submit = np.empty(rows, dtype=np.float64)
        self.cohorts = np.empty(rows, dtype=object)
        buffers = [_host_buffer((rows,) + shape, dtype, pin) for dtype, shape in layout]
        self.cols = [host for host, _ in buffers]
        self.tensors: Optional[List[torch.Tensor]] = [ids_tensor] + [t for _, t in buffers] if pin else None
        self.event: Optional[Any] = None

    def wait_copied(self) -> None:
        """Block until the slot's last copy to the card has finished, so
        refilling the pinned buffer cannot change bytes still in flight.
        Waits on the copy's event only, never on the compute."""
        event, self.event = self.event, None
        if event is not None and not event.query():
            event.synchronize()


class StagingSlotPool:
    """A bounded pool of :class:`StagingSlot`: the double-buffer depth.

    ``acquire`` blocks until a slot frees (``try_acquire`` never blocks: the
    prefetcher skips a cycle rather than stall the flusher). Slots are made
    against the bound layout when first taken; a re-bind bumps the
    generation so stale slots are made again. ``pin`` makes pinned slots.
    """

    def __init__(self, num_slots: int, rows: int, pin: bool = False) -> None:
        if int(num_slots) < 2:
            raise ValueError(f"staging needs >= 2 slots to double-buffer, got {num_slots}")
        self.num_slots = int(num_slots)
        self.rows = int(rows)
        self.pin = bool(pin)
        self._cv = threading.Condition()
        self._free: List[int] = list(range(self.num_slots))
        self._slots: List[Optional[StagingSlot]] = [None] * self.num_slots
        self._layout: Optional[Layout] = None
        self._generation = 0

    def bind(self, layout: Layout) -> None:
        with self._cv:
            self._layout = layout
            self._generation += 1

    def _make(self, index: int) -> StagingSlot:
        slot = StagingSlot(index, self._generation, self.rows, self._layout or (), self.pin)
        self._slots[index] = slot
        return slot

    def _take_locked(self) -> StagingSlot:
        idx = self._free.pop()
        slot = self._slots[idx]
        if slot is None or slot.generation != self._generation:
            slot = self._make(idx)
        return slot

    def acquire(self, timeout: Optional[float] = None) -> Optional[StagingSlot]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._free:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)
            return self._take_locked()

    def try_acquire(self) -> Optional[StagingSlot]:
        with self._cv:
            if not self._free:
                return None
            return self._take_locked()

    def refresh(self, slot: StagingSlot) -> StagingSlot:
        """Make a checked-out slot again against the current layout when a
        bind raced its acquire (a flusher takes its slot before it pops, so
        the first submit's bind can land in between); a no-op when current."""
        with self._cv:
            return slot if slot.generation == self._generation else self._make(slot.index)

    def release(self, slot: StagingSlot) -> None:
        with self._cv:
            self._free.append(slot.index)
            self._cv.notify()

    def in_use(self) -> int:
        with self._cv:
            return self.num_slots - len(self._free)

    def __getstate__(self) -> Dict[str, Any]:
        return {"num_slots": self.num_slots, "rows": self.rows, "pin": self.pin}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(state["num_slots"], state["rows"], state.get("pin", False))


class StagedCohort:
    """One staged cohort ready to dispatch: slot-backed views and twins.

    ``ids``/``cols`` are what the target receives (:class:`StagedColumn`
    views when the copy ran, owning numpy copies otherwise); ``n`` is the
    row count after quarantine, ``bucket`` the padded length. ``event`` is
    the side-stream event the dispatch's stream waits on (``None`` off the
    card). ``stage_window`` is the ``(t0, t1)`` perf-counter interval of the
    staging work, which the overlap ledger intersects with the concurrent
    dispatch.
    """

    __slots__ = ("slot", "n", "bucket", "ids", "cols", "t_submits", "cohorts", "stage_window", "event")

    def __init__(
        self,
        slot: StagingSlot,
        n: int,
        bucket: int,
        ids: np.ndarray,
        cols: List[np.ndarray],
        t_submits: np.ndarray,
        cohorts: Sequence[Optional[str]],
        stage_window: Tuple[float, float],
        event: Optional[Any] = None,
    ) -> None:
        self.slot = slot
        self.n = n
        self.bucket = bucket
        self.ids = ids
        self.cols = cols
        self.t_submits = t_submits
        self.cohorts = cohorts
        self.stage_window = stage_window
        self.event = event
