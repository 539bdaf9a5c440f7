"""Fixed-capacity sample buffer behind the ``capacity=`` metric modes.

Counterpart of ``metrics_tpu/utilities/capped_buffer.py``. A preallocated
buffer plus a fill counter gives a state of fixed shape, which a compiled
step (``jit_forward``, ``update_many``; one CUDA graph on the card) threads
without a new capture per step, syncs with one gather of the buffer and one
of the counter, and drops (with a warning, or an error) samples past the
capacity.

Layout, as in the JAX package: scores and labels ride ONE flat float32
buffer of ``(capacity + slack) * width`` elements (row-major ``(rows,
width)``, ``width`` = score columns + label columns). The ``slack`` rows
give exact drop-past-capacity semantics without masking: a write's start
row is clamped to ``capacity + slack - rows``, so an overflowing write lands
in the slack zone, which :meth:`CappedBufferMixin._buffer_flatten` never
reads, instead of over the tail of the real data. A batch of more than
``slack`` rows is written in chunks of ``slack`` rows.

Where the JAX package writes with ``lax.dynamic_update_slice`` at a device
offset, the port computes the written positions on the device (``count +
arange``, clamped as above) and ``index_copy``s the batch there: no value is
read to the host, so the write can be captured. The counter keeps the true
total; the ``overflow="error"`` policy raises :class:`BufferOverflowError`
at the next eager ``compute()``, where the counter is read.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.data import Tensor, _is_traced, dim_zero_cat, to_host
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.prints import rank_zero_warn

#: upper bound on the overflow landing zone, in rows; the per-instance slack
#: is ``min(capacity, BUF_SLACK_ROWS)``, and it doubles as the chunk size for
#: oversized batches
BUF_SLACK_ROWS = 4096

#: what a capacity-mode metric does when the stream exceeds the buffer
OVERFLOW_POLICIES = ("warn", "error")


class BufferOverflowError(RuntimeError):
    """An exact-mode ``capacity=`` buffer received more samples than it can
    hold and the metric was built with ``overflow="error"``.

    Raised at the first eager read of the fill counters (``compute()``,
    also after compiled ``jit_forward``/``update_many`` steps, inside which
    nothing is read to the host)."""


def _check_capacity(capacity: int) -> None:
    if not (isinstance(capacity, int) and capacity > 0):
        raise ValueError(f"`capacity` should be a positive integer, got: {capacity}")


def _check_overflow_policy(overflow: str) -> str:
    if overflow not in OVERFLOW_POLICIES:
        raise ValueError(f"`overflow` should be one of {OVERFLOW_POLICIES}, got: {overflow!r}")
    return overflow


def _write_rows(buf: Tensor, count: Tensor, rows: Tensor, width: int, total_rows: int, slack: int) -> Tensor:
    """``buf`` with the ``(n, width)`` ``rows`` written from row ``count`` on,
    in chunks of at most ``slack`` rows whose start row is clamped to
    ``total_rows - chunk``: positions computed on the device, no host read."""
    flat = rows.reshape(-1)
    n = rows.shape[0]
    base = count.to(torch.int64)
    for i in range(0, n, slack):
        chunk = min(slack, n - i)  # static: from the shape
        start = torch.clamp(base + i, max=total_rows - chunk) * width
        index = start + torch.arange(chunk * width, device=buf.device)
        buf = buf.index_copy(0, index, flat[i * width:(i + chunk) * width])
    return buf


def init_feature_buffer(
    capacity: int, dim: int, dtype: torch.dtype = torch.float32, device: torch.device = torch.device("cpu")
) -> Tuple[Tensor, int]:
    """Preallocated ``(capacity + slack, dim)`` row buffer for feature
    metrics; returns ``(buffer, slack_rows)``."""
    _check_capacity(capacity)
    slack = min(capacity, BUF_SLACK_ROWS)
    return torch.zeros((capacity + slack, dim), dtype=dtype, device=device), slack


def feature_buffer_write(buf: Tensor, count: Tensor, feats: Tensor, capacity: int, slack: int) -> Tuple[Tensor, Tensor]:
    """Append ``(N, dim)`` rows at the fill offset; overflow rows land in the
    slack zone (dropped), the counter keeps the true total."""
    dim = buf.shape[1]
    flat = _write_rows(buf.reshape(-1), count, feats.to(buf.dtype), dim, capacity + slack, slack)
    return flat.reshape(buf.shape), count + feats.shape[0]


def feature_buffer_read(buf, count, capacity: int, slack: int, owner: str = "metric") -> Tensor:
    """Valid rows across however many shards the sync produced (eager only:
    the row count is read). Takes the local ``(capacity+slack, d)`` buffer
    with a scalar count, a stacked ``(world, capacity+slack, d)`` buffer
    with a ``(world,)`` count, a row-concatenated ``(world·(capacity+slack),
    d)`` buffer, and lists of shards. Warns when rows were dropped."""
    bufs = buf if isinstance(buf, list) else [buf]
    raw_counts = count if isinstance(count, list) else [count]
    if _is_traced(*raw_counts, *bufs):
        raise NotImplementedError(
            f"{owner}: `capacity` mode computes on concrete (non-traced) state —"
            " the valid-row count is data-dependent. Call compute()/apply_compute"
            " outside a compiled program (the fixed-shape part is the update path)."
        )
    counts = to_host(torch.cat([torch.atleast_1d(torch.as_tensor(c)).reshape(-1).cpu() for c in raw_counts]))
    rows_per_shard = capacity + slack
    shards = []
    for b in bufs:
        if b.ndim == 3 and b.shape[1] == rows_per_shard:
            shards.extend(b)
        elif b.ndim == 2 and b.shape[0] == rows_per_shard:
            shards.append(b)
        elif b.ndim == 2 and b.shape[0] % rows_per_shard == 0:
            shards.extend(b.reshape(-1, rows_per_shard, b.shape[-1]))
        else:
            raise ValueError(
                f"{owner}: synced buffer shape {tuple(b.shape)} does not decompose"
                f" into (capacity+slack={rows_per_shard}, dim) shards"
            )
    if len(shards) != len(counts):
        raise ValueError(f"{owner}: {len(shards)} buffer shard(s) but {len(counts)} count(s) after sync")
    dropped = sum(max(int(c) - capacity, 0) for c in counts)
    if dropped > 0:
        rank_zero_warn(
            f"{owner}(capacity={capacity}) dropped {dropped} feature rows past"
            " the buffer capacity; the computed value covers the first"
            " `capacity` rows per shard.",
            UserWarning,
        )
    return torch.cat([b[: min(int(c), capacity)] for b, c in zip(shards, counts)], dim=0)


class CappedBufferMixin:
    """State, update and mask logic shared by the fixed-capacity modes.

    Scores and labels merge into ONE buffer (see the module docstring);
    labels live in the score dtype, exact for class indices and binary
    flags far below float32's 2**24.
    """

    _capacity_multilabel = False
    #: classification modes cast the label columns back to int32 at flatten
    _capacity_int_target = True
    #: "warn" drops past-capacity samples with a warning; "error" raises
    #: BufferOverflowError at the first eager read of an overflowed counter
    _buf_overflow_policy = "warn"

    def _init_capacity_states(
        self,
        capacity: int,
        num_classes: Optional[int],
        pos_label: Optional[int],
        multilabel: bool = False,
        overflow: str = "warn",
    ) -> None:
        """Validate the capacity-mode configuration and register the buffer
        state. ``num_classes > 1`` switches to the multi-column layout: ``C``
        score columns with one class-label column (multiclass, one-vs-rest
        at compute) or ``C`` per-label binary columns (``multilabel=True``)."""
        _check_capacity(capacity)
        multi = num_classes is not None and num_classes > 1
        if multilabel and not multi:
            raise ValueError(
                f"multilabel `capacity` mode needs `num_classes` > 1 (the label count), got {num_classes}"
            )
        if not multi and pos_label not in (None, 0, 1):
            raise ValueError(f"`capacity` mode expects `pos_label` in (0, 1), got: {pos_label}")
        if multi and pos_label is not None:
            raise ValueError("`pos_label` does not apply to multi-column `capacity` mode")
        self._capacity_multilabel = multilabel
        self._capacity_int_target = True
        self._buf_overflow_policy = _check_overflow_policy(overflow)
        if multi:
            width = 2 * num_classes if multilabel else num_classes + 1
        else:
            width = 2
        self._buf_width = width
        self._buf_slack = min(capacity, BUF_SLACK_ROWS)
        total = (capacity + self._buf_slack) * width
        self.add_state("buf", torch.full((total,), float("-inf"), dtype=torch.float32), dist_reduce_fx="cat")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="cat")

    @property
    def _capacity_multiclass(self) -> bool:
        num_classes = getattr(self, "num_classes", None)
        return num_classes is not None and num_classes > 1 and not self._capacity_multilabel

    @property
    def _capacity_score_cols(self) -> int:
        """Leading buffer columns holding scores (the rest hold labels)."""
        if self._capacity_multiclass or self._capacity_multilabel:
            return self.num_classes
        return 1

    def _init_raw_buffer_states(self, capacity: int, dtype: torch.dtype = torch.float32, overflow: str = "warn") -> None:
        """Raw-value variant: preds/target kept verbatim (no canonicalization)."""
        _check_capacity(capacity)
        self._buf_overflow_policy = _check_overflow_policy(overflow)
        self._capacity_int_target = False
        self._buf_width = 2
        self._buf_slack = min(capacity, BUF_SLACK_ROWS)
        total = (capacity + self._buf_slack) * 2
        self.add_state("buf", torch.zeros((total,), dtype=dtype), dist_reduce_fx="cat")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="cat")

    def _buffer_write(self, preds: Tensor, target: Tensor) -> None:
        """Append one batch at the fill offset (``capped_buffer.py:237-258``);
        positions past capacity drop into the slack zone, the counter keeps
        the true total."""
        dtype = self.buf.dtype
        p = preds if preds.ndim == 2 else preds.reshape(-1, 1)
        t = target if target.ndim == 2 else target.reshape(-1, 1)
        rows = torch.cat([p.to(dtype), t.to(dtype)], dim=-1)
        n = rows.shape[0]
        self.buf = _write_rows(self.buf, self.count, rows, self._buf_width, self.capacity + self._buf_slack,
                               self._buf_slack)
        self.count = self.count + n

    def _raw_buffer_update(self, preds: Tensor, target: Tensor) -> None:
        self._buffer_write(torch.atleast_1d(preds), torch.atleast_1d(target))

    def _buffer_update(self, preds: Tensor, target: Tensor) -> None:
        from metrics_tpu_torch.functional.classification.auroc import _auroc_update

        preds, target, mode = _auroc_update(preds, target)
        if self._capacity_multilabel:
            if mode != DataType.MULTILABEL or preds.ndim != 2 or preds.shape[1] != self.num_classes:
                raise ValueError(
                    f"multilabel `capacity` mode with num_classes={self.num_classes} expects"
                    f" (N, C) scores and (N, C) binary labels, got mode {mode} with preds shape {tuple(preds.shape)}"
                )
            target = (target == 1).to(torch.int32)
        elif self._capacity_multiclass:
            if mode != DataType.MULTICLASS or preds.ndim != 2 or preds.shape[1] != self.num_classes:
                raise ValueError(
                    f"`capacity` mode with num_classes={self.num_classes} expects (N, C) class scores"
                    f" and (N,) labels, got mode {mode} with preds shape {tuple(preds.shape)}"
                )
            target = target.to(torch.int32)
        else:
            if mode != DataType.BINARY:
                raise ValueError(f"`capacity` mode supports binary inputs only, got mode {mode}")
            pos_label = 1 if self.pos_label is None else self.pos_label
            target = (target == pos_label).to(torch.int32)
        self._buffer_write(preds.to(torch.float32), target)

    def _buffer_flatten(self) -> Tuple[Tensor, Tensor, Tensor]:
        """``(flat preds, flat target, valid mask)`` across however many
        shards the sync produced: a scalar count is one shard, ``(world,)``
        counts are ``world`` shards of ``capacity`` samples each. Multiclass
        preds keep their class axis: ``(world·capacity, C)``. Outside a
        compiled program the counters are read here, and an overflow warns
        or raises (``overflow="error"``)."""
        buf = dim_zero_cat(self.buf) if isinstance(self.buf, list) else self.buf
        count = self.count
        if isinstance(count, list):
            count = torch.stack([torch.as_tensor(c) for c in count])
        counts = torch.atleast_1d(count).reshape(-1)

        if not _is_traced(counts):
            received, overflow = to_host(torch.stack(
                [counts.to(torch.int64).sum(), torch.clamp(counts.to(torch.int64) - self.capacity, min=0).sum()]
            ))
            if overflow > 0:
                if self._buf_overflow_policy == "error":
                    raise BufferOverflowError(
                        f"{self.__class__.__name__}(capacity={self.capacity}) overflowed:"
                        f" {int(overflow)} sample(s) past the buffer capacity"
                        f" ({int(received)} received in total). This metric"
                        ' was built with overflow="error", so the truncated stream is an'
                        " error instead of a silently approximate value. Raise `capacity`,"
                        " reset() more often, or switch to the bounded-memory"
                        " `sketched=True` mode if the metric offers one."
                    )
                rank_zero_warn(
                    f"{self.__class__.__name__}(capacity={self.capacity}) dropped {int(overflow)}"
                    " samples past the buffer capacity; the computed value covers the first"
                    " `capacity` samples per shard.",
                    UserWarning,
                )

        positions = torch.arange(self.capacity, device=counts.device)
        valid = (positions[None, :] < torch.clamp(counts, 0, self.capacity)[:, None]).reshape(-1)
        width = self._buf_width
        # (shards, rows, width) view; the slack zone past `capacity` is never read
        rows = buf.reshape(-1, self.capacity + self._buf_slack, width)[:, : self.capacity, :]
        flat = rows.reshape(-1, width)
        ncols = self._capacity_score_cols
        preds_flat = flat[:, :ncols]
        target_flat = flat[:, ncols:]
        if preds_flat.shape[-1] == 1:
            preds_flat = preds_flat[:, 0]
        if target_flat.shape[-1] == 1:
            target_flat = target_flat[:, 0]
        if self._capacity_int_target:
            target_flat = target_flat.to(torch.int32)
        return preds_flat, target_flat, valid

    def _per_label_targets(self, target: Tensor) -> Tensor:
        """``(M, C)`` binary targets: the per-label columns as they are, or
        the one-hot of ``(M,)`` class labels (one class against the rest)."""
        if target.ndim == 2:
            return target
        classes = torch.arange(self.num_classes, device=target.device)
        return (target[:, None] == classes[None, :]).to(torch.int32)

    def _one_vs_rest(self, kernel, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        """A masked curve kernel per class/label: ``(C,)`` values. The kernels
        take the ``(M, C)`` columns at once (``capped_buffer.py:329``)."""
        return kernel(preds, self._per_label_targets(target), valid)

    def _check_degenerate_classes(self, target: Tensor, valid: Tensor) -> Optional[Tensor]:
        """Raise on degenerate (single-class) eager buffers; return the
        per-class supports of a multi-column buffer for weighted averaging.
        Inside a compiled program nothing can be read and the masked kernels
        give the 0/0 NaN instead. An empty buffer is not degenerate."""
        if _is_traced(target, valid):
            return None
        supports = None
        if target.ndim == 2 or self._capacity_multiclass:
            supports = self._class_supports(target, valid)
            pos = supports
        else:
            pos = torch.sum(torch.where(valid, (target == 1).to(torch.float32), 0.0)).reshape(1)
        n_valid, *pos_counts = to_host(torch.cat([torch.sum(valid).to(torch.float32).reshape(1), pos]))
        if n_valid == 0:
            return None
        for p in pos_counts:
            if p == n_valid:  # negatives-first, like the reference
                raise ValueError("No negative samples in targets, false positive value should be meaningless")
            if p == 0:
                raise ValueError("No positive samples in targets, true positive value should be meaningless")
        return supports

    def _class_supports(self, target: Tensor, valid: Tensor) -> Tensor:
        """Valid positive count per class/label (for weighted averaging)."""
        return torch.sum(self._per_label_targets(target) * valid[:, None], dim=0).to(torch.float32)
