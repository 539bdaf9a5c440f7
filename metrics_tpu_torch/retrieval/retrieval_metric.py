"""RetrievalMetric base class.

Counterpart of ``metrics_tpu/retrieval/retrieval_metric.py``, in its three
modes:

* **Flat** (``indexes`` given): list states; ``compute()`` groups the stream
  into a ``(num_queries, max_len)`` layout sorted by query, then by
  descending score, and scores every query at once with the
  ``_*_from_sorted`` row functions of the functional API. The empty-query
  policies are masks. The JAX package groups with numpy on the host; here
  the grouping runs on the metric's device (``torch.unique``, two stable
  sorts, one scatter), with one host read of the longest query to size the
  layout, since copying millions of rows to the host would cost more than
  the work. Score ties keep arrival order and NaN scores go last, as
  numpy's ``lexsort((-preds, inverse))`` orders them.
* **Padded** (``padded=True``): each ``(Q, D)`` row is one query, with a
  ``mask`` of its valid entries. The batch is scored at update into two
  ``"sum"`` states (a float32 value sum, an int32 query count), so the fused
  forward, the compiled step and the keyed update apply. Each row sorts by
  (valid first, then descending score) as two stable sorts, so a real
  ``-inf`` score stays ahead of the padding. Fully masked rows are
  query-axis padding and count as no query.
* **Sketched** (``sketched=True``): a fixed ``sketch_capacity``-row
  reservoir of whole queries, kept by the smallest
  ``(uniform_hash(query id), query id)`` (``kernels/sketches.py``), merged
  at sync by the ``"cat"`` gather. Its update has no host read and can be
  captured; ``compute()`` scores the queries every shard holds complete.
"""
import math
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.retrieval.precision import _check_k
from metrics_tpu_torch.kernels.sketches import bounded_priority_keep, uniform_hash
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import _check_retrieval_inputs
from metrics_tpu_torch.utilities.data import Tensor, _is_traced, dim_zero_cat, to_host
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.sketching import SketchTelemetryMixin


class RetrievalMetric(SketchTelemetryMixin, Metric, ABC):
    """Base for information-retrieval metrics over ``(preds, target, indexes)``.

    ``indexes`` maps each prediction to its query; scores are grouped by
    query, scored per query by the subclass's row function, and averaged.

    Args:
        empty_target_action: what to do with queries having no positive (for
            fall-out: no negative) target — ``'neg'`` score 0, ``'pos'`` score
            1, ``'skip'`` drop the query, ``'error'`` raise.
        padded: take ``(Q, D)`` query rows with a ``mask`` and score them at
            update into two scalar ``"sum"`` states.
        sketched: keep a fixed ``sketch_capacity``-row reservoir of whole
            queries in place of the flat mode's lists; ``compute()`` scores
            the sampled queries, an unbiased estimate of the all-queries mean
            with O(1/sqrt(kept queries)) noise.
        sketch_capacity: reservoir size in rows (default 8192).
        k: score only each query's top ``k`` predictions (``None``: all);
            only subclasses with ``_uses_k`` accept it.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    #: the flat and sketched compute groups a whole epoch's stream
    _fusable = False
    #: targets may hold graded relevance (nDCG) instead of binary labels
    allow_non_binary_target: bool = False
    #: queries are "empty" when they lack this kind of target (fall-out: negatives)
    _empty_relevance: str = "positive"
    #: whether this metric has @k semantics (MAP/MRR do not)
    _uses_k: bool = False

    _sketch_hint = (
        "Alternatively, the sketched=True mode keeps a fixed-size query"
        " reservoir (bounded memory, fixed-size sync payloads), and padded=True"
        " scores (Q, D) query rows into two scalar states."
    )

    def __init__(
        self,
        empty_target_action: str = "neg",
        padded: bool = False,
        sketched: bool = False,
        sketch_capacity: int = 8192,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        k: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"`empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        self.padded = padded
        self.sketched = sketched

        if k is not None and not self._uses_k:
            raise TypeError(f"{self.__class__.__name__} does not accept `k`")
        _check_k(k)
        self.k = k

        if sketched and padded:
            raise ValueError(
                "`sketched` applies to the flat `indexes` mode; `padded=True` already"
                " has O(1) streaming state and needs no reservoir"
            )

        if padded:
            if empty_target_action == "error":
                raise ValueError(
                    "`padded=True` cannot raise per-query inside a compiled program;"
                    " use empty_target_action 'neg', 'pos' or 'skip'"
                )
            # streaming scalars merge: the fused single-update forward applies
            self._fusable = True
            self.add_state("value_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("query_total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        elif sketched:
            if not (isinstance(sketch_capacity, int) and sketch_capacity > 0):
                raise ValueError(
                    f"`sketch_capacity` should be a positive integer, got: {sketch_capacity}"
                )
            self.sketch_capacity = sketch_capacity
            # fixed-shape reservoir columns: priority key (+inf = empty slot),
            # query id, score, relevance; "cat" gathers one fixed-size slice
            # per column, "sum" adds the row counter
            self.add_state("res_key", torch.full((sketch_capacity,), math.inf, dtype=torch.float32),
                           dist_reduce_fx="cat")
            self.add_state("res_qid", torch.zeros((sketch_capacity,), dtype=torch.int32), dist_reduce_fx="cat")
            self.add_state("res_pred", torch.zeros((sketch_capacity,), dtype=torch.float32), dist_reduce_fx="cat")
            self.add_state("res_target", torch.zeros((sketch_capacity,), dtype=torch.float32), dist_reduce_fx="cat")
            self.add_state("res_seen", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            # (1,)-shaped so the "cat" gather gives one flag per shard
            self.add_state("res_overflow", torch.zeros((1,), dtype=torch.float32), dist_reduce_fx="cat")
        else:
            self.add_state("indexes", default=[], dist_reduce_fx=None)
            self.add_state("preds", default=[], dist_reduce_fx=None)
            self.add_state("target", default=[], dist_reduce_fx=None)

    def _resolve_k(self, lengths: Tensor) -> Any:
        """``k`` per query: the configured top-k or each query's full length."""
        return lengths if self.k is None else self.k

    def update(
        self,
        preds: Tensor,
        target: Tensor,
        indexes: Optional[Tensor] = None,
        mask: Optional[Tensor] = None,
    ) -> None:
        """Validate, flatten and append one batch of (preds, target, indexes);
        with ``padded=True``, score ``(Q, D)`` query rows at once."""
        if self.padded:
            self._update_padded(preds, target, mask)
            return

        if indexes is None:
            raise ValueError("`indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target
        )
        if self.sketched:
            self._reservoir_update(indexes, preds, target)
            return
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    # -- the sketched mode ---------------------------------------------------------

    def _reservoir_update(self, indexes: Tensor, preds: Tensor, target: Tensor) -> None:
        """Push one flat batch into the fixed-size query reservoir.

        Every row's priority is ``uniform_hash(query id)``, the same wherever
        and whenever the row arrives, and the buffer keeps the
        ``sketch_capacity`` smallest, so eviction removes whole queries from
        the top of the priority order. No host read; the row counter keeps
        the true total so compute can tell whether sampling occurred."""
        keys = torch.cat([self.res_key, uniform_hash(indexes)])
        qids = torch.cat([self.res_qid, indexes])
        spreds = torch.cat([self.res_pred, preds.to(torch.float32)])
        stargets = torch.cat([self.res_target, target.to(torch.float32)])
        overflowed = torch.sum(~torch.isinf(keys)) > self.sketch_capacity
        self.res_key, self.res_qid, (self.res_pred, self.res_target) = bounded_priority_keep(
            keys, qids, (spreds, stargets), self.sketch_capacity
        )
        self.res_seen = self.res_seen + indexes.shape[0]
        self.res_overflow = torch.maximum(self.res_overflow, overflowed.to(torch.float32))

    def _reservoir_rows(self) -> Tuple[Tensor, Tensor, Tensor]:
        """The complete queries of the (possibly multi-shard) reservoir:
        ``(indexes, preds, target)``, with the drop accounting.

        Eviction removes the largest priorities first, so on any shard that
        ever overflowed every query with a priority below that shard's
        largest kept priority is fully present. The cut-off is the smallest
        of the shards' largest kept priorities (a shard that never
        overflowed gives +inf); rows at or above it may be partial queries
        and are dropped."""
        cap = self.sketch_capacity
        # after a sync each column holds one slice per shard
        key, qid, pred, targ, flags = (
            getattr(self, name).reshape(-1) for name in ("res_key", "res_qid", "res_pred", "res_target", "res_overflow")
        )
        if _is_traced(key, qid, pred, targ):
            raise NotImplementedError(
                f"{self.__class__.__name__}: `sketched` mode computes on concrete"
                " (non-traced) state — the kept-query set is data-dependent. Call"
                " compute()/apply_compute outside the compiled step (the fixed-shape"
                " part is the update path)."
            )
        keys = key.reshape(-1, cap)
        full = flags > 0
        cutoff = torch.min(torch.where(full, torch.amax(keys, dim=1), math.inf))
        keep = key < cutoff
        shards = keys.shape[0]
        kept_qids = qid[keep]
        queries_kept = int(torch.unique(kept_qids).numel())
        counts = (torch.sum(~keep & ~torch.isinf(key)), full.any(), self.res_seen, torch.sum(keep))
        dropped_rows, any_full, rows_seen, rows_kept = to_host(torch.stack([c.to(torch.int64) for c in counts]))
        if dropped_rows > 0 or any_full:
            rank_zero_warn(
                f"{self.__class__.__name__}(sketched=True, sketch_capacity={cap})"
                f" sampled the query stream: scoring {queries_kept}"
                f" complete queries out of {rows_seen} seen rows"
                " (the value is an unbiased estimate over a uniform query sample;"
                " raise `sketch_capacity` to tighten it).",
                UserWarning,
            )
        self._count_sketch_merges(shards - 1)
        self._publish_sketch_info(
            kind="reservoir",
            capacity=cap,
            rows_seen=float(rows_seen),
            rows_kept=rows_kept,
            queries_kept=queries_kept,
            overflow=dropped_rows,
        )
        return kept_qids, pred[keep], targ[keep]

    # -- the padded mode -------------------------------------------------------------

    def _padded_mask(self, preds: Tensor, target: Tensor, mask: Optional[Tensor]) -> Tensor:
        """Shape, dtype and value checks of a padded batch; returns the mask
        (all valid when none is given). The targets' values are read to the
        host once, unless no value can be read."""
        if preds.ndim != 2 or preds.shape != target.shape:
            raise ValueError(f"`padded=True` expects (Q, D) preds/target of equal shape, got {tuple(preds.shape)}")
        if mask is None:
            mask = torch.ones(preds.shape, dtype=torch.bool, device=preds.device)
        mask = mask.to(torch.bool)
        if mask.shape != preds.shape:
            raise ValueError(f"`mask` must match preds shape {tuple(preds.shape)}, got {tuple(mask.shape)}")
        if not preds.is_floating_point():
            raise ValueError("`preds` must be a tensor of floats")
        if not self.allow_non_binary_target and not _is_traced(preds, target, mask):
            valid = torch.where(mask, target, 0)
            if bool(to_host(torch.any((valid != 0) & (valid != 1)))):
                raise ValueError("`target` must contain `binary` values")
        return mask

    def _validate_batch(self, preds: Tensor, target: Tensor, indexes: Optional[Tensor] = None,
                        mask: Optional[Tensor] = None) -> None:
        """The keyed path's checks of a whole padded batch (inside its
        per-row vmap no value can be read)."""
        if self.padded:
            self._padded_mask(preds, target, mask)

    def _update_padded(self, preds: Tensor, target: Tensor, mask: Optional[Tensor]) -> None:
        """Score one ``(Q, D)`` batch of complete queries into the two sums."""
        mask = self._padded_mask(preds, target, mask)
        # each row by (valid first, then descending score), both stable: a
        # real -inf score stays ahead of the padding, ties keep their order
        score = torch.where(mask, preds.to(torch.float32), 0.0)
        order = torch.sort(-score, dim=-1, stable=True).indices
        padding_last = torch.sort(torch.gather(~mask, -1, order).to(torch.uint8), dim=-1, stable=True).indices
        order = torch.gather(order, -1, padding_last)
        target_rows = torch.gather(torch.where(mask, target, 0), -1, order)
        lengths = torch.sum(mask, dim=-1)

        values = self._metric_rows(target_rows, lengths)
        values, counted = self._apply_empty_policy(values, target_rows, lengths)
        # fully masked rows are query-axis padding, not queries
        is_query = lengths > 0
        values = torch.where(is_query, values, 0.0)
        counted = counted & is_query
        self.value_sum = self.value_sum + torch.sum(values).to(self.value_sum.dtype)
        self.query_total = self.query_total + torch.sum(counted).to(torch.int32)

    # -- compute -----------------------------------------------------------------------

    def _relevant(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        """Per query, the count (or graded sum) of the kind of target whose
        absence makes the query empty."""
        if self._empty_relevance == "negative":
            return lengths - torch.sum(target_rows > 0, dim=-1)
        return torch.sum(target_rows, dim=-1)

    def _apply_empty_policy(self, values: Tensor, target_rows: Tensor, lengths: Tensor) -> Tuple[Tensor, Tensor]:
        """(masked values, counted mask) under the empty-query policy."""
        empty = self._relevant(target_rows, lengths) == 0
        if self.empty_target_action == "pos":
            values = torch.where(empty, 1.0, values)
        elif self.empty_target_action in ("neg", "skip"):
            values = torch.where(empty, 0.0, values)
        counted = ~empty if self.empty_target_action == "skip" else torch.ones_like(empty)
        return values, counted

    def _group_into_rows(self) -> Tuple[Tensor, Tensor]:
        """The accumulated stream (or the reservoir's complete queries) as
        ``(num_queries, max_len)`` rows sorted by descending score, with the
        per-query lengths."""
        if self.sketched:
            indexes, preds, target = self._reservoir_rows()
        else:
            indexes = dim_zero_cat(self.indexes)
            preds = dim_zero_cat(self.preds)
            target = dim_zero_cat(self.target)
        return self._group_arrays_into_rows(indexes, preds, target)

    @staticmethod
    def _group_arrays_into_rows(indexes: Tensor, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        """Query-major, score-descending ``(num_queries, max_len)`` target
        rows (zeros past each query's length) and the lengths, on the
        tensors' device: the order of ``np.lexsort((-preds, inverse))``."""
        _, inverse, counts = torch.unique(indexes, sorted=True, return_inverse=True, return_counts=True)
        order = torch.sort(-preds, stable=True).indices
        order = order[torch.sort(inverse[order], stable=True).indices]
        max_len = int(to_host(torch.max(counts)))  # the one host read: the layout's width
        row = inverse[order]
        col = torch.arange(indexes.numel(), device=indexes.device) - (torch.cumsum(counts, 0) - counts)[row]
        target_rows = torch.zeros((counts.numel(), max_len), dtype=target.dtype, device=target.device)
        target_rows[row, col] = target[order]
        return target_rows, counts

    def compute(self) -> Tensor:
        """Mean per-query score with the empty-query policy applied as masks."""
        if self.padded:
            return (self.value_sum / torch.clamp(self.query_total, min=1)).to(torch.float32)

        target_rows, lengths = self._group_into_rows()
        values = self._metric_rows(target_rows, lengths)

        if self.empty_target_action == "error":
            if bool(to_host(torch.any(self._relevant(target_rows, lengths) == 0))):
                kind = self._empty_relevance
                raise ValueError(f"`compute` method was provided with a query with no {kind} target.")
            return torch.mean(values)

        values, counted = self._apply_empty_policy(values, target_rows, lengths)
        kept = torch.sum(counted)
        return torch.where(kept > 0, torch.sum(values) / torch.clamp(kept, min=1), 0.0)

    @abstractmethod
    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        """Score every query at once: ``(num_queries, max_len)`` sorted
        target rows and their true lengths -> ``(num_queries,)`` values."""
