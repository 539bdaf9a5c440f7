"""Sketched-state wiring shared by the ``sketched=True`` curve metrics.

Counterpart of ``metrics_tpu/utilities/sketching.py``:
:class:`HistogramSketchMixin` registers the binned label histograms that
back ``sketched=True`` in ``AUROC``, ``ROC``, ``PrecisionRecallCurve`` and
``AveragePrecision`` (fixed ``(C, num_bins)`` ``pos_hist``/``neg_hist``
float32 ``"sum"`` states plus a scalar ``sketch_clipped`` counter) and
canonicalizes each batch (binary, multiclass one-vs-rest, multilabel) into
one call of :func:`~metrics_tpu_torch.kernels.binned_counts.label_score_histograms`
(the multiclass case hands over its ``(N,)`` class ids in place of their
one-hot), which on the card launches kernel B5.

Because every sketch state is a fixed-shape ``"sum"`` tensor, the sketched
metrics take the fused forward and can be keyed per tenant
(``KeyedMetric``), and their sync adds the histograms whatever the sample
count.

:class:`SketchTelemetryMixin` (``metrics_tpu/utilities/sketching.py:60-85``)
is the sketches' telemetry: a ``sketch_merges`` counter (each state merge
of a fused forward, and the cross-shard merges the retrieval reservoir
counts at compute with :meth:`~SketchTelemetryMixin._count_sketch_merges`)
and the ``info.sketch`` snapshot blob (the histograms' kind, bins, range,
classes and clipped count; the reservoir's capacity and rows and queries
kept), published at compute with the blob's tensor values read to the host
in one read.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.auroc import _auroc_update
from metrics_tpu_torch.kernels.binned_counts import _label_score_histograms_onevsrest, label_score_histograms
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.utilities.data import Tensor, _is_traced, to_host
from metrics_tpu_torch.utilities.enums import DataType

__all__ = ["HistogramSketchMixin", "SketchTelemetryMixin"]


def _check_num_bins(num_bins: int) -> None:
    if not (isinstance(num_bins, int) and num_bins > 1):
        raise ValueError(f"`num_bins` should be an integer > 1, got: {num_bins}")


def _check_range(name: str, rng: Tuple[float, float]) -> Tuple[float, float]:
    try:
        lo, hi = float(rng[0]), float(rng[1])
    except (TypeError, ValueError, IndexError):
        raise ValueError(f"`{name}` should be a (low, high) pair of floats, got: {rng!r}")
    if not lo < hi:
        raise ValueError(f"`{name}` needs low < high, got: {rng!r}")
    return lo, hi


class SketchTelemetryMixin:
    """Telemetry shared by every ``sketched=True`` metric mode."""

    #: set by the concrete metric's sketched-state init
    sketched: bool = False

    def merge_states(self, a, b):  # type: ignore[override]
        merged = super().merge_states(a, b)
        # host-side count only; inside a vmap (a keyed program) or a compiled
        # program nothing counts, as under a JAX trace
        if self.sketched and TELEMETRY.enabled and not _is_traced(*a.values(), *b.values()):
            TELEMETRY.inc(self.telemetry_key, "sketch_merges")
        return merged

    def _count_sketch_merges(self, n: int) -> None:
        """Cross-shard sketch merges performed at compute (eager sync)."""
        if n > 0 and TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "sketch_merges", n)

    def _publish_sketch_info(self, **info) -> None:
        """Publish the ``info.sketch`` snapshot blob. Its tensor values are
        stacked and read to the host in ONE read (the JAX package reads each
        with ``float``); inside a vmap or a compiled program nothing can be
        read, and nothing is published."""
        if not TELEMETRY.enabled:
            return
        tensors = {k: v for k, v in info.items() if isinstance(v, Tensor)}
        if tensors:
            if _is_traced(*tensors.values()):
                return
            values = to_host(torch.stack([v.reshape(()).to(torch.float64) for v in tensors.values()]))
            info = {**info, **dict(zip(tensors, values))}
        TELEMETRY.set_info(self.telemetry_key, "sketch", info)


class HistogramSketchMixin(SketchTelemetryMixin):
    """Binned-label-histogram states and canonicalized update for the
    threshold-curve metrics' ``sketched=True`` mode."""

    _sketch_multilabel = False

    def _init_hist_states(
        self,
        num_bins: int,
        score_range: Tuple[float, float],
        num_classes: Optional[int],
        pos_label: Optional[int],
        multilabel: bool = False,
    ) -> None:
        """Validate the sketched configuration and register the histogram
        states: ``pos_hist``/``neg_hist`` of shape ``(C, num_bins)`` (C = 1
        for binary) plus the scalar out-of-range counter, all ``"sum"``."""
        _check_num_bins(num_bins)
        lo, hi = _check_range("score_range", score_range)
        multi = num_classes is not None and num_classes > 1
        if multilabel and not multi:
            raise ValueError(
                f"multilabel `sketched` mode needs `num_classes` > 1 (the label count), got {num_classes}"
            )
        if not multi and pos_label not in (None, 0, 1):
            raise ValueError(f"`sketched` mode expects `pos_label` in (0, 1), got: {pos_label}")
        if multi and pos_label is not None:
            raise ValueError("`pos_label` does not apply to multi-class `sketched` mode")
        self._sketch_multilabel = multilabel
        self._sketch_bins = num_bins
        self._sketch_range = (lo, hi)
        width = num_classes if multi else 1
        for name in ("pos_hist", "neg_hist"):
            self.add_state(name, torch.zeros((width, num_bins), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("sketch_clipped", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    @property
    def _sketch_multiclass(self) -> bool:
        num_classes = getattr(self, "num_classes", None)
        return num_classes is not None and num_classes > 1 and not self._sketch_multilabel

    def _hist_update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate one batch into the label histograms: binary, multiclass
        one-vs-rest or multilabel inputs over the fixed score grid."""
        preds, target, mode = _auroc_update(preds, target)
        lo, hi = self._sketch_range
        histograms = label_score_histograms
        if self._sketch_multilabel:
            if mode != DataType.MULTILABEL or preds.ndim != 2 or preds.shape[1] != self.num_classes:
                raise ValueError(
                    f"multilabel `sketched` mode with num_classes={self.num_classes} expects"
                    f" (N, C) scores and (N, C) binary labels, got mode {mode} with preds shape {tuple(preds.shape)}"
                )
            target = (target == 1).to(torch.int32)
        elif self._sketch_multiclass:
            if mode != DataType.MULTICLASS or preds.ndim != 2 or preds.shape[1] != self.num_classes:
                raise ValueError(
                    f"`sketched` mode with num_classes={self.num_classes} expects (N, C) class scores"
                    f" and (N,) labels, got mode {mode} with preds shape {tuple(preds.shape)}"
                )
            # one class against the rest: the kernel takes the (N,) class ids
            # and builds no (N, C) one-hot on the card
            histograms = _label_score_histograms_onevsrest
        else:
            if mode != DataType.BINARY:
                raise ValueError(f"`sketched` mode supports binary inputs only, got mode {mode}")
            pos_label = 1 if getattr(self, "pos_label", None) is None else self.pos_label
            preds = preds.reshape(-1, 1)
            target = (target == pos_label).to(torch.int32).reshape(-1, 1)
        pos, neg, clipped = histograms(preds, target, self._sketch_bins, lo, hi)
        self.pos_hist = self.pos_hist + pos
        self.neg_hist = self.neg_hist + neg
        self.sketch_clipped = self.sketch_clipped + clipped

    def _hist_check_degenerate(self) -> Optional[Tensor]:
        """Raise on degenerate (single-label) histograms; return the
        per-class positive supports for weighted averaging. Inside
        ``torch.func.vmap`` (the keyed compute) or a compiled program no value
        can be read, so nothing is checked and the ``hist_*`` functions give
        the 0/0 NaN the exact arithmetic would."""
        if _is_traced(self.pos_hist, self.neg_hist):
            return None
        pos = torch.sum(self.pos_hist, dim=-1)
        neg = torch.sum(self.neg_hist, dim=-1)
        pos_host, neg_host = to_host(torch.stack([pos, neg]))
        if sum(pos_host) + sum(neg_host) == 0:  # empty stream: compute-before-update already warned
            return None
        for p, n in zip(pos_host, neg_host):
            if p > 0 and n == 0:
                raise ValueError("No negative samples in targets, false positive value should be meaningless")
            if n > 0 and p == 0:
                raise ValueError("No positive samples in targets, true positive value should be meaningless")
        return pos

    def _publish_hist_info(self) -> None:
        self._publish_sketch_info(
            kind="binned_histogram",
            bins=self._sketch_bins,
            range=list(self._sketch_range),
            classes=int(self.pos_hist.shape[0]),
            overflow=self.sketch_clipped,
        )
