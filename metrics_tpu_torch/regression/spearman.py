"""SpearmanCorrcoef module metric.

Counterpart of ``metrics_tpu/regression/spearman.py``, in its three modes:

* the list mode buffers every pair (``"cat"``) and ranks them at compute;
* ``capacity=N`` writes the pairs into a fixed ``(N + slack, 2)`` buffer
  (:class:`~metrics_tpu_torch.utilities.capped_buffer.CappedBufferMixin`):
  the positions are computed on the device, so an update reads nothing to
  the host and can be captured; compute ranks the valid entries with the
  masked rank (:func:`masked_spearman_corrcoef`). Its ``forward`` takes the
  double-update protocol, as the capacity-mode curves' does: the JAX
  package's fused forward merges the buffer's ``"cat"`` leaves by
  concatenation, so each forward there adds a shard of ``N + slack`` rows
  and the capacity never binds (ROADMAP, queue C); here the buffer keeps its
  shape, which the compiled step needs;
* ``sketched=True`` accumulates the joint (pred, target) distribution into a
  fixed ``(num_bins, num_bins)`` float32 rank grid
  (:func:`~metrics_tpu_torch.kernels.sketches.joint_grid_update`) and
  computes rho from the bin counts with midrank tie correction: exactly the
  Spearman of the stream discretized onto the grid, so the error is
  O(1/num_bins) for continuous in-range data and the state is O(num_bins²)
  whatever the traffic. It needs an explicit ``value_range``; out-of-range
  values clip into the edge bins and are counted (``sketch_clipped``).
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.spearman import (
    _spearman_corrcoef_compute,
    _spearman_corrcoef_update,
    masked_spearman_corrcoef,
)
from metrics_tpu_torch.kernels.sketches import joint_grid_update, spearman_from_grid
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.capped_buffer import CappedBufferMixin
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.sketching import SketchTelemetryMixin, _check_num_bins, _check_range


class SpearmanCorrcoef(SketchTelemetryMixin, CappedBufferMixin, Metric):
    """Spearman rank correlation over all seen (preds, target) pairs.

    Args:
        capacity: when set, accumulate into a fixed-size buffer of
            ``capacity`` pairs instead of unbounded lists, usable in the
            compiled step; pairs past the capacity are dropped (warned about
            at compute, or raised with ``overflow="error"``).
        sketched: bounded-memory streaming: accumulate a fixed ``(num_bins,
            num_bins)`` joint rank grid instead of samples (see the module
            docstring).
        num_bins: sketched-mode grid resolution per axis (default 512).
        value_range: required with ``sketched=True``: the static grid
            bounds, one ``(low, high)`` pair for both axes or
            ``((pred_low, pred_high), (target_low, target_high))``.
        overflow: capacity-mode policy past the buffer, ``"warn"`` or
            ``"error"``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _sketch_hint = (
        "Alternatively, SpearmanCorrcoef(sketched=True,"
        " value_range=(low, high)) keeps a fixed-size joint rank grid"
        " (bounded memory, one psum at sync; see"
        " docs/performance.md#bounded-memory-sketched-states)."
    )

    def __init__(
        self,
        capacity: Optional[int] = None,
        sketched: bool = False,
        num_bins: int = 512,
        value_range: Optional[Union[Tuple[float, float], Tuple[Tuple[float, float], ...]]] = None,
        overflow: str = "warn",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.capacity = capacity
        self.sketched = sketched
        self.num_classes = None  # raw-value buffer; no class semantics

        if sketched:
            if capacity is not None:
                raise ValueError("`sketched` and `capacity` modes are mutually exclusive")
            _check_num_bins(num_bins)
            if value_range is None:
                raise ValueError(
                    "SpearmanCorrcoef(sketched=True) needs an explicit `value_range`"
                    " — the rank grid must be static (the same on every process and"
                    " every step) to stay mergeable. Pass (low, high) covering your"
                    " preds/target values, or ((pred_low, pred_high), (target_low,"
                    " target_high)); out-of-range values clip into the edge bins."
                )
            if (
                isinstance(value_range, (tuple, list))
                and len(value_range) == 2
                and isinstance(value_range[0], (tuple, list))
            ):
                self._sketch_range_x = _check_range("value_range[0]", value_range[0])
                self._sketch_range_y = _check_range("value_range[1]", value_range[1])
            else:
                self._sketch_range_x = self._sketch_range_y = _check_range("value_range", value_range)
            self._sketch_bins = num_bins
            self.add_state("joint_grid", torch.zeros((num_bins, num_bins), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("sketch_clipped", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        elif capacity is not None:
            # the buffer's "cat" leaves would merge by concatenation, one more
            # shard per forward: the forward updates the buffer in place instead
            self._fusable = False
            self._init_raw_buffer_states(capacity, overflow=overflow)
        else:
            rank_zero_warn(
                "Metric `SpearmanCorrcoef` will save all targets and predictions in the buffer."
                " For large datasets, this may lead to a large memory footprint."
            )
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the batch pairs (written in place under ``capacity``,
        binned under ``sketched``)."""
        preds, target = _spearman_corrcoef_update(preds, target)
        if self.sketched:
            grid, clipped = joint_grid_update(
                self.joint_grid, preds, target, self._sketch_range_x, self._sketch_range_y
            )
            self.joint_grid = grid
            self.sketch_clipped = self.sketch_clipped + clipped
            return
        if self.capacity is not None:
            self._raw_buffer_update(preds, target)
            return
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Spearman correlation over everything seen so far."""
        if self.sketched:
            rho = spearman_from_grid(self.joint_grid)
            self._publish_sketch_info(
                kind="joint_grid",
                bins=self._sketch_bins,
                range=[list(self._sketch_range_x), list(self._sketch_range_y)],
                overflow=self.sketch_clipped,
            )
            return rho
        if self.capacity is not None:
            preds, target, valid = self._buffer_flatten()
            return masked_spearman_corrcoef(preds, target, valid)

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spearman_corrcoef_compute(preds, target)
