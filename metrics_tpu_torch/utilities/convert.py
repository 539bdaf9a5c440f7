"""Carry metric state across from the JAX package.

The system has no weights; its counterpart is metric state.
:func:`load_numpy_states` installs states read from a ``metrics_tpu``
metric (``_get_states()`` or ``state_dict()`` through ``np.asarray``) as a
port metric's states, with the port's dtypes on its device, so a stream
counted so far under JAX continues under PyTorch: fixed-shape states (the
sketched curves' float32 histograms among them) and list states (the exact
curves' ``preds``/``target``). That holds for a plain metric, a
``MetricCollection``, a ``KeyedMetric`` (its stacked ``(capacity, ...)``
states) and a ``MultiTenantCollection`` (one stacked bundle per layout
owner).
"""
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import resolve_device
from metrics_tpu_torch.wrappers.multitenant import KeyedMetric, MultiTenantCollection

NumpyState = Union[np.ndarray, List[np.ndarray]]


def load_numpy_states(
    metric: Union[Metric, MetricCollection, MultiTenantCollection],
    states: Mapping[str, Union[NumpyState, Mapping[str, NumpyState]]],
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Install ``states`` as ``metric``'s states.

    For a :class:`Metric`, ``states`` maps every state name to an array (a
    fixed-shape state, cast to the dtype of the port's default) or a list of
    arrays (a list state). For a :class:`MetricCollection` it maps member
    names (without prefix/postfix) to such dicts. A ``KeyedMetric`` takes
    its stacked ``(capacity, ...)`` states; a ``MultiTenantCollection`` maps
    each bundle's owner name to them (its layout is built first). Metrics
    that learn attributes from the data decode them from the installed
    states (``Accuracy.mode`` from ``mode_code``; a list-mode ``ROC``,
    ``PrecisionRecallCurve`` or ``AveragePrecision`` its ``num_classes`` and
    ``pos_label`` from the ranks of its ``preds``/``target`` lists; a
    list-mode ``AUROC`` infers its data mode at compute). ``device``
    defaults to the metric's device; another device raises, since the states
    must lie where the metric keeps them.
    """
    if isinstance(metric, MultiTenantCollection):
        metric.build()
        for owner, owner_states in states.items():
            load_numpy_states(metric._keyed[owner], owner_states, device)
        return
    if isinstance(metric, MetricCollection):
        for name, member_states in states.items():
            load_numpy_states(metric[name], member_states, device)
        return
    if device is not None and resolve_device(device) != metric.device:
        raise ValueError(f"{type(metric).__name__} keeps its states on {metric.device}, not on {device}")
    if set(states) != set(metric._defaults):
        raise KeyError(
            f"{type(metric).__name__} has the states {sorted(metric._defaults)}, got {sorted(states)}"
        )
    installed: Dict[str, Union[torch.Tensor, List[torch.Tensor]]] = {}
    for name, value in states.items():
        default = metric._defaults[name]
        if isinstance(default, list):
            installed[name] = [torch.from_numpy(np.array(v)).to(metric.device) for v in value]
        else:
            value = torch.from_numpy(np.array(value)).to(metric.device, default.dtype)
            if value.shape != default.shape:
                raise ValueError(f"state `{name}` has the shape {tuple(default.shape)}, got {tuple(value.shape)}")
            installed[name] = value
    metric._set_states(installed)
    metric._restore_derived(installed)
    metric._update_called = True
    metric._computed = None


def load_tenant_traffic(
    metric: Union[KeyedMetric, MultiTenantCollection],
    rows: Optional[np.ndarray],
    last_seen: Optional[np.ndarray],
) -> None:
    """Install a keyed wrapper's traffic ledger: the ``(rows, last_seen)``
    pair of the JAX object's ``_traffic.arrays()`` (``(None, None)`` when it
    recorded nothing), one entry per tenant. It replaces whatever ``metric``
    recorded; the ledger lands on ``metric``'s device."""
    if (rows is None) != (last_seen is None):
        raise ValueError("rows and last_seen are given together or not at all")
    ledger = metric._traffic
    ledger.clear()
    if rows is None:
        return
    rows, last_seen = np.array(rows, dtype=np.int64), np.array(last_seen, dtype=np.float64)
    if rows.shape != (ledger.n,) or last_seen.shape != (ledger.n,):
        raise ValueError(f"the ledger holds {ledger.n} tenants, got {rows.shape} rows and {last_seen.shape} stamps")
    with ledger._lock:
        ledger.rows = torch.from_numpy(rows).to(metric.device)
        ledger.last_seen = torch.from_numpy(last_seen).to(metric.device)
