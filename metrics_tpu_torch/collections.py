"""MetricCollection: many metrics, one call.

Counterpart of ``metrics_tpu/collections.py``, limited to the eager path:
construction and naming (prefix/postfix), broadcast ``forward``/``update``
with per-metric kwarg filtering, dict ``compute``, ``reset``, ``clone`` and
``state_dict``. Members that advertise the same
:meth:`~metrics_tpu_torch.metric.Metric._shared_update_key` (macro
Precision, Recall and F1 with equal settings) share one canonicalization and
one count pass per batch (:meth:`MetricCollection._shared_deltas`), and
the keyed collection stacks them as one state bundle
(:meth:`MetricCollection._group_layout`).
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class MetricCollection:
    """An ordered, dict-like container of metrics sharing one call pattern.

    Args:
        metrics: a single metric, a sequence of metrics (keyed by class name,
            duplicates rejected), or a dict name -> metric (inserted in sorted
            key order for determinism).
        additional_metrics: further metrics when ``metrics`` is not a dict.
        prefix: string prepended to every output key.
        postfix: string appended to every output key.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self.add_metrics(metrics, *additional_metrics)
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def _check_input_device(self, args: Tuple, kwargs: Dict) -> None:
        for m in self._metrics.values():
            m._check_input_device(args, kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward on every metric; positional args broadcast, kwargs are
        filtered per metric signature. Shared-update classes (see
        :meth:`_shared_deltas`) run their partial-statistics pass once."""
        self._check_input_device(args, kwargs)
        shared = self._shared_deltas(args, kwargs)
        out = {}
        for name, m in self.items(keep_base=True):
            deltas = shared.get(name)
            if deltas is not None and m._states_mergeable():
                out[self._set_name(name)] = m._forward_fused(
                    *args, _update_thunk=lambda m=m, d=deltas: m._accumulate(*d), **m._filter_kwargs(**kwargs)
                )
            else:
                out[self._set_name(name)] = m(*args, **m._filter_kwargs(**kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_input_device(args, kwargs)
        shared = self._shared_deltas(args, kwargs)
        for name, m in self.items(keep_base=True):
            if name in shared:
                m._update_from_deltas(*shared[name])
            else:
                m.update(*args, **m._filter_kwargs(**kwargs))

    def _class_groups(self) -> Dict[Tuple, list]:
        """Member names per shared-update equivalence key (insertion order)."""
        groups: Dict[Tuple, list] = {}
        for name, m in self.items(keep_base=True):
            key = m._shared_update_key()
            if key is not None:
                groups.setdefault(key, []).append(name)
        return groups

    def _shared_deltas(self, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
        """Per-batch partial statistics computed ONCE per equivalence class.

        Metrics advertising the same :meth:`Metric._shared_update_key` (e.g.
        Precision/Recall/F1 with identical stat-scores settings) get one
        canonicalization + one tp/fp/tn/fn pass instead of one each."""
        deltas: Dict[str, Any] = {}
        for names in self._class_groups().values():
            if len(names) < 2:
                continue
            rep = self._metrics[names[0]]
            value = rep._batch_deltas(*args, **rep._filter_kwargs(**kwargs))
            for name in names:
                deltas[name] = value
        return deltas

    def _group_layout(self) -> list:
        """``[(owner_name, [member names]), ...]`` in member order: one entry
        per group of members that can share one state, plus one singleton
        entry per other member. Members share when their shared-update keys
        are equal AND their state layouts (names, shapes, dtypes,
        reductions, device) are equal, so their states can never diverge: the
        exact key that stands in for the JAX package's trace fingerprints
        (``collections.py:193-228``). Members with a custom sync stay alone."""
        layout: list = []
        index: Dict[Tuple, int] = {}
        for name, m in self.items(keep_base=True):
            key = m._shared_update_key()
            if key is not None and m.dist_sync_fn is None and not m.dist_sync_on_step:
                states = tuple(
                    (k, "list" if isinstance(d, list) else (tuple(d.shape), str(d.dtype)), m._reductions[k])
                    for k, d in sorted(m._defaults.items())
                )
                key = (key, states, str(m.device), repr(m.process_group))
                if key in index:
                    layout[index[key]][1].append(name)
                    continue
                index[key] = len(layout)
            layout.append((name, [name]))
        return layout

    def compute(self) -> Dict[str, Any]:
        """Compute every metric (each syncs its own states)."""
        return {k: m.compute() for k, m in self.items()}

    def reset(self) -> None:
        for _, m in self.items(keep_base=True):
            m.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True):
            m.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        for name, m in self.items(keep_base=True):
            m.state_dict(destination, prefix=f"{prefix}{name}.")
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:
        for name, m in self.items(keep_base=True):
            m.load_state_dict(state_dict, prefix=f"{prefix}{name}.")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, Metric):
                    raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
                self._metrics[name] = metric
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                name = metric.__class__.__name__
                if name in self._metrics:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self._metrics[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _renamed(self) -> "OrderedDict[str, Metric]":
        return OrderedDict((self._set_name(k), v) for k, v in self._metrics.items())

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        return self._metrics.keys() if keep_base else self._renamed().keys()

    def values(self) -> Iterable[Metric]:
        return self._metrics.values()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        return self._metrics.items() if keep_base else self._renamed().items()

    def __getitem__(self, key: str) -> Metric:
        return self._metrics[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        if not isinstance(value, Metric):
            raise ValueError(f"Value {value} is not an instance of `Metric`")
        self._metrics[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __iter__(self) -> Iterable[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        lines = [f"  ({k}): {v!r}" for k, v in self._metrics.items()]
        body = "\n".join(lines)
        out = f"{self.__class__.__name__}(\n{body}"
        if self.prefix:
            out += f",\n  prefix={self.prefix}{',' if self.postfix else ''}"
        if self.postfix:
            out += f"{',' if not self.prefix else ''}\n  postfix={self.postfix}"
        return out + "\n)"
