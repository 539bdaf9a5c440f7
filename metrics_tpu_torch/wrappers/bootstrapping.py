"""Bootstrapped confidence intervals for any metric.

Counterpart of ``metrics_tpu/wrappers/bootstrapping.py`` (``BootStrapper``:
N deep copies of a base metric, each updated on the batch resampled along
dim 0 with Poisson(1) counts or multinomial draws; ``compute`` stacks the
child values into mean/std/quantile/raw).

Randomness comes from explicit ``torch.Generator`` objects on the metric's
device, never from global state, so runs are reproducible from ``seed``.
They are not JAX's PRNG: values equal the JAX package's only for the same
draws.

* **Eager** ``update``: one generator, seeded from ``seed`` at build time,
  advances with every draw. A Poisson resample has a random length, so it
  reads its total to the host once per child per update (counted under
  ``bootstrap_host_reads``).
* **Pure** ``init_state``/``apply_update``/``apply_compute``
  (``bootstrapping.py:187-230``): the children's states stacked on a
  leading bootstrap axis, plus the seed and a step counter as int64 tensors
  on the CPU in place of JAX's key. Each ``apply_update`` seeds a fresh
  generator from ``(seed, step)`` (a read of host memory, which never
  waits for the card), draws the ``(num_bootstraps, size)`` index matrix,
  then vmaps the child's update over ``(child_state, indices)``:
  ``torch.func.vmap`` takes no random op inside. The Poisson strategy takes
  the fixed-length resample there (:func:`_fixed_length_repeat`). The pure
  stream does not depend on interleaved eager updates.
* ``apply_compute`` with a process group syncs the stacked children first
  through the packed sync, each leaf under the child's reduction (which
  acts on the stack elementwise, as on each child), then vmaps the child's
  compute with no group: the port's ``vmap_compute`` takes none, where the
  JAX package passes ``axis_name`` into the vmap.
"""
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch.metric import _GROUP_UNSET, Metric
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.utilities.data import Tensor, apply_to_collection, to_host
from metrics_tpu_torch.utilities.distributed import sync_state_packed
from metrics_tpu_torch.utilities.stacked import stack_pytrees, vmap_compute, vmap_update

_STRATEGIES = ("poisson", "multinomial")


def _fixed_length_repeat(values: Tensor, counts: Tensor, length: int) -> Tensor:
    """``values[i]`` repeated ``counts[i]`` times, cut or padded to exactly
    ``length`` entries along the last axis, as ``jnp.repeat(values, counts,
    total_repeat_length=length)`` does (pinned by
    ``tests/wrappers/test_bootstrapping.py::test_jnp_repeat_padding_contract``):
    a total over ``length`` is cut at ``length``, and a total short of it is
    padded with copies of the LAST input element, ``values[..., -1]``, even
    where its own count is 0. ``torch.repeat_interleave(..., output_size=)``
    neither pads nor cuts, so each output position looks up the block it
    falls in: the last block whose start (the exclusive cumulative count)
    is at or before it."""
    starts = torch.cumsum(counts, dim=-1) - counts
    positions = torch.arange(length, device=values.device).expand(starts.shape[:-1] + (length,)).contiguous()
    block = torch.searchsorted(starts.contiguous(), positions, right=True) - 1
    return torch.gather(values, -1, block)


def _bootstrap_sampler(size: int, generator: torch.Generator, sampling_strategy: str = "poisson") -> Tensor:
    """The eager path's index tensor that resamples ``size`` rows with
    replacement, drawn from ``generator`` on its device: ``'poisson'``, each
    row repeated n ~ Poisson(1) times (the random total is read to the host
    once); ``'multinomial'``, ``size`` uniform draws with replacement."""
    device = generator.device
    if sampling_strategy == "poisson":
        counts = torch.poisson(torch.ones(size, device=device), generator=generator).long()
        total = int(to_host(counts.sum()))  # the random length: one host read
        return torch.repeat_interleave(torch.arange(size, device=device), counts, output_size=total)
    if sampling_strategy == "multinomial":
        return torch.randint(0, size, (size,), generator=generator, device=device)
    raise ValueError("Unknown sampling strategy")


def _bootstrap_indices(num: int, size: int, generator: torch.Generator, sampling_strategy: str) -> Tensor:
    """The pure path's ``(num, size)`` index matrix in one draw: multinomial
    rows, or fixed-length Poisson rows, the static-shape reading of the
    Poisson bootstrap (``bootstrapping.py:22-56``): each row visits the rows
    in a random order (the argsort of uniform draws) and cuts or pads their
    Poisson(1) repeats at ``size`` (:func:`_fixed_length_repeat`)."""
    device = generator.device
    if sampling_strategy == "multinomial":
        return torch.randint(0, size, (num, size), generator=generator, device=device)
    counts = torch.poisson(torch.ones(num, size, device=device), generator=generator).long()
    order = torch.argsort(torch.rand(num, size, generator=generator, device=device), dim=1)
    return _fixed_length_repeat(order, torch.gather(counts, 1, order), size)


def _leading_size(args: Any, kwargs: Any) -> int:
    """The leading axis of the first tensor among the inputs."""
    sizes = pytree.tree_leaves(apply_to_collection((args, kwargs), Tensor, lambda a: a.shape[0]))
    if not sizes:
        raise ValueError("None of the input contained tensors, so could not determine the sampling size")
    return sizes[0]


class BootStrapper(Metric):
    """Wrap a metric to estimate the bootstrap distribution of its value.

    Args:
        base_metric: the metric to resample; it is deep-copied
            ``num_bootstraps`` times.
        num_bootstraps: number of independent resampled copies.
        mean / std / quantile / raw: which statistics of the stacked child
            values ``compute`` returns (``quantile`` takes the level(s);
            ``raw`` includes the per-copy vector).
        sampling_strategy: ``'poisson'`` — each row repeated n ~ Poisson(1)
            times (fixed-length on the pure path, see
            :func:`_bootstrap_indices`); ``'multinomial'`` — n uniform draws
            with replacement.
        seed: seed of both random streams; the pure path's stream derives
            from it alone and is unaffected by interleaved eager updates.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`;
            the generators live on ``device`` (default: the base metric's).

    Example::

        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> from metrics_tpu_torch.wrappers import BootStrapper
        >>> bootstrap = BootStrapper(Accuracy(device="cpu"), num_bootstraps=20, seed=123)
        >>> gen = torch.Generator().manual_seed(0)
        >>> bootstrap.update(torch.randint(0, 5, (20,), generator=gen), torch.randint(0, 5, (20,), generator=gen))
        >>> sorted(bootstrap.compute().keys())
        ['mean', 'std']
    """

    _fusable = False  # children own the state; forward uses the double-update protocol

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         device=base_metric.device if device is None else device)

        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        if sampling_strategy not in _STRATEGIES:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {_STRATEGIES}"
                f" but recieved {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._seed = seed
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every child copy on an independently resampled batch."""
        size = _leading_size(args, kwargs)
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self._generator, sampling_strategy=self.sampling_strategy)
            if self.sampling_strategy == "poisson" and TELEMETRY.enabled:
                TELEMETRY.inc(self.telemetry_key, "bootstrap_host_reads")
            new_args = apply_to_collection(args, Tensor, torch.index_select, 0, sample_idx)
            new_kwargs = apply_to_collection(kwargs, Tensor, torch.index_select, 0, sample_idx)
            self.metrics[idx].update(*new_args, **new_kwargs)

    def _stats_dict(self, computed_vals: Tensor) -> Dict[str, Tensor]:
        """The requested statistics of the stacked per-child values, shared
        by the stateful and the pure calls."""
        output_dict = {}
        # integer values (a confusion matrix, stat scores) in float32, as jnp.mean/std/quantile give
        stats = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        if self.mean:
            output_dict["mean"] = torch.mean(stats, dim=0)
        if self.std:
            output_dict["std"] = torch.std(stats, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=stats.dtype, device=stats.device)
            output_dict["quantile"] = torch.quantile(stats, q)  # linear, as jnp.quantile
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def compute(self) -> Dict[str, Tensor]:
        """Dict of the requested bootstrap statistics (mean/std/quantile/raw)."""
        return self._stats_dict(torch.stack([m.compute() for m in self.metrics], dim=0))

    def reset(self) -> None:
        # no registered states on the wrapper itself: reset the children and
        # the cache flags, and build no stacked pure state
        for m in self.metrics:
            m.reset()
        self._update_called = False
        self._forward_cache = None
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        for m in self.metrics:
            m.persistent(mode)

    # ------------------------------------------------------------------
    # pure API: children as one vmapped state stack
    # ------------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """Pure state: every child's state stacked on a leading bootstrap
        axis, with the seed and a step counter (int64 CPU tensors)."""
        return {
            "children": stack_pytrees([m.init_state() for m in self.metrics]),
            "seed": torch.tensor(self._seed, dtype=torch.int64),
            "step": torch.zeros((), dtype=torch.int64),
        }

    def _pure_generator(self, state: Dict[str, Any]) -> torch.Generator:
        """A generator on the metric's device seeded from the state's
        ``(seed, step)`` alone."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed((int(state["seed"]) << 32) + int(state["step"]))
        return generator

    def apply_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        size = _leading_size(args, kwargs)
        indices = _bootstrap_indices(self.num_bootstraps, size, self._pure_generator(state), self.sampling_strategy)
        child = self.metrics[0]

        def one(child_state: Dict[str, Any], idx: Tensor) -> Dict[str, Any]:
            new_args = apply_to_collection(args, Tensor, torch.index_select, 0, idx)
            new_kwargs = apply_to_collection(kwargs, Tensor, torch.index_select, 0, idx)
            return child.apply_update(child_state, *new_args, **new_kwargs)

        children = vmap_update(child, one)(state["children"], indices)
        return {"children": children, "seed": state["seed"], "step": state["step"] + 1}

    def apply_compute(self, state: Dict[str, Any], process_group: Any = _GROUP_UNSET) -> Dict[str, Tensor]:
        """The statistics of the stacked children, synced over
        ``process_group`` first (default: the wrapper's own, else the
        child's; ``None``: no sync)."""
        child = self.metrics[0]
        if process_group is _GROUP_UNSET:
            process_group = self.process_group if self.process_group is not None else child.process_group
        children = state["children"]
        if process_group is not None:
            children = sync_state_packed(children, child._reductions, process_group)
        return self._stats_dict(vmap_compute(child)(children))
