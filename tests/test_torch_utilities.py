"""The port's ``utilities`` and ``kernels`` export surface against the JAX package's.

``class_reduce`` runs the JAX package's ``tests/test_utilities.py`` cases
side by side on the same numpy inputs; every name that
``metrics_tpu/utilities/__init__.py`` and ``metrics_tpu/kernels/__init__.py``
export (and the port defines) imports from the port's package of the same
name. ``hierarchical_axis`` builds the port's ``Hierarchy`` of process groups
(one gloo rank here) and ``shard_map_compat`` raises, naming the port's
``torch.distributed`` route.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu.kernels as jax_kernels
import metrics_tpu.utilities as jax_utilities
from metrics_tpu.utilities.distributed import class_reduce as jax_class_reduce
from metrics_tpu_torch.utilities import Hierarchy, class_reduce, hierarchical_axis, shard_map_compat

_UTILITIES = ["Hierarchy", "applied_transport_overrides", "apply_to_collection", "class_reduce",
              "current_transport_overrides", "hierarchical_axis", "reduce", "shard_map_compat",
              "transport_overrides", "rank_zero_debug", "rank_zero_info", "rank_zero_only", "rank_zero_warn"]
_KERNELS = ["binned_tp_fp_fn", "hist_auroc", "hist_roc", "hist_average_precision", "hist_precision_recall_curve",
            "cdf_sketch_cdf", "cdf_sketch_quantile", "joint_grid_update", "spearman_from_grid", "uniform_hash",
            "weighted_priority", "bounded_priority_keep",
            "stat_scores_counts_cuda", "stat_scores_counts_torch", "confmat_counts_cuda", "confmat_counts_torch",
            "confmat_counts_batched_cuda", "confmat_counts_batched_torch",
            "segment_scatter_add_cuda", "segment_scatter_add_torch", "segment_scatter_max_cuda",
            "segment_scatter_max_torch", "segment_scatter_min_cuda", "segment_scatter_min_torch",
            "segment_merge_cuda", "segment_merge_torch",
            "label_score_histograms_cuda", "label_score_histograms_torch",
            "label_score_histograms_batched_cuda", "label_score_histograms_batched_torch"]


@pytest.mark.parametrize("package, name", [("utilities", n) for n in _UTILITIES] + [("kernels", n) for n in _KERNELS])
def test_every_exported_name_imports_from_the_port_package(package, name):
    module = importlib.import_module(f"metrics_tpu_torch.{package}")
    assert callable(getattr(module, name))
    if package == "utilities" or name in dir(jax_kernels):
        assert hasattr(jax_utilities if package == "utilities" else jax_kernels, name)


def test_the_port_exports_every_name_of_the_jax_utilities():
    jax_names = {n for n in dir(jax_utilities) if not n.startswith("_") and callable(getattr(jax_utilities, n))}
    assert jax_names == set(_UTILITIES)


_NUM, _DENOM, _WEIGHTS = [2.0, 3.0, 5.0], [4.0, 6.0, 10.0], [10.0, 20.0, 30.0]


@pytest.mark.parametrize("reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce(reduction):
    got = class_reduce(torch.tensor(_NUM), torch.tensor(_DENOM), torch.tensor(_WEIGHTS), reduction)
    want = jax_class_reduce(jnp.asarray(_NUM), jnp.asarray(_DENOM), jnp.asarray(_WEIGHTS), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    expected = {"micro": 10.0 / 20.0, "macro": 0.5, "none": [0.5, 0.5, 0.5], None: [0.5, 0.5, 0.5],
                "weighted": np.sum(np.asarray(_NUM) / np.asarray(_DENOM) * np.asarray(_WEIGHTS) / 60.0)}[reduction]
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6)


@pytest.mark.parametrize("reduction", ["micro", "macro", "weighted", "none"])
def test_class_reduce_nan_zeroing(reduction):
    """0/0 classes count 0, not NaN; a class of 1/0 keeps its infinity."""
    for num, denom, weights in (([0.0, 1.0], [0.0, 2.0], [0.0, 2.0]), ([0.0, 1.0, 1.0], [0.0, 2.0, 0.0], [1, 2, 3])):
        got = class_reduce(torch.tensor(num), torch.tensor(denom), torch.tensor(weights), reduction)
        want = jax_class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = class_reduce(torch.tensor([0.0, 1.0]), torch.tensor([0.0, 2.0]), torch.tensor([0.0, 2.0]), "macro")
    assert float(got) == pytest.approx((0.0 + 0.5) / 2)


def test_class_reduce_raises_the_jax_message_on_an_unknown_reduction():
    args = (jnp.asarray(_NUM), jnp.asarray(_DENOM), jnp.asarray(_WEIGHTS))
    with pytest.raises(ValueError) as jax_err:
        jax_class_reduce(*args, "median")
    with pytest.raises(ValueError) as port_err:
        class_reduce(*(torch.tensor(np.asarray(a)) for a in args), "median")
    assert str(port_err.value) == str(jax_err.value)


def test_hierarchical_axis_is_a_hierarchy_of_process_groups(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        h = hierarchical_axis(1)
        assert isinstance(h, Hierarchy) and (h.node_size, h.nodes, h.leader) == (1, 1, 0)
        assert [label for label, _ in h.levels] == ["intra", "inter"]
        buf = torch.tensor([3.0])
        h.all_reduce(buf, dist.ReduceOp.SUM)
        assert float(buf) == 3.0
    finally:
        dist.destroy_process_group()


def test_shard_map_compat_raises_and_names_the_torch_distributed_route():
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        shard_map_compat(lambda x: x, mesh=None, in_specs=None, out_specs=None)
