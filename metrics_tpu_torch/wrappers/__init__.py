"""Metric wrappers.

Counterpart of ``metrics_tpu/wrappers/``: the bootstrapper
(:class:`BootStrapper`) and the multi-tenant keyed state
(:class:`KeyedMetric`, :class:`MultiTenantCollection`).
"""
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper  # noqa: F401
from metrics_tpu_torch.wrappers.multitenant import KeyedMetric, MultiTenantCollection  # noqa: F401
