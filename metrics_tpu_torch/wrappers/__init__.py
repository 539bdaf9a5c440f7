"""Metric wrappers.

Counterpart of ``metrics_tpu/wrappers/``, limited to the multi-tenant keyed
state (:class:`KeyedMetric`, :class:`MultiTenantCollection`).
"""
from metrics_tpu_torch.wrappers.multitenant import KeyedMetric, MultiTenantCollection  # noqa: F401
