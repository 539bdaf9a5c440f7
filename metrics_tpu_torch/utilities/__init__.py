"""Helpers shared by the metrics (counterpart of ``metrics_tpu/utilities/``)."""
