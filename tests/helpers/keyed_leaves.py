"""Two port-side metrics whose keyed leaves are of the merge's narrow dtypes.

Shared by the CPU tests (``tests/test_torch_multitenant.py``, which holds them
against JAX twins) and the card tests (``tests/test_torch_card.py``, which
import no JAX). Both are updated with ``(x, z, k)``: ``x`` and ``z`` bfloat16,
``k`` int16.
"""
import torch

import metrics_tpu_torch as T


class SmallLeaves(T.Metric):
    """A bfloat16 sum, an int8 sum, an int16 max, an int8 min and a bfloat16
    max: each a narrow leaf, which the merge adds or picks in a 32-bit
    accumulator."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("s", torch.zeros((2,), dtype=torch.bfloat16), dist_reduce_fx="sum")
        self.add_state("c8", torch.tensor(0, dtype=torch.int8), dist_reduce_fx="sum")
        self.add_state("hi16", torch.tensor(-(2**15), dtype=torch.int16), dist_reduce_fx="max")
        self.add_state("lo8", torch.tensor(127, dtype=torch.int8), dist_reduce_fx="min")
        self.add_state("hib", torch.tensor(-float("inf"), dtype=torch.bfloat16), dist_reduce_fx="max")

    def update(self, x, z, k):
        self.s = self.s + torch.stack([x.sum(), (2 * x).sum()])
        self.c8 = self.c8 + k.sum().to(torch.int8)
        self.hi16 = torch.maximum(self.hi16, k.max())
        self.lo8 = torch.minimum(self.lo8, k.min().to(torch.int8))
        self.hib = torch.maximum(self.hib, z.max())

    def compute(self):
        return self.s[0].float() + self.hib.float()


class MergedBeside(T.Metric):
    """An int32 count and a float32 max of the same inputs: a second bundle,
    whose 32-bit leaves share the narrow leaves' merge launch."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("n", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("z32", torch.tensor(-float("inf")), dist_reduce_fx="max")

    def update(self, x, z, k):
        self.n = self.n + (k != 0).sum(dtype=torch.int32)
        self.z32 = torch.maximum(self.z32, z.float().max())

    def compute(self):
        return self.z32 + self.n
