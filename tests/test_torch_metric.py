"""The port's ``Metric`` lifecycle, held against the JAX package's where both have it.

Fused ``forward`` (batch value, one accumulation), the compute cache, the
"compute before update" warning, ``reset``/``clone``/pickle/``state_dict``,
hashing, the reductions of ``add_state`` through an injected sync, the
on-step sync regression, the double-update protocol, the device rule, and
the default ``torch.distributed`` gather in two gloo processes.
"""
import os
import pickle
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu_torch.metric import Metric

C = 5
_rng = np.random.RandomState(7)
BATCHES = [(_rng.rand(32, C).astype(np.float32), _rng.randint(0, C, 32)) for _ in range(4)]


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


class _Reductions(Metric):
    """One state per reduction kind; ``update`` adds the batch's values."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("s", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("m", torch.zeros(()), dist_reduce_fx="mean")
        self.add_state("hi", torch.full((), -1e9), dist_reduce_fx="max")
        self.add_state("lo", torch.full((), 1e9), dist_reduce_fx="min")
        self.add_state("c", [], dist_reduce_fx="cat")
        self.add_state("raw", torch.zeros(()), dist_reduce_fx=None)
        self.add_state("custom", torch.zeros(()), dist_reduce_fx=lambda x: x.prod(dim=0))

    def update(self, x):
        self.s = self.s + x.sum()
        self.m = self.m + x.mean()
        self.hi = torch.maximum(self.hi, x.max())
        self.lo = torch.minimum(self.lo, x.min())
        self.c.append(x)
        self.raw = self.raw + 1
        self.custom = self.custom + 2

    def compute(self):
        return self.s


def _fake_gather(x, group=None):
    return [x, x]


def test_fused_forward_matches_jax_and_accumulates_once():
    jm, tm = J.Accuracy(), T.Accuracy(device="cpu")
    for batch in BATCHES:
        _close(tm(*_t(batch)), jm(*_j(batch)))
    _close(tm.compute(), jm.compute())
    assert int(tm.total) == int(jm.total) == 0  # subset accuracy off: counts in tp/fp/tn/fn
    assert int(tm.tp) == int(jm.tp) and int(tm.tp + tm.fn) == 4 * 32


def test_forward_batch_value_is_the_batch_alone():
    m = T.Precision(average="macro", num_classes=C, device="cpu")
    values = [m(*_t(batch)) for batch in BATCHES]
    for batch, value in zip(BATCHES, values):
        fresh = T.Precision(average="macro", num_classes=C, device="cpu")
        fresh.update(*_t(batch))
        _close(value, fresh.compute().numpy())


def test_compute_is_cached_until_the_next_update():
    m = T.Recall(average="macro", num_classes=C, device="cpu")
    m.update(*_t(BATCHES[0]))
    first = m.compute()
    assert m.compute() is first
    m.update(*_t(BATCHES[1]))
    second = m.compute()
    assert second is not first
    both = T.Recall(average="macro", num_classes=C, device="cpu")
    both(*_t(BATCHES[0]))
    both(*_t(BATCHES[1]))
    _close(second, both.compute().numpy())


def test_compute_before_update_warns():
    with pytest.warns(UserWarning, match="before the ``update``"):
        T.StatScores(device="cpu").compute()


def test_reset_restores_defaults():
    m = T.ConfusionMatrix(num_classes=C, device="cpu")
    m(*_t(BATCHES[0]))
    m.reset()
    assert not m._update_called and m._computed is None
    assert torch.equal(m.confmat, torch.zeros(C, C, dtype=torch.int32))
    m(*_t(BATCHES[1]))
    want = J.ConfusionMatrix(num_classes=C)
    want(*_j(BATCHES[1]))
    np.testing.assert_array_equal(m.compute().numpy(), np.asarray(want.compute()))


def test_clone_and_pickle_are_independent_copies():
    m = T.F1(average="macro", num_classes=C, device="cpu")
    m(*_t(BATCHES[0]))
    for copy in (m.clone(), pickle.loads(pickle.dumps(m))):
        assert copy.device == m.device
        for name in ("tp", "fp", "tn", "fn"):
            assert torch.equal(getattr(copy, name), getattr(m, name))
        copy(*_t(BATCHES[1]))
        assert not torch.equal(copy.tp, m.tp)
        m2 = m.clone()
        m2(*_t(BATCHES[1]))
        _close(copy.compute(), m2.compute().numpy())


def test_state_dict_round_trip():
    m = T.StatScores(reduce="macro", num_classes=C, device="cpu")
    m(*_t(BATCHES[0]))
    assert m.state_dict() == {}
    m.persistent(True)
    sd = m.state_dict(prefix="x.")
    assert sorted(sd) == ["x.fn", "x.fp", "x.tn", "x.tp"]
    other = T.StatScores(reduce="macro", num_classes=C, device="cpu")
    other.load_state_dict(sd, prefix="x.")
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(other, name), getattr(m, name))
        assert getattr(other, name).dtype == torch.int32


def test_hash_is_per_instance_and_stable():
    a, b = T.Accuracy(device="cpu"), T.Accuracy(device="cpu")
    assert hash(a) != hash(b)
    assert hash(a) == hash(a)


def test_add_state_reductions_through_an_injected_gather():
    m = _Reductions(device="cpu", dist_sync_fn=_fake_gather)
    m.update(torch.tensor([1.0, 3.0]))
    m.update(torch.tensor([-2.0]))
    m.sync(dist_sync_fn=_fake_gather)
    assert float(m.s) == 2 * 2.0
    assert float(m.m) == 2.0 + -2.0  # mean over the two identical copies
    assert float(m.hi) == 3.0 and float(m.lo) == -2.0
    assert m.c.tolist() == [1.0, 3.0, -2.0, 1.0, 3.0, -2.0]
    assert m.raw.tolist() == [2.0, 2.0]  # None: the stacked gather
    assert float(m.custom) == 16.0


def test_add_state_rejects_bad_defaults_and_reductions():
    m = _Reductions(device="cpu")
    with pytest.raises(ValueError):
        m.add_state("bad", [1.0])
    with pytest.raises(ValueError):
        m.add_state("bad", torch.zeros(()), dist_reduce_fx="median")


def test_dist_sync_on_step_doubles_the_step_value_not_the_state():
    """A fake gather that returns two copies doubles each step's synced counts;
    the local accumulated state must not double (the fused-forward regression)."""
    kwargs = dict(reduce="macro", num_classes=C, dist_sync_on_step=True, dist_sync_fn=_fake_gather)
    tm, jm = T.StatScores(device="cpu", **kwargs), J.StatScores(**kwargs)
    plain = T.StatScores(reduce="macro", num_classes=C, device="cpu")
    for batch in BATCHES:
        step = tm(*_t(batch))
        np.testing.assert_array_equal(step.numpy(), np.asarray(jm(*_j(batch))))
        np.testing.assert_array_equal(step[:, :4].numpy(), 2 * plain(*_t(batch))[:, :4].numpy())
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(tm, name), getattr(plain, name))


def test_non_mergeable_states_take_the_double_update_forward():
    m = _Reductions(device="cpu")
    assert not m._states_mergeable()
    assert float(m(torch.tensor([1.0, 2.0]))) == 3.0
    assert float(m(torch.tensor([4.0]))) == 4.0
    assert float(m.compute()) == 7.0
    assert float(m.raw) == 2.0


def test_metric_without_device_raises_on_a_machine_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Accuracy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.MetricCollection([T.Precision(average="macro", num_classes=C)])
    assert T.Accuracy(device="cpu").device == torch.device("cpu")


def test_inputs_on_another_device_raise():
    m = T.Accuracy(device="cpu")
    preds, target = torch.empty(4, C, device="meta"), torch.empty(4, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="keeps its states on cpu"):
        m(preds, target)
    with pytest.raises(ValueError, match="keeps its states on cpu"):
        m.update(preds, target)
    assert not m._update_called


# -- the default gather over torch.distributed, in two gloo processes ---------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync_worker(rank, port, batches, results):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        acc = T.StatScores(reduce="macro", num_classes=C, device="cpu")
        ragged = T.StatScores(reduce="samples", device="cpu")  # "cat" list states, ragged across ranks
        for preds, target in batches[rank::2]:
            acc.update(torch.from_numpy(preds), torch.from_numpy(target))
            ragged.update(torch.from_numpy(preds), torch.from_numpy(target))
        results.put((rank, acc.compute().numpy(), ragged.compute().numpy(), acc.tp.numpy()))
    finally:
        dist.destroy_process_group()


def test_default_gather_syncs_two_gloo_processes():
    batches = BATCHES[:3]  # rank 0 takes two batches, rank 1 one
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_sync_worker, args=(rank, port, batches, results)) for rank in range(2)]
    for p in procs:
        p.start()
    got = dict((r[0], r[1:]) for r in (results.get(timeout=120) for _ in procs))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0

    whole = T.StatScores(reduce="macro", num_classes=C, device="cpu")
    whole_ragged = T.StatScores(reduce="samples", device="cpu")
    for rank_batches in (batches[0::2], batches[1::2]):
        for batch in rank_batches:
            whole.update(*_t(batch))
            whole_ragged.update(*_t(batch))
    for rank in range(2):
        synced, ragged, local_tp = got[rank]
        np.testing.assert_array_equal(synced, whole.compute().numpy())
        np.testing.assert_array_equal(ragged, whole_ragged.compute().numpy())
    assert not np.array_equal(got[0][2], got[1][2])  # local states were restored after the sync
