"""The capacity buffer behind ``capacity=`` (``utilities/capped_buffer.py``)
against the JAX package.

Mirrors ``tests/bases/test_capped_buffer.py`` case by case: the append at
every boundary (partial overflow, exact fill, writes past capacity, batches
larger than the buffer and than the slack zone), the append inside a
compiled program (``update_many``: the count never read to the host), the
feature buffer's read of every synced form, and the ``overflow="error"``
policy on the eager, ``jit_forward`` and ``update_many`` paths. The same
numpy inputs go through the JAX buffer and the port's on the CPU; buffers
and counts are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.metric import Metric as JMetric
from metrics_tpu.utilities.capped_buffer import CappedBufferMixin as JMixin
from metrics_tpu_torch.metric import Metric as TMetric
from metrics_tpu_torch.utilities import capped_buffer as tcb
from metrics_tpu_torch.utilities.capped_buffer import BUF_SLACK_ROWS, CappedBufferMixin

CPU = {"device": "cpu"}


class _Buf(CappedBufferMixin, TMetric):
    """Minimal raw-buffer consumer (the Spearman capacity mode's shape)."""

    def __init__(self, capacity):
        super().__init__(**CPU)
        self.capacity = capacity
        self._init_raw_buffer_states(capacity)

    def update(self, preds, target):
        self._raw_buffer_update(preds, target)

    def compute(self):
        return self._buffer_flatten()


class _JBuf(JMixin, JMetric):
    def __init__(self, capacity):
        super().__init__()
        self.capacity = capacity
        self._init_raw_buffer_states(capacity)

    def update(self, preds, target):
        self._raw_buffer_update(preds, target)

    def compute(self):
        return self._buffer_flatten()


#: (capacity, batch sizes): every boundary class of the append
CASES = [
    (10, [4]),  # plain append into empty
    (10, [6, 4]),  # exact fill
    (10, [8, 4]),  # partial overflow: two in, two dropped
    (10, [10, 4]),  # full buffer: everything drops
    (10, [10, 2, 4]),  # count already past capacity
    (10, [10]),  # batch exactly covers the buffer
    (10, [3, 10]),  # n == capacity, offset start
    (10, [12]),  # batch larger than the buffer
    (10, [7, 12]),  # larger batch, offset start
    (4, [2, 9]),  # much larger batch, offset start
    (1, [1, 1]),  # degenerate capacity
    (2000, [BUF_SLACK_ROWS + 1777]),  # bigger than the slack zone: chunked
]


@pytest.mark.parametrize("cap, sizes", CASES)
def test_buffer_write_matches_drop_scatter(cap, sizes):
    rng = np.random.RandomState(cap * 100 + sum(sizes))
    m, jm = _Buf(cap), _JBuf(cap)
    stream_p, stream_t = [], []
    for n in sizes:
        p = rng.rand(n).astype(np.float32)
        t = rng.rand(n).astype(np.float32)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
        stream_p.append(p)
        stream_t.append(t)
    preds, target, valid = m._unwrapped_compute()
    total = sum(sizes)
    kept = min(total, cap)
    assert int(m.count) == total and m.count.dtype == torch.int32
    np.testing.assert_array_equal(valid.numpy(), np.arange(cap) < kept)
    np.testing.assert_array_equal(preds.numpy()[:kept], np.concatenate(stream_p)[:kept])
    np.testing.assert_array_equal(target.numpy()[:kept], np.concatenate(stream_t)[:kept])
    # the whole buffer, slack zone included, as the JAX package writes it
    np.testing.assert_array_equal(m.buf.numpy(), np.asarray(jm.buf))


def test_buffer_write_inside_a_compiled_program():
    """The append stays right with the count never read: six appends as one
    ``update_many`` program (the JAX package's ``lax.scan``), against the
    JAX package's jitted scan."""
    import jax

    cap, n = 16, 5
    rng = np.random.RandomState(0)
    ps = rng.rand(6, n).astype(np.float32)
    ts = rng.rand(6, n).astype(np.float32)
    m, jm = _Buf(cap), _JBuf(cap)
    m.update_many(torch.from_numpy(ps), torch.from_numpy(ts))

    @jax.jit
    def fill(ps, ts):
        def body(state, xs):
            return jm.apply_update(state, *xs), None

        return jax.lax.scan(body, jm.init_state(), (ps, ts))[0]

    state = fill(jnp.asarray(ps), jnp.asarray(ts))
    rows = m.buf.numpy().reshape(-1, 2)[:cap]
    np.testing.assert_allclose(rows[:, 0], ps.reshape(-1)[:cap])
    np.testing.assert_allclose(rows[:, 1], ts.reshape(-1)[:cap])
    assert int(m.count) == 30
    np.testing.assert_array_equal(m.buf.numpy(), np.asarray(state["buf"]))


def test_feature_buffer_read_handles_post_sync_multi_shard_state():
    capacity, dim = 8, 3
    buf0, slack = tcb.init_feature_buffer(capacity, dim)
    buf1, _ = tcb.init_feature_buffer(capacity, dim)
    rows0 = torch.arange(5 * dim, dtype=torch.float32).reshape(5, dim)
    rows1 = 100 + torch.arange(2 * dim, dtype=torch.float32).reshape(2, dim)
    zero = torch.zeros((), dtype=torch.int32)
    buf0, count0 = tcb.feature_buffer_write(buf0, zero, rows0, capacity, slack)
    buf1, count1 = tcb.feature_buffer_write(buf1, zero, rows1, capacity, slack)
    want = torch.cat([rows0, rows1])
    synced_buf, synced_count = torch.stack([buf0, buf1]), torch.stack([count0, count1])
    assert torch.equal(tcb.feature_buffer_read(synced_buf, synced_count, capacity, slack, "T"), want)
    tiled = torch.cat([buf0, buf1], dim=0)
    assert torch.equal(tcb.feature_buffer_read(tiled, synced_count, capacity, slack, "T"), want)
    assert torch.equal(tcb.feature_buffer_read([buf0, buf1], [count0, count1], capacity, slack, "T"), want)
    assert torch.equal(tcb.feature_buffer_read(buf0, count0, capacity, slack, "T"), rows0)
    # the same writes through the JAX package's buffer
    from metrics_tpu.utilities import capped_buffer as jcb

    jbuf, _ = jcb.init_feature_buffer(capacity, dim)
    jbuf, jcount = jcb.feature_buffer_write(jbuf, jnp.zeros((), jnp.int32), jnp.asarray(rows0.numpy()), capacity, slack)
    np.testing.assert_array_equal(buf0.numpy(), np.asarray(jbuf))
    assert int(count0) == int(jcount)


def test_feature_buffer_write_chunked_oversized_batch():
    capacity, dim = 4, 2
    buf, slack = tcb.init_feature_buffer(capacity, dim)
    assert slack == 4
    rows = torch.arange(11 * dim, dtype=torch.float32).reshape(11, dim)
    buf, count = tcb.feature_buffer_write(buf, torch.zeros((), dtype=torch.int32), rows, capacity, slack)
    assert int(count) == 11
    with pytest.warns(UserWarning, match="dropped 7"):
        got = tcb.feature_buffer_read(buf, count, capacity, slack, "T")
    assert torch.equal(got, rows[:capacity])


class TestOverflowErrorPolicy:
    """``overflow="error"``: a descriptive BufferOverflowError (metric name,
    capacity, overflow count) in place of warn-and-truncate, on the eager
    and the compiled paths alike."""

    def test_eager_overflow_raises_with_details(self):
        m = T.AUROC(capacity=8, overflow="error", **CPU)
        jm = J.AUROC(capacity=8, overflow="error")
        m.update(torch.linspace(0, 1, 20), torch.arange(20) % 2)
        jm.update(jnp.linspace(0, 1, 20), jnp.arange(20) % 2)
        with pytest.raises(T.BufferOverflowError) as err:
            m.compute()
        with pytest.raises(J.BufferOverflowError) as jerr:
            jm.compute()
        assert str(err.value) == str(jerr.value)
        assert "AUROC" in str(err.value) and "capacity=8" in str(err.value) and "12 sample(s)" in str(err.value)

    def test_compiled_overflow_raises_at_next_eager_compute(self):
        """A compiled step reads no count, so it cannot raise; the overflow
        surfaces at the next eager compute."""
        m = T.AUROC(capacity=8, overflow="error", compute_on_step=False, **CPU).jit_forward()
        x = torch.linspace(0.0, 1.0, 6)
        for _ in range(3):  # 18 samples through the compiled, in-place step
            m(x, (x > 0.5).long())
        with pytest.raises(T.BufferOverflowError, match=r"capacity=8.*10 sample"):
            m.compute()

    def test_compiled_spearman_overflow_raises_at_next_eager_compute(self):
        """The JAX package's case: ``SpearmanCorrcoef(capacity=8,
        overflow="error")`` under ``jit_forward``, 18 samples; the same
        message on both sides."""
        m = T.SpearmanCorrcoef(capacity=8, overflow="error", compute_on_step=False, **CPU).jit_forward()
        jm = J.SpearmanCorrcoef(capacity=8, overflow="error", compute_on_step=False).jit_forward()
        x = torch.linspace(0.0, 1.0, 6)
        for _ in range(3):  # 18 samples through the compiled, in-place step
            m(x, x)
            jm(jnp.linspace(0.0, 1.0, 6), jnp.linspace(0.0, 1.0, 6))
        np.testing.assert_array_equal(m.buf.numpy(), np.asarray(jm.buf))
        with pytest.raises(T.BufferOverflowError, match=r"capacity=8.*10 sample") as err:
            m.compute()
        with pytest.raises(J.BufferOverflowError) as jerr:
            jm.compute()
        assert str(err.value) == str(jerr.value)

    def test_update_many_overflow_raises_at_compute(self):
        m = T.AveragePrecision(capacity=4, overflow="error", **CPU)
        p = torch.stack([torch.linspace(0, 1, 4)] * 3)
        t = torch.stack([torch.tensor([0, 1, 0, 1])] * 3)
        m.update_many(p, t)
        with pytest.raises(T.BufferOverflowError, match="AveragePrecision"):
            m.compute()

    def test_within_capacity_never_raises(self):
        m = T.AUROC(capacity=32, overflow="error", **CPU)
        m.update(torch.linspace(0, 1, 16), torch.arange(16) % 2)
        jm = J.AUROC(capacity=32, overflow="error")
        jm.update(jnp.linspace(0, 1, 16), jnp.arange(16) % 2)
        np.testing.assert_allclose(float(m.compute()), float(jm.compute()), atol=1e-6)

    def test_default_policy_still_warns_and_truncates(self):
        m = T.AUROC(capacity=8, **CPU)
        m.update(torch.linspace(0, 1, 20), torch.arange(20) % 2)
        with pytest.warns(UserWarning, match="dropped 12"):
            float(m.compute())

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="overflow"):
            T.AUROC(capacity=8, overflow="explode", **CPU)

    def test_error_is_importable_and_catchable_as_runtime_error(self):
        assert issubclass(T.BufferOverflowError, RuntimeError)
