"""The port's gather protocol against the JAX package's, ranks simulated by threads.

N threads meet at a barrier in place of N processes, as
``tests/bases/test_gather_protocol.py`` and ``test_packed_gather.py`` do for
the JAX package. The same numpy inputs per rank go through the JAX
``gather_all_arrays``/``gather_all_pytrees`` (its ``_process_allgather``
faked) and through the port's ``gather_all_tensors``/``gather_all_pytrees``
(its ``_all_gather`` faked, the module's one collective). Per rank, the
results must agree in values and, separately, in dtypes; the same ranks
must raise the same errors after the same number of rounds. The gathers'
telemetry — the collective span ids of each simulated rank and the sync
records (rounds, leaves, bytes) — must equal the JAX package's too.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
import metrics_tpu.utilities.distributed as jdist
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
import metrics_tpu_torch.observability.tracing as ttracing
import metrics_tpu_torch.utilities.distributed as tdist
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


def _run_ranks(fns, pkg):
    """Run one callable per simulated rank with ``pkg``'s collective faked by
    a barrier exchange; returns (results, errors, rounds per rank)."""
    nprocs = len(fns)
    barrier = threading.Barrier(nprocs)
    exchange = {}
    lock = threading.Lock()
    rank_of_thread = {}
    calls = [0] * nprocs

    def swap(x):
        rank = rank_of_thread[threading.get_ident()]
        calls[rank] += 1
        with lock:
            exchange[rank] = x
        barrier.wait()
        got = [exchange[r] for r in range(nprocs)]
        barrier.wait()  # every rank has read before the next round reuses the dict
        return got

    if pkg == "jax":
        patches = [
            (jdist, "_process_allgather", lambda x: np.stack(swap(np.asarray(x)))),
            (jdist, "distributed_available", lambda: True),
            (jdist, "world_size", lambda: nprocs),
            (jax, "process_index", lambda: rank_of_thread[threading.get_ident()]),
        ]
    else:
        patches = [
            (tdist, "_all_gather", lambda buf, group: torch.stack(swap(buf))),
            (tdist, "distributed_available", lambda: True),
            (tdist, "world_size", lambda: nprocs),
            (ttracing, "_process_index", lambda: rank_of_thread[threading.get_ident()]),
        ]
    results, errors = [None] * nprocs, [None] * nprocs

    def worker(rank):
        rank_of_thread[threading.get_ident()] = rank
        try:
            results[rank] = fns[rank]()
        except Exception as err:
            errors[rank] = err
            # the protocol finishes its rounds before it raises: let peers
            # drain, abort only ranks stuck in a round this one never joins
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                if all(results[r] is not None or errors[r] is not None for r in range(nprocs)):
                    return
                time.sleep(0.01)
            barrier.abort()

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in range(nprocs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
    return results, errors, calls


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor), where
        assert tuple(got.shape) == w.shape, where
        np.testing.assert_array_equal(got.numpy(), w, err_msg=where)
        assert _np_dtype(got.dtype) == w.dtype, where


def _parity(per_rank, groups=None, kind="array"):
    """Both packages on the same per-rank inputs: equal results, dtypes,
    errors and round counts. Returns the port's results."""
    def fns(pkg):
        out = []
        for rank, local in enumerate(per_rank):
            group = groups[rank] if groups is not None else None
            if pkg == "jax":
                arg = _to_jax(local)
                fn = jdist.gather_all_arrays if kind == "array" else jdist.gather_all_pytrees
            else:
                arg = _to_torch(local)
                fn = tdist.gather_all_tensors if kind == "array" else tdist.gather_all_pytrees
            out.append(lambda fn=fn, arg=arg, group=group: fn(arg, group=group))
        return out

    want, want_errors, want_calls = _run_ranks(fns("jax"), "jax")
    got, got_errors, got_calls = _run_ranks(fns("torch"), "torch")
    assert got_calls == want_calls
    for rank, (g, w) in enumerate(zip(got_errors, want_errors)):
        if w is None:
            assert g is None, (rank, g)
        else:
            assert type(g) is type(w), (rank, g, w)
            assert str(g).replace("gather_all_tensors", "gather_all_arrays") == str(w)
    for rank, (g, w) in enumerate(zip(got, want)):
        if want_errors[rank] is None:
            _assert_same(g, w, f"rank {rank}")
    return got, got_errors, got_calls


# -- the per-array protocol (tests/bases/test_gather_protocol.py) ---------------

_BF16 = np.dtype(jnp.bfloat16)

ARRAY_CASES = {
    "equal_shapes": [np.arange(6, dtype=np.float32).reshape(2, 3), np.arange(6, dtype=np.float32).reshape(2, 3) + 10],
    "ragged_rows": [np.arange(12, dtype=np.float32).reshape(4, 3), np.arange(6, dtype=np.float32).reshape(2, 3) + 100],
    "empty_rank": [np.arange(9, dtype=np.int64).reshape(3, 3), np.zeros((0,), np.float32)],
    "empty_rank_of_bools": [np.zeros((0,), np.float32), np.asarray([[True, False, True]])],
    "all_ranks_empty": [np.zeros((0,), np.float32)] * 3,
    "ndim_mismatch": [np.ones((4, 3), np.float32), np.ones((4,), np.float32)],
    "dtype_mismatch": [np.ones((4, 3), np.float32), np.ones((4, 3), np.int32)],
    "zero_d": [np.float32(1.5), np.float32(2.5)],
    "zero_d_and_empty": [np.int64(7), np.zeros((0,), np.float32)],
    "nine_dims": [np.zeros((1,) * 9, np.float32), np.asarray([1.0, 2.0], np.float32)],
    "complex": [np.zeros((3,), np.complex64), np.asarray([4.0], np.float32)],
    "bfloat16": [np.asarray([1.0, 2.0], _BF16), np.asarray([3.0], np.float32)],
}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_gather_all_tensors_matches_the_jax_package(case):
    _, errors, calls = _parity(ARRAY_CASES[case])
    if case == "all_ranks_empty":
        assert calls == [1, 1, 1]  # the payload round is skipped on every rank
    if case in ("nine_dims", "complex", "bfloat16"):
        assert errors[0] is not None and errors[1] is None  # raised after the rounds, where it is bad
        assert calls[0] == calls[1] == 2


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64, np.float16, np.float32,
                                   np.float64])
def test_every_gather_dtype_round_trips_with_ragged_and_empty_ranks(dtype):
    rng = np.random.RandomState(1)
    per_rank = [(rng.rand(3, 2) * 50).astype(dtype), np.zeros((0,), np.float32), (rng.rand(1, 2) * 50).astype(dtype)]
    _parity(per_rank)


GROUP_CASES = {
    "disjoint_heterogeneous": (
        [np.arange(3, dtype=np.float32), np.arange(6, dtype=np.float32) + 10,
         np.full((2, 2), 2, np.int64), np.full((2, 2), 3, np.int64)],
        [[0, 1], [0, 1], [2, 3], [2, 3]],
    ),
    "mismatch_in_one_group": (
        [np.zeros((2,), np.float32), np.zeros((2, 2), np.float32),
         np.asarray([5.0], np.float32), np.asarray([6.0], np.float32)],
        [[0, 1], [0, 1], [2, 3], [2, 3]],
    ),
    "outside_the_world": ([np.asarray([1.0]), np.asarray([2.0])], [[0, 5], [0, 5]]),
    "bad_only_on_one_rank": ([np.asarray([1.0]), np.asarray([2.0]), np.asarray([3.0])], [[0, 1, 2], [0, 1, 2], [7]]),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_groups_match_the_jax_package(case):
    per_rank, groups = GROUP_CASES[case]
    _, errors, _ = _parity(per_rank, groups)
    if case == "mismatch_in_one_group":
        assert errors[0] is not None and errors[1] is not None and errors[2] is None and errors[3] is None
    if case == "bad_only_on_one_rank":
        assert errors[2] is not None and errors[0] is None and errors[1] is None


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_ragged_mixes(seed):
    rng = np.random.RandomState(seed)
    nprocs = int(rng.randint(2, 5))
    trailing = tuple(rng.randint(1, 4, size=rng.randint(0, 2)))
    dtype = rng.choice([np.float32, np.int32, np.float64])
    per_rank = []
    for _ in range(nprocs):
        rows = int(rng.randint(0, 5))
        per_rank.append(np.zeros((0,), np.float32) if rows == 0 else (rng.rand(rows, *trailing) * 100).astype(dtype))
    _parity(per_rank)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_group_partitions(seed):
    rng = np.random.RandomState(1000 + seed)
    nprocs = int(rng.randint(2, 6))
    ranks = list(rng.permutation(nprocs))
    parts = []
    while ranks:
        take = int(rng.randint(1, len(ranks) + 1))
        parts.append(sorted(int(r) for r in ranks[:take]))
        ranks = ranks[take:]
    group_of = {r: part for part in parts for r in part}
    per_rank = [None] * nprocs
    for part in parts:
        trailing = tuple(rng.randint(1, 4, size=rng.randint(0, 2)))
        dtype = rng.choice([np.float32, np.int64, np.float16])
        for r in part:
            rows = int(rng.randint(0, 4))
            if rows == 0 and len(part) > 1:
                per_rank[r] = np.zeros((0,), np.float32)
            else:
                per_rank[r] = (rng.rand(max(rows, 1), *trailing) * 50).astype(dtype)
    _parity(per_rank, [group_of[r] for r in range(nprocs)])


# -- the packed bundle (tests/bases/test_packed_gather.py) ---------------------

TREE_CASES = {
    "mixed_bundle": (
        [[{"a": np.asarray([1.0 + r, 2.0], np.float32), "b": np.int32(r)}, {"c": [np.asarray([[r, r]], np.int64)]}]
         for r in range(2)],
        None,
    ),
    "ragged_and_empty": (
        [[{"x": np.arange(12, dtype=np.float32).reshape(4, 3), "y": np.zeros((0,), np.float32)}],
         [{"x": np.arange(6, dtype=np.float32).reshape(2, 3) + 100, "y": np.arange(4, dtype=np.int64)}]],
        None,
    ),
    "bool_before_int64": (
        [[{"flags": np.asarray([True, False, True]), "n": np.asarray([2 ** 40 + r], np.int64)}] for r in range(3)],
        None,
    ),
    "all_empty": ([[{"a": np.zeros((0,), np.float32), "b": np.zeros((0, 2), np.int32)}]] * 2, None),
    "disjoint_groups": (
        [[{"v": np.arange(3 + r, dtype=np.float32), "w": np.asarray([r], np.int32)}] for r in range(2)]
        + [[{"m": np.full((2, 2), r, np.int64), "n": np.float32(r)}] for r in range(2, 4)],
        [[0, 1], [0, 1], [2, 3], [2, 3]],
    ),
    "group_mismatch": (
        [[{"v": np.zeros((2,), np.float32)}], [{"v": np.zeros((2, 2), np.float32)}],
         [{"v": np.asarray([5.0], np.float32)}], [{"v": np.asarray([6.0], np.float32)}]],
        [[0, 1], [0, 1], [2, 3], [2, 3]],
    ),
    "bad_leaf_inside": (
        [[{"ok": np.asarray([1.0], np.float32), "bad": np.zeros((2,), np.complex64)}],
         [{"ok": np.asarray([2.0], np.float32), "bad": np.asarray([9.0], np.float32)}]],
        None,
    ),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_gather_all_pytrees_matches_the_jax_package(case):
    per_rank, groups = TREE_CASES[case]
    _, errors, calls = _parity(per_rank, groups, kind="trees")
    assert calls == [1 if case == "all_empty" else 2] * len(per_rank)  # the whole bundle: two rounds at most
    if case == "bad_leaf_inside":
        assert errors[0] is not None and errors[1] is None


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_bundles_match_the_jax_package(seed):
    rng = np.random.RandomState(3000 + seed)
    nprocs = int(rng.randint(2, 4))
    specs = [(tuple(rng.randint(1, 4, size=rng.randint(0, 2))), rng.choice([np.float32, np.int32, np.int64, np.bool_]))
             for _ in range(int(rng.randint(2, 6)))]
    per_rank = []
    for _ in range(nprocs):
        tree = {}
        for j, (trailing, dtype) in enumerate(specs):
            rows = int(rng.randint(0, 4))
            tree[f"l{j}"] = np.zeros((0,), np.float32) if rows == 0 else (rng.rand(rows, *trailing) * 50).astype(dtype)
        per_rank.append([tree])
    _parity(per_rank, kind="trees")


@pytest.mark.parametrize("seed", range(6))
def test_align_leaf_matches_the_jax_package(seed):
    """``_align_leaf`` on random descriptor tables: shapes, counts, dtype and
    the group error, held directly against the JAX package's."""
    rng = np.random.RandomState(seed)
    nprocs = int(rng.randint(1, 6))
    desc = np.zeros((nprocs, 10), np.int64)
    for i in range(nprocs):
        ndim = int(rng.randint(0, 4))
        desc[i, 0] = ndim
        desc[i, 1:1 + ndim] = rng.randint(0, 4, ndim)
        desc[i, -1] = rng.randint(0, 9) if rng.rand() < 0.3 else 7
    members = sorted(rng.choice(nprocs, int(rng.randint(1, nprocs + 1)), replace=False).tolist())
    shapes, counts, dtype, error = tdist._align_leaf(desc.tolist(), members)
    want_shapes, want_counts, want_dtype, want_error = jdist._align_leaf(desc, members)
    assert sorted(shapes) == sorted(want_shapes)
    for i in members:
        assert shapes[i] == tuple(int(d) for d in want_shapes[i])
    assert counts == [int(c) for c in want_counts]
    assert _np_dtype(dtype) == want_dtype
    assert (error or "").replace("gather_all_tensors", "gather_all_arrays") == (want_error or "")


def test_payload_offsets_are_aligned_for_every_dtype():
    rows = [tdist._leaf_descriptor(torch.zeros(n, dtype=d))[0] for n, d in
            [(3, torch.bool), (1, torch.int64), (5, torch.float16), (2, torch.float64), (0, torch.int32), (1, torch.int8)]]
    offsets, total = tdist._row_layout(rows)
    assert offsets == [0, 16, 32, 48, 64, 64] and total == 80


# -- the metric and the collection over the simulated ranks ---------------------


class _IntCat(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, x):
        self.rows.append(x.to(torch.int32))

    def compute(self):
        return dim_zero_cat(self.rows)


def test_an_empty_rank_takes_its_peers_dtype_and_an_all_empty_sync_keeps_its_own():
    def rank(values):
        def run():
            m = _IntCat()
            if values is not None:
                m.update(torch.tensor(values))
            with m.sync_context(distributed_available=lambda: True):
                return m.rows

        return run

    got, errors, calls = _run_ranks([rank(None), rank([1, 2]), rank([3])], "torch")
    assert errors == [None] * 3 and calls == [2] * 3
    for rows in got:
        assert rows.dtype == torch.int32 and rows.tolist() == [1, 2, 3]
    got, errors, _ = _run_ranks([rank(None), rank([])], "torch")
    assert errors == [None, None]
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32  # the placeholder; the declared dtype


def test_collection_compute_is_two_rounds_and_restores_local_states():
    rng = np.random.RandomState(0)
    probs = rng.rand(2, 32, 3).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    target = rng.randint(0, 3, (2, 32))

    def build():
        return T.MetricCollection([
            T.Accuracy(device="cpu"), T.Precision(average="macro", num_classes=3, device="cpu"),
            T.Recall(average="macro", num_classes=3, device="cpu"), T.Specificity(average="macro", num_classes=3,
                                                                                  device="cpu"),
            T.ConfusionMatrix(3, device="cpu"), T.IoU(3, device="cpu"),
        ])

    def rank(r):
        def run():
            coll = build()
            coll.update(torch.from_numpy(probs[r]), torch.from_numpy(target[r]))
            before = {n: {k: v.clone() for k, v in m._get_states().items()} for n, m in coll.items(keep_base=True)}
            out = coll.compute()
            for n, m in coll.items(keep_base=True):
                assert m._to_sync
                for k, v in m._get_states().items():
                    assert torch.equal(v, before[n][k]), (n, k)
            return out

        return run

    got, errors, calls = _run_ranks([rank(0), rank(1)], "torch")
    assert errors == [None, None] and calls == [2, 2]
    whole = build()
    whole.update(torch.from_numpy(probs.reshape(64, 3)), torch.from_numpy(target.reshape(64)))
    want = whole.compute()
    for out in got:
        for k in want:
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)


# -- the transports ------------------------------------------------------------------


def test_transport_resolution_order_matches_the_jax_package():
    from metrics_tpu import transport as jt
    from metrics_tpu_torch import transport as tt

    for mod in (jt, tt):
        m = _IntCat() if mod is tt else None
        assert mod.get_transport().name == "auto" and mod.active_transport_name() == "auto"
        gather, loop = mod.GatherTransport(), mod.LoopbackTransport()
        previous = mod.set_transport(gather)
        try:
            assert previous is None and mod.get_transport() is gather
            with mod.use_transport(loop):
                assert mod.get_transport() is loop and mod.active_transport_name() == "loopback"
                if m is not None:
                    assert mod.resolve_transport(m) is loop
                    m.set_transport(gather)
                    assert mod.resolve_transport(m) is gather and m.transport is gather
            assert mod.get_transport() is gather
        finally:
            mod.set_transport(None)
        with pytest.raises(TypeError):
            mod.set_transport(object())
    with pytest.raises(TypeError):
        _IntCat().set_transport(object())


@pytest.mark.parametrize("parent, members", [(None, [2, 0]), ([0, 1, 2], [1, 5]), ([0, 1], [0, 1]), ([3], [4]),
                                             (None, [])])
def test_gather_transport_subgroups_narrow_and_never_widen_as_in_the_jax_package(parent, members):
    from metrics_tpu import transport as jt
    from metrics_tpu_torch import transport as tt

    outcomes = []
    for mod in (jt, tt):
        base = mod.GatherTransport(participants=parent)
        try:
            sub = base.subgroup(members)
            outcomes.append((sub.participants, sub is base))
        except ValueError as err:
            outcomes.append(("ValueError", str(err)))
    assert outcomes[0] == outcomes[1]


def test_loopback_gathers_the_same_tensors_and_reduces_elementwise_leaves_in_place():
    from metrics_tpu_torch.transport import LoopbackTransport

    t = LoopbackTransport()
    x, y = torch.arange(3), torch.zeros(2, 2)
    got = t.gather_pytrees([{"b": [x], "a": y}])[0]
    assert got["a"][0] is y and got["b"][0][0] is x
    assert t.gather_array(x)[0] is x
    states = {"s": x, "c": [y], "n": y}
    assert t.reduce_states(states, {"s": "sum", "c": "cat", "n": None}) == {"s": x}
    assert t.reduce_states({"c": [y]}, {"c": "cat"}) is None
    assert t.participants == [0] and not t.distributed() and t.subgroup([0]) is t
    with pytest.raises(ValueError, match="outside"):
        t.gather_array(x, group=[3])


def test_a_metric_pinned_to_a_subgroup_transport_decodes_only_its_participants():
    from metrics_tpu_torch.transport import GatherTransport

    def rank(r):
        def run():
            m = _IntCat().set_transport(GatherTransport(participants=[0, 2]))
            m.update(torch.tensor([r, r]))
            with m.sync_context(distributed_available=lambda: True):
                return m.rows.tolist()

        return run

    got, errors, calls = _run_ranks([rank(0), rank(1), rank(2)], "torch")
    assert errors == [None] * 3 and calls == [2] * 3  # the rounds still span every rank
    assert got == [[0, 0, 2, 2]] * 3


# -- the gathers' telemetry -------------------------------------------------------------

#: sync-record fields that must equal the JAX package's exactly
_SYNC_FIELDS = ("gathers", "gather_errors", "gather_leaves", "payload_bytes_out", "payload_bytes_in",
                "descriptor_rounds", "payload_rounds", "subgroup_rounds", "transports", "groups", "participants")


@pytest.fixture()
def telemetry():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.reset()


def _spans(obs, nprocs):
    records = obs.TRACER.records()
    return [[s.span_id for s in records if s.process == r] for r in range(nprocs)]


def _payload_bytes(per_rank, align):
    """The payload round's width: the largest rank's leaf bytes, each leaf
    rounded up to ``align`` (a leaf the protocol cannot align rides as none)."""
    def leaf_bytes(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "c" or arr.dtype == _BF16 or arr.ndim > 8:
            return 0
        return -(-arr.size * arr.dtype.itemsize // align) * align

    return max(sum(leaf_bytes(leaf) for leaf in tdist._tree_leaves(local, [])) for local in per_rank)


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_gather_spans_and_sync_records_match_the_jax_package(telemetry, case):
    per_rank, groups = TREE_CASES[case]
    nprocs = len(per_rank)
    _parity(per_rank, groups, kind="trees")
    assert _spans(tobs, nprocs) == _spans(jobs, nprocs)
    assert all(len(ids) == (2 if case == "all_empty" else 3) for ids in _spans(tobs, nprocs))
    tsync, jsync = tobs.snapshot()["sync"], jobs.snapshot()["sync"]
    for field in _SYNC_FIELDS:
        assert tsync[field] == jsync[field], field
    # transport_bytes: the same descriptor bytes; the payload round's width
    # differs only by the port's 16-byte leaf alignment
    padding = nprocs * nprocs * (_payload_bytes(per_rank, 16) - _payload_bytes(per_rank, 1))
    assert tsync["transport_bytes"] == jsync["transport_bytes"] + padding


def test_span_ids_of_successive_gathers_count_up_per_group(telemetry):
    per_rank = [np.asarray([1.0 + r], np.float32) for r in range(3)]
    for _ in range(2):
        _parity(per_rank)
    ids = _spans(tobs, 3)
    assert ids == _spans(jobs, 3)
    assert ids[0] == [f"gather|0,1,2|{b}|{n}" for n in range(2) for b in ("descriptor", "payload", "transport")]
    assert ids[0] == ids[1] == ids[2]  # the same collective, the same id on every rank


def test_collection_sync_spans_and_counters_match_the_jax_package(telemetry):
    rng = np.random.RandomState(0)
    probs = rng.rand(2, 32, 3).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    target = rng.randint(0, 3, (2, 32))

    def build(pkg, **dev):
        return pkg.MetricCollection({
            "Accuracy": pkg.Accuracy(**dev), "Precision": pkg.Precision(average="macro", num_classes=3, **dev),
            "Recall": pkg.Recall(average="macro", num_classes=3, **dev), "ConfusionMatrix": pkg.ConfusionMatrix(3, **dev),
        })

    colls = {"jax": [build(J) for _ in range(2)], "torch": [build(T, device="cpu") for _ in range(2)]}

    def rank(pkg, r):
        conv = jnp.asarray if pkg == "jax" else torch.from_numpy

        def run():
            coll = colls[pkg][r]
            coll.update(conv(probs[r]), conv(target[r]))
            return coll.compute()

        return run

    for pkg in ("jax", "torch"):
        _, errors, calls = _run_ranks([rank(pkg, 0), rank(pkg, 1)], pkg)
        assert errors == [None, None] and calls == [2, 2]
    assert _spans(tobs, 2) == _spans(jobs, 2)
    assert _spans(tobs, 2)[0][-1] == "sync|None|collection|0"
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    for tcoll, jcoll in zip(colls["torch"], colls["jax"]):
        for name in tcoll.keys(keep_base=True):
            want = jsnap["metrics"][jcoll[name].telemetry_key]["counters"]
            got = tsnap["metrics"][tcoll[name].telemetry_key]["counters"]
            assert got.get("sync_calls") == want.get("sync_calls"), name
