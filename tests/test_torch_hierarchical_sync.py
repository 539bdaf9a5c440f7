"""``Hierarchy``, the store-backed subgroup channel and the async engine's
quorum over four gloo processes.

Counterpart of ``tests/bases/test_hierarchical_sync.py`` and of the subgroup
half of ``test_transport_equivalence.py``. One module-scoped set of four
spawned gloo processes runs every case; each case is its own test:

* a two-level ``Hierarchy(2)`` (two nodes of two ranks) reduces every packed
  bucket within the node, among the leaders, then back: the synced state and
  ``apply_compute(state, process_group=hierarchy)`` equal the flat sync over
  the world (integers and extremes exactly, float sums within 1e-6);
* the ``StoreSubgroupChannel`` (registered by default over the process
  group's store) runs a subgroup's rounds among ranks 0-2 while rank 3 never
  takes part, and the sync record counts a subgroup round over them; a round
  that names rank 3 times out on the channel's deadline; a payload round that
  rank 1 drops leaves the next round over the same ranks aligned;
* with rank 3 out of the membership epoch, ``compute_async(on_degraded=
  "quorum")`` on ranks 0-2 syncs over them alone (``quorum_syncs``), the
  value equal to those three ranks' data in one process.
"""
import datetime
import multiprocessing as mp
import socket
import warnings

import numpy as np
import pytest
import torch

WORLD = 4
C = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data():
    rng = np.random.RandomState(21)
    out = []
    for rank in range(WORLD):
        x = rng.rand(10 + rank, C).astype(np.float32)
        out.append((x / x.sum(-1, keepdims=True), rng.randint(0, C, 10 + rank)))
    return out


def _state(rank):
    g = torch.Generator().manual_seed(rank)
    return {
        "s": torch.randint(0, 100, (5,), generator=g, dtype=torch.int32),
        "f": torch.rand((2, 3), generator=g),
        "mx": torch.randint(0, 100, (4,), generator=g, dtype=torch.int64),
        "mn": torch.randint(0, 100, (4,), generator=g, dtype=torch.int64),
        "mean": torch.rand(3, generator=g, dtype=torch.float64),
        "cat": torch.arange(rank + 1, dtype=torch.float32),
        "none": torch.tensor([rank]),
    }


REDUCTIONS = {"s": "sum", "f": "sum", "mx": "max", "mn": "min", "mean": "mean", "cat": "cat", "none": None}


def _case_hierarchy(rank, data):
    import torch.distributed as dist

    import metrics_tpu_torch as T
    from metrics_tpu_torch.utilities.distributed import Hierarchy, sync_state_packed

    hierarchy = Hierarchy(2)
    flat = sync_state_packed(_state(rank), REDUCTIONS, dist.group.WORLD)
    hier = sync_state_packed(_state(rank), REDUCTIONS, hierarchy)
    m = T.Accuracy(device="cpu")
    m.update(*map(torch.as_tensor, data[rank]))
    state = m._get_states()
    return {
        "levels": [label for label, _ in hierarchy.levels], "leader": hierarchy.leader,
        "inter_member": hierarchy.levels[1][1] is not None,
        "flat": {k: v.tolist() for k, v in flat.items()}, "hier": {k: v.tolist() for k, v in hier.items()},
        "value_flat": float(m.apply_compute(state, process_group=dist.group.WORLD)),
        "value_hier": float(m.apply_compute(state, process_group=hierarchy)),
    }


def _case_channel(rank, data):
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.transport import GatherTransport, kvstore_subgroup_allgather, subgroup_allgather

    observability.reset()
    observability.enable()
    out = {}
    if rank < 3:
        transport = GatherTransport(participants=[0, 1, 2])  # a transport's creation registers the default
        out["channel"] = type(subgroup_allgather()).__name__
        got = transport.gather_pytrees([torch.tensor([rank, rank * rank])])[0]
        out["got"] = [t.tolist() for t in got]
        sync = observability.snapshot()["sync"]
        out["sync"] = {"subgroup_rounds": sync["subgroup_rounds"], "participants": sync["participants"]}
        # the JAX package's function name, over the same default channel
        out["direct"] = kvstore_subgroup_allgather(torch.tensor([rank, 7], dtype=torch.int64), [0, 1, 2]).tolist()
    return out


def _case_dead_peer(rank, data):
    import time

    import metrics_tpu_torch.resilience as res
    from metrics_tpu_torch.transport import GatherTransport, StoreSubgroupChannel, set_subgroup_allgather

    out = {}
    if rank >= 2:
        return out
    previous = set_subgroup_allgather(StoreSubgroupChannel(timeout_s=1.0, prefix="dead"))
    try:
        t0 = time.monotonic()
        try:
            GatherTransport(participants=[0, 1, 3]).gather_pytrees([torch.tensor([rank])])
            out["timed_out"] = False
        except RuntimeError:
            out["timed_out"] = True
        out["waited_s"] = time.monotonic() - t0
        # rank 1 drops its first payload round; the next round over [0, 1]
        # still lines up
        plan = res.FaultPlan(0, [res.FaultSpec("transport.payload", "drop", at=[0], process=1)])
        with res.fault_plan(plan):
            try:
                GatherTransport(participants=[0, 1]).gather_pytrees([torch.tensor([rank, 0])])
                out["first"] = "ok"
            except res.DroppedFault:
                out["first"] = "dropped"
            except RuntimeError:  # the store's wait ran out: the peer skipped the round
                out["first"] = "timed out"
            if rank == 1:  # let rank 0's payload wait run out before the next round
                time.sleep(1.3)
            got = GatherTransport(participants=[0, 1]).gather_pytrees([torch.tensor([rank, 1])])[0]
        out["second"] = [t.tolist() for t in got]
    finally:
        set_subgroup_allgather(previous)
    return out


def _case_quorum(rank, data):
    import metrics_tpu_torch as T
    import metrics_tpu_torch.resilience as res
    from metrics_tpu_torch.utilities.async_sync import get_engine

    res.MEMBERSHIP.reset(world=WORLD)
    res.MEMBERSHIP.mark_failed(3, reason="test")
    out = {}
    if rank < 3:
        m = T.Accuracy(device="cpu")
        m.update(*map(torch.as_tensor, data[rank]))
        value = m.compute_async(on_degraded="quorum").result(timeout=60)
        out = {"value": float(value), "quorum_syncs": get_engine().summary()["quorum_syncs"]}
    res.MEMBERSHIP.reset()
    return out


CASES = {"hierarchy": _case_hierarchy, "channel": _case_channel, "dead_peer": _case_dead_peer,
         "quorum": _case_quorum}


def _worker(rank, port, data, results):
    import torch.distributed as dist

    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        for name, case in CASES.items():
            try:
                out[name] = {"result": case(rank, data)}
            except Exception as err:  # reported by the case's own test
                out[name] = {"error": f"{type(err).__name__}: {err}"}
            dist.barrier()
    finally:
        results.put((rank, out))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    data = _data()
    procs = [ctx.Process(target=_worker, args=(rank, port, data, results)) for rank in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return {name: [got[r][name] for r in range(WORLD)] for name in CASES}, data


def _ok(ranks, name):
    per_rank, data = ranks
    for rank, r in enumerate(per_rank[name]):
        assert "error" not in r, f"rank {rank}: {r.get('error')}"
    return [r["result"] for r in per_rank[name]], data


def test_a_hierarchical_sync_equals_the_flat_sync(ranks):
    got, data = _ok(ranks, "hierarchy")
    states = [_state(r) for r in range(WORLD)]
    want = {
        "s": sum(s["s"] for s in states).tolist(), "mx": torch.stack([s["mx"] for s in states]).amax(0).tolist(),
        "mn": torch.stack([s["mn"] for s in states]).amin(0).tolist(),
        "cat": torch.cat([s["cat"] for s in states]).tolist(), "none": [[r] for r in range(WORLD)],
    }
    for rank, r in enumerate(got):
        assert r["levels"] == ["intra", "inter"] and r["leader"] == 2 * (rank // 2)
        assert r["inter_member"] == (rank % 2 == 0)
        for k in ("s", "mx", "mn", "cat", "none"):
            assert r["hier"][k] == r["flat"][k] == want[k], k
        np.testing.assert_allclose(r["hier"]["f"], r["flat"]["f"], rtol=1e-6)
        np.testing.assert_allclose(r["hier"]["mean"], np.mean([s["mean"].numpy() for s in states], 0), rtol=1e-12)
        assert r["value_hier"] == r["value_flat"]
    import metrics_tpu_torch as T

    whole = T.Accuracy(device="cpu")
    for preds, target in data:
        whole.update(torch.as_tensor(preds), torch.as_tensor(target))
    assert got[0]["value_flat"] == pytest.approx(float(whole.compute()), abs=1e-7)


def test_a_subgroup_round_runs_over_the_store_channel_without_the_fourth_rank(ranks):
    got, _ = _ok(ranks, "channel")
    for rank in range(3):
        assert got[rank]["channel"] == "StoreSubgroupChannel"
        assert got[rank]["got"] == [[0, 0], [1, 1], [2, 4]]
        assert got[rank]["sync"]["subgroup_rounds"] == 1
        assert got[rank]["sync"]["participants"] == {"gather": [0, 1, 2]}
        assert got[rank]["direct"] == [[0, 7], [1, 7], [2, 7]]


def test_a_round_naming_a_dead_peer_times_out_and_a_dropped_payload_keeps_the_rounds_aligned(ranks):
    got, _ = _ok(ranks, "dead_peer")
    for rank in range(2):
        r = got[rank]
        assert r["timed_out"] and 0.9 <= r["waited_s"] < 10
        assert r["first"] == ("dropped" if rank == 1 else "timed out")
        assert r["second"] == [[0, 1], [1, 1]]


def test_the_quorum_policy_syncs_over_the_healthy_ranks_alone(ranks):
    got, data = _ok(ranks, "quorum")
    import metrics_tpu_torch as T

    healthy = T.Accuracy(device="cpu")
    for preds, target in data[:3]:
        healthy.update(torch.as_tensor(preds), torch.as_tensor(target))
    for rank in range(3):
        assert got[rank]["quorum_syncs"] == 1
        assert got[rank]["value"] == pytest.approx(float(healthy.compute()), abs=1e-7)
    assert got[3] == {}
