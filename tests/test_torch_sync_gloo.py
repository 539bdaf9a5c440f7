"""The epoch-end sync over ``torch.distributed`` in two gloo processes.

One module-scoped pair of spawned processes runs every case below and sends
its results back; each case is then its own test that reads them, so the
spawn is paid once. Every case counts the calls of the protocol's one
collective (``utilities/distributed.py::_all_gather``) on each rank. Cases:

* the three probes of the empty-rank fault: a rank that never updated
  ``AUROC`` (int64 targets), ``StatScores(reduce="samples")`` or a list-mode
  multiclass ``AUROC``; the values must equal one process fed the whole
  stream and the synced states keep the data's dtypes;
* a macro collection with ``Specificity``, ``ConfusionMatrix``, ``IoU``,
  ``CohenKappa`` and ``MatthewsCorrcoef`` over ragged ranks: two rounds per
  process group (one when every contribution is empty), values equal to the
  whole stream in one process and to the JAX package on it;
* a ``MultiTenantCollection``: two rounds per bundle at N = 10 and 1000;
* groups: a ``ProcessGroup`` handle over both ranks, one over rank 0 alone,
  and disjoint rank collections in one round;
* ``apply_compute(state, process_group=WORLD)`` against ``compute()``;
* ``BootStrapper``'s pure ``apply_compute`` over the group: the stacked
  children synced leaf by leaf under their reductions, against the two
  ranks' stacked states merged in one process;
* telemetry: the collection's sync and one ``sync_state_packed`` with its
  spans and sync records, against the JAX package's (its collection in N
  threads at a barrier, its packed sync in ``shard_map`` over two devices);
* the fleet: the clock handshake, four gathers that rank 1 enters 50 ms
  late, ``gather_fleet`` and the published ``straggler_report`` (rank 1
  flagged on both ranks, ``degraded_processes() == [1]``), the
  ``aggregate_snapshots`` round, and the async engine's ``degraded_rounds``
  and stale serve under ``on_degraded="stale"``.
"""
import datetime
import multiprocessing as mp
import socket
import time
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as T
import metrics_tpu_torch.utilities.distributed as tdist

WORLD = 2
C = 5
CPU = {"device": "cpu"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data(seed=0):
    """Seeded numpy inputs of every case, shared by the workers and the oracles."""
    rng = np.random.RandomState(seed)

    def probs(rows, c):
        x = rng.rand(rows, c).astype(np.float32)
        return x / x.sum(-1, keepdims=True)

    return {
        "auroc": (rng.rand(16).astype(np.float32), rng.randint(0, 2, 16).astype(np.int64)),
        "samples": (rng.rand(8, C).astype(np.float32), rng.randint(0, 2, (8, C))),
        "mc_auroc": (probs(12, 4), rng.randint(0, 4, 12)),
        # rank 0 takes three batches, rank 1 one
        "collection": [(probs(n, C), rng.randint(0, C, n)) for n in (32, 17, 9, 23)],
        "keyed": [(rng.randint(0, 1000, 64), probs(64, C), rng.randint(0, C, 64)) for _ in range(3)],
        # one (WORLD, ...) stack per leaf: rank r syncs row r
        "packed": {
            "a": rng.rand(WORLD, 2, 3).astype(np.float32),
            "b": rng.randint(0, 9, (WORLD, 4)).astype(np.int32),
            "c": rng.rand(WORLD).astype(np.float32),
            "d": rng.randint(0, 9, (WORLD, 2)).astype(np.int32),
        },
    }


PACKED_REDUCTIONS = {"a": "sum", "b": "sum", "c": "max", "d": "min"}


def _collection(pkg, **device):
    kw = dict(average="macro", num_classes=C, **device)
    return pkg.MetricCollection({
        "Accuracy": pkg.Accuracy(**device), "Precision": pkg.Precision(**kw), "Recall": pkg.Recall(**kw),
        "F1": pkg.F1(**kw), "Specificity": pkg.Specificity(**kw), "ConfusionMatrix": pkg.ConfusionMatrix(C, **device),
        "IoU": pkg.IoU(C, **device), "CohenKappa": pkg.CohenKappa(C, **device),
        "MatthewsCorrcoef": pkg.MatthewsCorrcoef(C, **device),
    })


def _keyed(n):
    kw = dict(average="macro", num_classes=C, **CPU)
    members = {"Accuracy": T.Accuracy(**CPU), "Precision": T.Precision(**kw), "Recall": T.Recall(**kw)}
    return T.MultiTenantCollection(members, n, **CPU)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


# -- the cases, as each rank runs them ------------------------------------------


def _case_probe_auroc(rank, data):
    m = T.AUROC(pos_label=1, **CPU)
    if rank == 0:
        m.update(*map(_t, data["auroc"]))
    with m.sync_context():
        dtypes = (str(m.preds.dtype), str(m.target.dtype))
    return {"value": m.compute().numpy(), "dtypes": dtypes}


def _case_probe_samples(rank, data):
    m = T.StatScores(reduce="samples", **CPU)
    if rank == 0:
        m.update(*map(_t, data["samples"]))
    return {"value": m.compute().numpy()}


def _case_probe_mc_auroc(rank, data):
    m = T.AUROC(num_classes=4, **CPU)
    if rank == 0:
        m.update(*map(_t, data["mc_auroc"]))
    with m.sync_context():
        dtypes = (str(m.preds.dtype), str(m.target.dtype))
    return {"value": m.compute().numpy(), "dtypes": dtypes}


def _case_collection(rank, data):
    coll = _collection(T, **CPU)
    for preds, target in data["collection"][:3] if rank == 0 else data["collection"][3:]:
        coll.update(_t(preds), _t(target))
    return {"values": _np(coll.compute())}


def _case_collection_two_groups(rank, data):
    coll = _collection(T, **CPU)
    coll["Other"] = T.Accuracy(process_group=[0, 1], **CPU)
    preds, target = data["collection"][rank]
    coll.update(_t(preds), _t(target))
    return {"values": _np(coll.compute())}


def _case_collection_all_empty(rank, data):
    coll = T.MetricCollection([T.StatScores(reduce="samples", **CPU)])
    return {"values": _np(coll.compute())}


def _keyed_case(n):
    def run(rank, data):
        keyed = _keyed(n)
        for ids, preds, target in data["keyed"][rank::WORLD]:
            keyed.update(_t(ids % n), _t(preds), _t(target))
        return {"values": _np(keyed.compute())}

    return run


def _case_group_handle(rank, data):
    import torch.distributed as dist

    both, alone = dist.new_group([0, 1]), dist.new_group([0])
    preds, target = data["collection"][rank]
    over_both = T.Precision(average="macro", num_classes=C, process_group=both, **CPU)
    over_both.update(_t(preds), _t(target))
    out = {"both": over_both.compute().numpy()}
    if rank == 0:  # a group of one member: its rounds touch rank 0 only
        over_alone = T.Precision(average="macro", num_classes=C, process_group=alone, **CPU)
        over_alone.update(_t(preds), _t(target))
        out["alone"] = over_alone.compute().numpy()
    return out


def _case_disjoint_rank_groups(rank, data):
    m = T.ConfusionMatrix(C, process_group=[rank], **CPU)
    m.update(*map(_t, data["collection"][rank]))
    return {"value": m.compute().numpy()}


def _case_apply_compute(rank, data):
    import torch.distributed as dist

    metrics = {
        "stat_scores": T.StatScores(reduce="macro", num_classes=C, **CPU),
        "accuracy": T.Accuracy(**CPU),
        "auroc": T.AUROC(num_classes=C, **CPU),
        "samples": T.StatScores(reduce="samples", **CPU),
    }
    preds, target = data["collection"][rank]
    out = {}
    for name, m in metrics.items():
        if not (name == "auroc" and rank == 1):  # an empty rank on the "cat" leaves
            m.update(_t(preds), _t(target))
        packed = m.apply_compute(m._get_states(), process_group=dist.group.WORLD)
        out[name] = (packed.numpy(), m.compute().numpy())
    return out


def _bootstrapper():
    return T.BootStrapper(T.Accuracy(**CPU), num_bootstraps=4, raw=True, sampling_strategy="multinomial")


def _case_bootstrap(rank, data):
    import torch.distributed as dist

    b = _bootstrapper()
    state = b.init_state()
    for preds, target in data["collection"][:3] if rank == 0 else data["collection"][3:]:
        state = b.apply_update(state, _t(preds), _t(target))
    synced = b.apply_compute(state, process_group=dist.group.WORLD)
    return {"children": _np(state["children"]), "synced": _np(synced)}


def _case_telemetry(rank, data):
    import torch.distributed as dist

    from metrics_tpu_torch import observability

    observability.reset()
    coll = _collection(T, **CPU)
    for preds, target in data["collection"][:3] if rank == 0 else data["collection"][3:]:
        coll.update(_t(preds), _t(target))
    coll.compute()
    state = {k: _t(v[rank]) for k, v in data["packed"].items()}
    tdist.sync_state_packed(state, PACKED_REDUCTIONS, dist.group.WORLD)
    snap = observability.snapshot()
    return {
        "spans": [(s.span_id, s.process) for s in observability.TRACER.records()],
        "sync": snap["sync"],
        "sync_calls": {n: snap["metrics"][m.telemetry_key]["counters"].get("sync_calls")
                       for n, m in coll.items(keep_base=True)},
    }


#: how late rank 1 enters each of the fleet case's gathers
FLEET_DELAY_S = 0.05


def _case_fleet(rank, data):
    from metrics_tpu_torch import observability

    observability.reset()
    clock = observability.estimate_clock_offsets(3)
    for i in range(4):
        if rank == 1:
            time.sleep(FLEET_DELAY_S)
        tdist.gather_all_tensors(torch.tensor([rank, i]))
    fleet = observability.tracing.gather_fleet()
    report = observability.straggler_report(fleet, publish=True, min_lag_s=FLEET_DELAY_S / 2)
    degraded = observability.degraded_processes()
    m = T.Accuracy(**CPU)
    preds, target = data["collection"][rank]
    m.update(_t(preds), _t(target))
    before = observability.snapshot()["sync"]
    aggregated = observability.aggregate_snapshots()
    after = observability.snapshot()["sync"]
    first = m.compute_async(on_degraded="stale").result(timeout=30)  # no generation yet: a fresh round
    second = m.compute_async(on_degraded="stale")
    value = second.result(timeout=30)
    engine = observability.snapshot()["async_sync"]
    observability.TRACER.set_fleet_report(None)  # the cases after this one see no degraded peer
    return {
        "clock": clock, "processes": [p["process"] for p in fleet["processes"]],
        "analyzed": report["collectives"], "flagged": report["flagged"], "degraded": degraded,
        "lag_p50": {p: e["lag_p50_s"] for p, e in report["processes"].items()},
        "aggregated": {"process_count": aggregated["process_count"], "per_process": sorted(aggregated["per_process"]),
                       "updates": aggregated["merged"]["metrics"][m.telemetry_key]["counters"]["update_calls"]},
        "aggregate_rounds": [after[k] - before[k] for k in ("descriptor_rounds", "payload_rounds")],
        "first": float(first), "second": float(value), "stale": second.stale,
        "degraded_rounds": engine["degraded_rounds"], "stale_serves": engine["stale_serves"],
    }


CASES = {
    "probe_auroc": _case_probe_auroc,
    "probe_samples": _case_probe_samples,
    "probe_mc_auroc": _case_probe_mc_auroc,
    "collection": _case_collection,
    "collection_two_groups": _case_collection_two_groups,
    "collection_all_empty": _case_collection_all_empty,
    "keyed_10": _keyed_case(10),
    "keyed_1000": _keyed_case(1000),
    "group_handle": _case_group_handle,
    "disjoint_rank_groups": _case_disjoint_rank_groups,
    "apply_compute": _case_apply_compute,
    "bootstrap": _case_bootstrap,
    "telemetry": _case_telemetry,
    "fleet": _case_fleet,
}


def _worker(rank, port, data, results):
    import torch.distributed as dist

    warnings.simplefilter("ignore")
    torch.set_num_threads(1)  # small tensors: keep the two processes off the other tests' cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    calls = [0]
    real = tdist._all_gather

    def counted(buf, group):
        calls[0] += 1
        return real(buf, group)

    tdist._all_gather = counted
    out = {}
    try:
        for name, case in CASES.items():
            calls[0] = 0
            try:
                out[name] = {"result": case(rank, data), "rounds": calls[0]}
            except Exception as err:  # reported by the case's own test
                out[name] = {"error": f"{type(err).__name__}: {err}"}
            dist.barrier()
    finally:
        results.put((rank, out))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def synced():
    """Every case's results on both ranks: ``{case: [rank 0's, rank 1's]}``."""
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


def _ok(synced, name):
    per_rank, data = synced
    for rank, r in enumerate(per_rank[name]):
        assert "error" not in r, f"rank {rank}: {r.get('error')}"
    return [r["result"] for r in per_rank[name]], [r["rounds"] for r in per_rank[name]], data


def _whole(metric, batches):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for batch in batches:
            metric.update(*map(_t, batch))
        return metric.compute()


# -- the empty-rank probes (the fault's regression tests) -------------------------


@pytest.mark.parametrize("name", ["probe_auroc", "probe_samples", "probe_mc_auroc"])
def test_a_rank_that_never_updated_syncs(synced, name):
    got, rounds, data = _ok(synced, name)
    # each sync: the metric's whole state dict in one descriptor and one payload
    # round; the AUROC probes sync twice (their dtypes are read in a sync_context)
    assert rounds == ([2, 2] if name == "probe_samples" else [4, 4])
    if name == "probe_samples":
        want = _whole(T.StatScores(reduce="samples", **CPU), [data["samples"]])
    elif name == "probe_auroc":
        want = _whole(T.AUROC(pos_label=1, **CPU), [data["auroc"]])
    else:
        want = _whole(T.AUROC(num_classes=4, **CPU), [data["mc_auroc"]])
    for r in got:
        assert r["value"].dtype == want.numpy().dtype
        np.testing.assert_array_equal(r["value"], want.numpy())
        if "dtypes" in r:
            batch = data["auroc"] if name == "probe_auroc" else data["mc_auroc"]
            assert r["dtypes"] == (str(_t(batch[0]).dtype), str(_t(batch[1]).dtype))


# -- the collection: two rounds per process group ---------------------------------


def test_collection_syncs_in_two_rounds_and_equals_the_whole_stream_and_jax(synced):
    import jax.numpy as jnp

    import metrics_tpu as J

    got, rounds, data = _ok(synced, "collection")
    assert rounds == [2, 2]
    batches = data["collection"]
    whole = _whole(_collection(T, **CPU), batches)
    ref = _collection(J)
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    ref_out = ref.compute()
    for r in got:
        assert sorted(r["values"]) == sorted(whole)
        for k, value in r["values"].items():
            want = whole[k].numpy()
            assert value.dtype == want.dtype, k
            np.testing.assert_array_equal(value, want, err_msg=k)
            np.testing.assert_allclose(value, np.asarray(ref_out[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_collection_with_two_process_groups_takes_two_rounds_each(synced):
    got, rounds, data = _ok(synced, "collection_two_groups")
    assert rounds == [4, 4]
    coll = _collection(T, **CPU)
    coll["Other"] = T.Accuracy(**CPU)
    whole = _whole(coll, data["collection"][:WORLD])
    for r in got:
        for k, value in r["values"].items():
            np.testing.assert_array_equal(value, whole[k].numpy(), err_msg=k)


def test_collection_with_every_contribution_empty_takes_one_round(synced):
    got, rounds, _ = _ok(synced, "collection_all_empty")
    assert rounds == [1, 1]
    for r in got:
        assert r["values"]["StatScores"].size == 0


# -- the keyed bundles: two rounds each, whatever N ------------------------------


@pytest.mark.parametrize("n", [10, 1000])
def test_keyed_bundles_sync_in_two_rounds_each_at_any_n(synced, n):
    got, rounds, data = _ok(synced, f"keyed_{n}")
    keyed = _keyed(n)
    keyed.build()
    assert keyed.state_bundles == 2 and rounds == [4, 4]  # Accuracy, and Precision with Recall: two rounds each
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for ids, preds, target in data["keyed"]:
            keyed.update(_t(ids % n), _t(preds), _t(target))
        whole = keyed.compute()
    for r in got:
        for k, value in r["values"].items():
            np.testing.assert_allclose(value, whole[k].numpy(), rtol=0, atol=0, equal_nan=True, err_msg=k)


# -- groups ---------------------------------------------------------------------


def test_a_process_group_handle_runs_the_rounds_over_that_group(synced):
    got, rounds, data = _ok(synced, "group_handle")
    assert rounds == [4, 2]  # rank 0 also synced over its group of one
    both = _whole(T.Precision(average="macro", num_classes=C, **CPU), data["collection"][:WORLD])
    alone = _whole(T.Precision(average="macro", num_classes=C, **CPU), data["collection"][:1])
    for r in got:
        np.testing.assert_array_equal(r["both"], both.numpy())
    np.testing.assert_array_equal(got[0]["alone"], alone.numpy())


def test_disjoint_rank_groups_decode_their_own_members(synced):
    got, rounds, data = _ok(synced, "disjoint_rank_groups")
    assert rounds == [2, 2]
    for rank, r in enumerate(got):
        want = _whole(T.ConfusionMatrix(C, **CPU), [data["collection"][rank]])
        np.testing.assert_array_equal(r["value"], want.numpy())


# -- apply_compute(state, process_group=) ------------------------------------------


@pytest.mark.parametrize("name", ["stat_scores", "accuracy", "auroc", "samples"])
def test_apply_compute_over_a_process_group_equals_the_gather_path(synced, name):
    got, _, _ = _ok(synced, "apply_compute")
    for r in got:
        packed, gathered = r[name]
        assert packed.dtype == gathered.dtype
        np.testing.assert_array_equal(packed, gathered)


def test_bootstrap_apply_compute_syncs_the_stacked_children_leaf_by_leaf(synced):
    got, rounds, _ = _ok(synced, "bootstrap")
    b = _bootstrapper()
    merged = {}
    for name, fx in b.metrics[0]._reductions.items():
        a, c = (torch.from_numpy(r["children"][name]) for r in got)
        merged[name] = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[fx](a, c)
    want = _np(b.apply_compute({"children": merged}, process_group=None))
    assert rounds == [0, 0]  # elementwise leaves: all_reduce buckets, no gather round
    for r in got:
        assert sorted(r["synced"]) == sorted(want) == ["mean", "raw", "std"]
        for key in want:
            np.testing.assert_array_equal(r["synced"][key], want[key])


# -- telemetry: spans and sync records against the JAX package -------------------------


def _jax_collection_in_threads(data):
    """The JAX package's collection sync of the same partition, two ranks
    simulated by threads at a barrier; returns its tracer's spans per rank
    and its sync records (both ranks recorded into one registry) and the
    members' counters."""
    import threading

    import jax
    import jax.numpy as jnp

    import metrics_tpu as J
    import metrics_tpu.observability as jobs
    import metrics_tpu.utilities.distributed as jdist

    barrier, exchange, rank_of = threading.Barrier(WORLD), {}, {}

    def swap(x):
        exchange[rank_of[threading.get_ident()]] = np.asarray(x)
        barrier.wait()
        got = np.stack([exchange[r] for r in range(WORLD)])
        barrier.wait()
        return got

    colls, errors = [_collection(J) for _ in range(WORLD)], []

    def run(rank):
        rank_of[threading.get_ident()] = rank
        try:
            for preds, target in data["collection"][:3] if rank == 0 else data["collection"][3:]:
                colls[rank].update(jnp.asarray(preds), jnp.asarray(target))
            colls[rank].compute()
        except Exception as err:  # pragma: no cover - reported below
            errors.append(err)
            barrier.abort()

    patches = [(jdist, "_process_allgather", swap), (jdist, "distributed_available", lambda: True),
               (jdist, "world_size", lambda: WORLD), (jax, "process_index", lambda: rank_of[threading.get_ident()])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    jobs.reset()
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
    assert not errors, errors
    snap = jobs.snapshot()
    spans = [[s.span_id for s in jobs.TRACER.records() if s.process == r] for r in range(WORLD)]
    sync_calls = [{n: snap["metrics"][m.telemetry_key]["counters"].get("sync_calls") for n, m in c.items(keep_base=True)}
                  for c in colls]
    jobs.reset()
    return spans, snap["sync"], sync_calls


def _jax_packed_sync_record(data):
    """The JAX package's in-graph record of the same packed sync, traced in
    ``shard_map`` over two virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    import metrics_tpu.observability as jobs
    import metrics_tpu.utilities.distributed as jdist

    def body(state):
        return jdist.sync_state_packed({k: v[0] for k, v in state.items()}, PACKED_REDUCTIONS, "data")

    if hasattr(jax, "shard_map"):  # pragma: no cover - newer jax
        fn = jax.shard_map(body, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)), in_specs=P("data"),
                           out_specs=P(), check_vma=False)
    else:
        from jax.experimental.shard_map import shard_map

        fn = shard_map(body, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)), in_specs=P("data"),
                       out_specs=P(), check_rep=False)
    jobs.reset()
    jax.jit(fn)({k: jnp.asarray(v) for k, v in data["packed"].items()})
    record = jobs.snapshot()["sync"]["in_graph"]
    spans = [(s.kind, s.bucket, s.seq) for s in jobs.TRACER.records()]
    jobs.reset()
    return record, spans


def test_sync_spans_and_records_equal_the_jax_package(synced):
    got, rounds, data = _ok(synced, "telemetry")
    assert rounds == [2, 2]  # the collection's two rounds; sync_state_packed does no gather here
    port_spans = [[sid for sid, process in r["spans"]] for r in got]
    assert [p for r in got for _, p in r["spans"]] == [0] * len(got[0]["spans"]) + [1] * len(got[1]["spans"])
    assert port_spans[0] == port_spans[1]  # one id per collective, alike on both ranks

    jax_spans, jax_sync, jax_sync_calls = _jax_collection_in_threads(data)
    gather_spans = [sid for sid in port_spans[0] if not sid.startswith("in_graph|")]
    assert all(gather_spans == ids for ids in jax_spans)
    assert [r["sync_calls"] for r in got] == jax_sync_calls
    for field in ("gathers", "gather_errors", "gather_leaves", "payload_bytes_out", "payload_bytes_in",
                  "descriptor_rounds", "payload_rounds", "subgroup_rounds"):
        assert sum(r["sync"][field] for r in got) == jax_sync[field], field
    assert {k: {"gathers": sum(r["sync"]["groups"][k]["gathers"] for r in got), "world": WORLD}
            for k in got[0]["sync"]["groups"]} == jax_sync["groups"]

    record, jax_in_graph_spans = _jax_packed_sync_record(data)
    port_in_graph_spans = [tuple(sid.split("|")[i] for i in (0, 2, 3)) for sid in port_spans[0] if sid.startswith("in_graph|")]
    assert sorted(port_in_graph_spans) == sorted((k, b, str(n)) for k, b, n in jax_in_graph_spans)
    for r in got:
        ig = r["sync"]["in_graph"]
        for field in ("syncs", "states", "bytes_traced", "collectives", "buckets", "collectives_before",
                      "collectives_after", "dedup_groups", "dedup_members", "levels"):
            assert ig[field] == record[field], field
        assert ig["axes"] == {repr("[0, 1]"): 1}


# -- the fleet --------------------------------------------------------------------


def test_the_clock_handshake_over_two_processes(synced):
    got, _, _ = _ok(synced, "fleet")
    for rank, r in enumerate(got):
        clock = r["clock"]
        assert len(clock["offsets"]) == WORLD and clock["offsets"][rank] == 0.0 and clock["process"] == rank
        # both are rounded to 1e-9 s from the same unrounded round trip
        assert clock["rounds"] == 3 and abs(clock["uncertainty_s"] - clock["rtt_s"] / 2) <= 1e-9


def test_a_late_rank_is_flagged_on_every_rank(synced):
    got, _, _ = _ok(synced, "fleet")
    for r in got:
        assert r["processes"] == [0, 1] and r["analyzed"] >= 4
        assert r["flagged"] == [1] and r["degraded"] == [1]
        assert r["lag_p50"]["1"] >= FLEET_DELAY_S / 2 > r["lag_p50"]["0"]


def test_aggregate_snapshots_over_two_processes(synced):
    """Each process's snapshot rides one uint8 JSON leaf: one descriptor
    round and one payload round for the fleet."""
    got, _, _ = _ok(synced, "fleet")
    for r in got:
        assert r["aggregated"] == {"process_count": WORLD, "per_process": ["0", "1"], "updates": WORLD}
        assert r["aggregate_rounds"] == [1, 1]


def test_the_async_engine_serves_stale_while_a_peer_is_degraded(synced):
    got, _, data = _ok(synced, "fleet")
    whole = _whole(T.Accuracy(**CPU), data["collection"][:WORLD])
    for r in got:
        assert r["degraded_rounds"] == 2 and r["stale_serves"] == 1
        assert r["stale"] is True and r["second"] == r["first"] == pytest.approx(float(whole), abs=1e-6)
