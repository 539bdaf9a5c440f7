"""``ShardedTransport``, ``InGraphTransport`` and the transport registry
over two gloo processes.

Counterpart of ``tests/bases/test_transport_sharded.py`` and
``test_transport_equivalence.py``. One module-scoped pair of spawned gloo
processes runs every case and sends its results back; each case is then its
own test. On a ``DeviceMesh`` of the two CPU processes:

* ``shard_state`` splits a tenant-stacked leaf's rows 50/50 (a leaf whose
  leading dim does not divide stays replicated), and its full tensor equals
  the state it came from;
* ``reduce_states`` without a replica axis is the identity; across a
  replica axis it sums (maxes, averages) the ranks' partial states in place,
  as the JAX package's packed psum/pmax/pmean do;
* a checkpoint saved replicated restores sharded through ``place_state``;
* ``InGraphTransport`` and a sharded transport's gather fallback equal the
  gather transport's, and subgroups narrow as the JAX package's do.
"""
import datetime
import multiprocessing as mp
import socket
import warnings

import numpy as np
import pytest
import torch

WORLD = 2
N = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _keyed(rank):
    import metrics_tpu_torch as T

    m = T.KeyedMetric(T.Accuracy(device="cpu"), N, validate_ids=False, device="cpu")
    rng = np.random.RandomState(11)
    m.update(torch.as_tensor(rng.randint(0, N, 40)), torch.as_tensor(rng.rand(40).astype(np.float32)),
             torch.as_tensor(rng.randint(0, 2, 40)))
    return m


def _case_shard(rank, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.transport import ShardedTransport, tenant_sharding

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("shard",))
    t = ShardedTransport(mesh, "shard")
    m = _keyed(rank)
    state = dict(m._get_states())
    state["odd"] = torch.arange(3, dtype=torch.float32)  # 3 rows do not split over 2
    sharded = t.shard_state(state)
    reduced = t.reduce_states(sharded, {**m._reductions, "odd": "sum"})
    return {
        "placements": {k: str(v.placements) for k, v in sharded.items()},
        "local_rows": {k: int(v.to_local().shape[0]) for k, v in sharded.items()},
        "full_equal": all(torch.equal(v.full_tensor(), state[k]) for k, v in sharded.items()),
        "fractions": {k: t.max_shard_fraction(v) for k, v in sharded.items()},
        "reduced_identity": reduced is not None and all(reduced[k] is sharded[k] for k in reduced),
        "tenant_sharding": str(tenant_sharding(mesh, "shard")),
    }


def _case_replica(rank, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from metrics_tpu_torch.transport import ShardedTransport

    mesh = init_device_mesh("cpu", (1, WORLD), mesh_dim_names=("shard", "replica"))
    t = ShardedTransport(mesh, "shard", replica_axis="replica")
    partial = {
        "s": torch.arange(4, dtype=torch.int32) * (rank + 1),
        "m": torch.tensor([rank, 5 - rank], dtype=torch.int32),
        "a": torch.full((2,), float(rank + 1)),
        "cat": torch.tensor([float(rank)]),
    }
    reductions = {"s": "sum", "m": "max", "a": "mean", "cat": "cat"}
    dt = {k: DTensor.from_local(v, mesh, [Shard(0), Replicate()]) for k, v in partial.items()}
    out = t.reduce_states(dt, reductions)
    fallback = t.gather_pytrees([{"cat": partial["cat"]}])[0]["cat"]
    return {"handled": sorted(out), "values": {k: v.to_local().tolist() for k, v in out.items()},
            "fallback": [x.tolist() for x in fallback]}


def _case_place(rank, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch as T
    from metrics_tpu_torch.durability import CheckpointManager
    from metrics_tpu_torch.transport import ShardedTransport

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("shard",))
    t = ShardedTransport(mesh, "shard")
    m = _keyed(rank)
    d = f"{tmp}/rank{rank}"
    CheckpointManager(d, m).save()
    target = T.KeyedMetric(T.Accuracy(device="cpu"), N, validate_ids=False, device="cpu")
    CheckpointManager(d, target).restore(target, transport=t)
    adopted = t.adopt(_keyed(rank))
    return {
        "restored_equal": all(torch.equal(getattr(target, k).full_tensor(), v) for k, v in m._get_states().items()),
        "local_rows": int(target.tp.to_local().shape[0]),
        "adopted": adopted._transport is t and int(adopted.tp.to_local().shape[0]) == N // WORLD,
    }


def _case_equivalence(rank, tmp):
    from metrics_tpu_torch.transport import GatherTransport, InGraphTransport, get_transport

    tree = [{"x": torch.tensor([rank, rank * 10]), "y": torch.arange(rank + 1, dtype=torch.float32)}]
    gathered = GatherTransport().gather_pytrees(tree)
    in_graph = InGraphTransport().gather_pytrees(tree)
    auto = get_transport().gather_pytrees(tree)
    sub = InGraphTransport().subgroup([0])
    return {
        "equal": all(torch.equal(a, b) and torch.equal(a, c) for k in ("x", "y")
                     for a, b, c in zip(gathered[0][k], in_graph[0][k], auto[0][k])),
        "x": [v.tolist() for v in gathered[0]["x"]],
        "sub": [type(sub).__name__, sub.participants, InGraphTransport().participants],
    }


CASES = {"shard": _case_shard, "replica": _case_replica, "place": _case_place, "equivalence": _case_equivalence}


def _worker(rank, port, tmp, results):
    import torch.distributed as dist

    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        for name, case in CASES.items():
            try:
                out[name] = {"result": case(rank, tmp)}
            except Exception as err:  # reported by the case's own test
                out[name] = {"error": f"{type(err).__name__}: {err}"}
            dist.barrier()
    finally:
        results.put((rank, out))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    tmp = str(tmp_path_factory.mktemp("sharded"))
    procs = [ctx.Process(target=_worker, args=(rank, port, tmp, results)) for rank in range(WORLD)]
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
    return {name: [got[r][name] for r in range(WORLD)] for name in CASES}


def _ok(ranks, name):
    for rank, r in enumerate(ranks[name]):
        assert "error" not in r, f"rank {rank}: {r.get('error')}"
    return [r["result"] for r in ranks[name]]


def test_shard_state_splits_the_tenant_axis_and_keeps_the_values(ranks):
    for r in _ok(ranks, "shard"):
        assert r["full_equal"] and r["reduced_identity"]
        assert r["local_rows"]["tp"] == N // WORLD and r["fractions"]["tp"] == 0.5
        assert r["placements"]["odd"] == "(Replicate(),)" and r["fractions"]["odd"] == 1.0
        assert r["placements"]["tp"] == "(Shard(dim=0),)" and r["tenant_sharding"] == "[Shard(dim=0)]"


def test_reduce_states_across_replicas_equals_the_jax_packed_reductions(ranks):
    want_s = (np.arange(4) * 1 + np.arange(4) * 2).tolist()
    for r in _ok(ranks, "replica"):
        assert r["handled"] == ["a", "m", "s"]
        assert r["values"] == {"s": want_s, "m": [1, 5], "a": [1.5, 1.5]}
        assert r["fallback"] == [[0.0], [1.0]]


def test_a_replicated_checkpoint_restores_sharded_through_place_state(ranks):
    for r in _ok(ranks, "place"):
        assert r["restored_equal"] and r["local_rows"] == N // WORLD and r["adopted"]


def test_in_graph_transport_equals_the_eager_pair(ranks):
    for r in _ok(ranks, "equivalence"):
        assert r["equal"] and r["x"] == [[0, 0], [1, 10]]
        assert r["sub"] == ["InGraphTransport", [0], None]


def test_constructor_checks_equal_the_jax_package():
    from metrics_tpu_torch.transport import ShardedTransport

    class Mesh:
        mesh_dim_names = ("shard",)

    with pytest.raises(ValueError, match="no axis 'x'"):
        ShardedTransport(Mesh(), "x")
    with pytest.raises(ValueError, match="no axis 'r'"):
        ShardedTransport(Mesh(), "shard", replica_axis="r")
    with pytest.raises(TypeError, match="eager"):
        ShardedTransport(Mesh(), "shard", eager=object())
