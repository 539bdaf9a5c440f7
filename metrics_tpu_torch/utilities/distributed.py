"""Cross-process sync of metric state over ``torch.distributed``.

Counterpart of the eager half of ``metrics_tpu/utilities/distributed.py``:
the descriptor + payload gather protocol (``_leaf_descriptor`` ``:411``,
``_align_leaf`` ``:436``, ``_gather_all_leaves`` ``:490``,
``gather_all_arrays`` ``:740``, ``gather_all_pytrees`` ``:782``,
``_gather_pytrees_impl`` ``:820``), the eager meaning of the packed sync
``sync_state_packed`` ``:1152``, ``reduce`` ``:77`` and ``class_reduce``
``:88``; the thread-scoped
:class:`transport_overrides` (``:253-330``), the fault seams (``:706-735``)
and :class:`Hierarchy` (``:163-250``) with :func:`hierarchical_axis`. The
JAX package's in-graph sync over mesh axes has no counterpart:
:class:`Hierarchy` here is two levels of ``torch.distributed`` process
groups, which :func:`sync_state_packed` reduces over one after the other,
and :func:`shard_map_compat` raises.

**The gather protocol.** Every leaf of a whole state bundle crosses the
processes in ONE descriptor round and at most ONE payload round:

* the descriptor round all-gathers one ``(L, 10)`` int64 tensor, one row
  ``[ndim, d0..d7, dtype_code]`` per leaf (the codes index
  :data:`_GATHER_DTYPES`, the JAX package's nine dtypes in its order). It is
  the one host read of a sync: every shape, offset and alignment below is
  worked out on the host from it;
* the payload round all-gathers one ``uint8`` buffer per process holding
  every leaf's bytes, padded to the round's largest byte count (NCCL needs
  equal sizes). It is skipped on every process when every contribution is
  empty. **Layout difference:** each leaf starts at a 16-byte-aligned
  offset (the JAX package packs the leaves back to back), so that
  ``Tensor.view(dtype)`` can read an int64 leaf that follows a 3-byte bool
  leaf. Both sides compute the offsets from the descriptors, so no result
  changes;
* a process that never updated a list state contributes a ``(0,)`` float32
  placeholder: it is aligned to its group's trailing dims and dtype over the
  non-empty members (``_align_leaf``), so an empty rank neither breaks the
  collective nor changes a dtype;
* every error (a bad ``group``, a leaf over 8 dims or of a dtype outside the
  nine, bfloat16 among them, an ndim or dtype mismatch inside the group) is
  raised only after both rounds, on the processes it concerns, so a bad rank
  cannot hang its peers.

Both rounds go through :func:`_all_gather`, the module's one collective:
``torch.distributed.all_gather`` into a list of views of one stacked
tensor, which gloo and NCCL both take for ``uint8`` and ``int64`` (gloo
refuses ``all_gather_into_tensor``'s stacked output). The group's backend
decides where the buffers live: CUDA tensors on the current device under
NCCL, so the payload never leaves the card; CPU tensors otherwise (gloo).

``group`` takes ``None`` (the world), a ``torch.distributed.ProcessGroup``
(the rounds run over that group) or a collection of global ranks: then the
rounds span the world and only the decode narrows, as the JAX package does,
so disjoint groups sync in the same rounds.

**Telemetry** (``metrics_tpu/utilities/distributed.py:359-361,873-915,
1055-1088``). Each gather records three collective spans (the gather, its
descriptor round, its payload round) with deterministic ids, one
``TELEMETRY.record_gather`` (rounds, leaves, bytes, the rounds' host
times), the ``sync_round_trip_seconds`` and ``gather_payload_bytes``
histograms and a ``sync`` event; each :func:`sync_state_packed` call
records ``TELEMETRY.record_in_graph_sync`` and one span per bucket. The
byte counts are the JAX package's: ``bytes_out``/``bytes_in`` count the
leaves' own bytes, while ``transport_bytes`` counts what the rounds move,
the port's 16-byte alignment included. The times are host times. The
descriptor round's time is real, since it ends in the sync's one host
read; under NCCL the payload round's time is the time to enqueue it (the
card copies on after it returns), and nothing synchronizes to change that.
"""
import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.histogram import observe_gather_payload, observe_sync_round_trip
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability import tracing as _tracing
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.resilience.faults import maybe_fault
from metrics_tpu_torch.utilities.data import to_host

Tensor = torch.Tensor

#: descriptor layout of the gather: [ndim, d0..d7, dtype_code]
_MAX_GATHER_NDIM = 8
#: dtypes the gather can align across processes (code = index), in the JAX
#: package's order (``metrics_tpu/utilities/distributed.py:342-352``)
_GATHER_DTYPES = (
    torch.bool,
    torch.uint8,
    torch.int8,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.float16,
    torch.float32,
    torch.float64,
)
#: every leaf of the payload starts at a multiple of this many bytes
_PAYLOAD_ALIGN = 16


def reduce(to_reduce: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor with ``'elementwise_mean'``, ``'sum'`` or ``'none'``."""
    if reduction == "elementwise_mean":
        return torch.mean(to_reduce)
    if reduction == "none":
        return to_reduce
    if reduction == "sum":
        return torch.sum(to_reduce)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Reduce per-class fractions ``num / denom`` with micro/macro/weighted/none
    (``metrics_tpu/utilities/distributed.py:88``).

    A 0/0 class (NaN) counts as 0; infinities stay as they are.
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        w = weights.to(fraction.dtype)
        return torch.sum(fraction * (w / torch.sum(w)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(
        f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}"
    )


def shard_map_compat(fn: Callable, *, mesh: Any, in_specs: Any, out_specs: Any, **kwargs: Any) -> Callable:
    """Raises: the JAX package's ``shard_map`` shim
    (``metrics_tpu/utilities/distributed.py:145``) has no counterpart.

    The port runs no program over mesh axes. Its processes sync a state
    over ``torch.distributed``: ``Metric.sync``/``compute()``,
    ``apply_compute(state, process_group=...)``, :func:`sync_state_packed`
    (with a :class:`Hierarchy` for two levels) and :func:`gather_all_pytrees`.
    """
    raise NotImplementedError(
        "shard_map_compat: the port has no shard_map; sync a state over torch.distributed with"
        " Metric.compute()/apply_compute(state, process_group=...), sync_state_packed (a Hierarchy for two levels)"
        " or gather_all_pytrees"
    )


class Hierarchy:
    """Two-level process groups for a hierarchical packed sync
    (``metrics_tpu/utilities/distributed.py:163``).

    ``Hierarchy(node_size)`` splits the world into nodes of ``node_size``
    consecutive ranks and builds one ``torch.distributed`` group per node
    (``"intra"``, innermost) and one over the node leaders, each node's
    first rank (``"inter"``). :func:`sync_state_packed` given a hierarchy
    reduces each packed bucket within the node, then among the leaders, then
    broadcasts the result back within the node: each bucket crosses the
    slow inter-node link once per node instead of once per rank, and the
    result equals a flat sync over the world (integer and extremal leaves
    bit for bit, float sums to reassociation). Gathered leaves ("cat",
    ``None``, callables) sync over :attr:`flat`, the world, as the JAX
    package lowers per-leaf paths over its flat axis tuple.

    ``new_group`` is itself collective: every rank constructs the same
    hierarchy, in the same order relative to its other groups. The world
    size must be a multiple of ``node_size``.
    """

    __slots__ = ("node_size", "nodes", "levels", "leader", "_intra_groups", "_inter")

    def __init__(self, node_size: int) -> None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("Hierarchy needs an initialised torch.distributed process group")
        world = dist.get_world_size()
        node_size = int(node_size)
        if node_size < 1 or world % node_size:
            raise ValueError(f"node_size must divide the world size {world}, got {node_size}")
        rank = dist.get_rank()
        self.node_size = node_size
        self.nodes = world // node_size
        # every rank builds every group, in one order (new_group is collective)
        self._intra_groups = [
            dist.new_group(ranks=list(range(n * node_size, (n + 1) * node_size))) for n in range(self.nodes)
        ]
        self._inter = dist.new_group(ranks=[n * node_size for n in range(self.nodes)])
        node = rank // node_size
        #: this rank's node leader (global rank)
        self.leader = node * node_size
        #: ``((label, group), ...)``, innermost first; ``None`` where this
        #: rank is not a member (the inter level of a non-leader)
        self.levels = (("intra", self._intra_groups[node]), ("inter", self._inter if rank == self.leader else None))

    @property
    def flat(self) -> Any:
        """The equivalent flat group: the world."""
        return dist.group.WORLD

    def all_reduce(self, buf: Tensor, op: Any) -> None:
        """``buf`` reduced in place over the world by ``op``, level by level:
        within the node, among the leaders, then a broadcast from the leader."""
        intra, inter = self.levels[0][1], self.levels[1][1]
        dist.all_reduce(buf, op=op, group=intra)
        if inter is not None:
            dist.all_reduce(buf, op=op, group=inter)
        dist.broadcast(buf, src=self.leader, group=intra)

    def __repr__(self) -> str:
        return f"Hierarchy(intra={self.node_size} ranks x inter={self.nodes} nodes)"


def hierarchical_axis(node_size: int) -> Hierarchy:
    """The two-level spec (``metrics_tpu/utilities/distributed.py:245``):
    nodes of ``node_size`` ranks reduced first (``"intra"``), then their
    leaders (``"inter"``), as a :class:`Hierarchy` of process groups. Where
    the JAX package names two mesh axes, the port takes the node size."""
    return Hierarchy(node_size)


#: thread-scoped overrides of the eager gather (see :class:`transport_overrides`)
_EAGER_OVERRIDES = threading.local()


class transport_overrides:
    """Thread-scoped overrides of the eager gather, a re-entrant context
    manager (``metrics_tpu/utilities/distributed.py:257``).

    ``quorum`` narrows the decoded members of every gather this thread
    issues to those ranks (the async engine's ``on_degraded="quorum"``
    hook); it never widens a group. ``transport_label`` renames the rounds
    in the telemetry (the engine's legs count as ``"dcn"``). Overrides nest,
    one instance may be entered again, each exit restores what its entry
    found (per thread), and arguments are checked at construction.
    :func:`current_transport_overrides`/:func:`applied_transport_overrides`
    carry a snapshot onto helper threads.
    """

    def __init__(self, *, quorum: Optional[Sequence[int]] = None, transport_label: Optional[str] = None) -> None:
        self._quorum = sorted({int(i) for i in quorum}) if quorum is not None else None
        self._label = str(transport_label) if transport_label is not None else None
        self._saved = threading.local()

    def __enter__(self) -> "transport_overrides":
        stack = getattr(self._saved, "stack", None)
        if stack is None:
            stack = self._saved.stack = []
        stack.append(current_transport_overrides())
        if self._quorum is not None:
            _EAGER_OVERRIDES.quorum = self._quorum
        if self._label is not None:
            _EAGER_OVERRIDES.transport_label = self._label
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _EAGER_OVERRIDES.quorum, _EAGER_OVERRIDES.transport_label = self._saved.stack.pop()
        return False


def current_transport_overrides() -> Tuple[Optional[List[int]], Optional[str]]:
    """This thread's ``(quorum, transport_label)`` override snapshot."""
    return getattr(_EAGER_OVERRIDES, "quorum", None), getattr(_EAGER_OVERRIDES, "transport_label", None)


@contextmanager
def applied_transport_overrides(snapshot: Tuple[Optional[List[int]], Optional[str]]):
    """Install an override snapshot on this thread for the block (the async
    engine's timeout helper threads inherit the worker's); always restores."""
    prev = current_transport_overrides()
    _EAGER_OVERRIDES.quorum, _EAGER_OVERRIDES.transport_label = snapshot
    try:
        yield
    finally:
        _EAGER_OVERRIDES.quorum, _EAGER_OVERRIDES.transport_label = prev


def _subgroup_channel() -> Optional[Callable]:
    """The registered subgroup channel (``transport/gather.py``), or ``None``."""
    from metrics_tpu_torch.transport.gather import subgroup_allgather

    return subgroup_allgather()


def _consume_subgroup_round(participants: Sequence[int]) -> bool:
    """Advance the subgroup channel's round counter for a round this process
    skips while its peers run it (``distributed.py:728``)."""
    from metrics_tpu_torch.transport.gather import consume_subgroup_round

    return consume_subgroup_round(participants)


def distributed_available() -> bool:
    """True when a process group with more than one process is initialised."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _all_gather(buf: Tensor, group: Optional[Any]) -> Tensor:
    """``buf`` from every process of ``group`` (``None``: the world), stacked
    ``(world, ...)`` in rank order. The protocol's one collective."""
    out = buf.new_empty((dist.get_world_size(group), *buf.shape))
    dist.all_gather(list(out.unbind(0)), buf, group=group)
    return out


def group_label(group: Optional[Any]) -> str:
    """A label of ``group`` that every member process spells alike (the span
    ids' group): ``repr`` of ``None`` or a collection of ranks, as the JAX
    package spells it, and a ``ProcessGroup``'s global ranks, whose ``repr``
    would name an address."""
    if isinstance(group, dist.ProcessGroup):
        return repr(dist.get_process_group_ranks(group))
    return repr(group)


def _exchange_device(group: Optional[Any]) -> torch.device:
    """Where the buffers of a round over ``group`` live: the current CUDA
    device under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _resolve_group(group: Optional[Any], nprocs: int) -> List[int]:
    """The member ranks (slots of the rounds) a ``group`` argument names.

    ``None`` and a ``ProcessGroup`` -> every slot of the rounds; a
    collection of ints -> those global ranks. Raises eagerly when called
    directly; :func:`_gather_all_leaves` defers the raise past its rounds.
    """
    if group is None or isinstance(group, dist.ProcessGroup):
        return list(range(nprocs))
    message = f"group must be None, a torch.distributed ProcessGroup, or a collection of process indices; got {group!r}"
    if isinstance(group, str):
        raise TypeError(message)
    try:
        members = sorted({int(i) for i in group})
    except (TypeError, ValueError):
        raise TypeError(message)
    if not members:
        raise ValueError("group must name at least one process index")
    if members[0] < 0 or members[-1] >= nprocs:
        raise ValueError(f"group {group!r} names process indices outside [0, {nprocs})")
    return members


def _leaf_descriptor(leaf: Tensor) -> Tuple[List[int], Optional[str]]:
    """Descriptor row ``[ndim, d0..d7, dtype_code]`` of one leaf. A leaf the
    protocol cannot align gets an empty ``(0,)`` float32 row and the error,
    raised after the rounds."""
    row = [0] * (_MAX_GATHER_NDIM + 2)
    error = None
    if leaf.ndim > _MAX_GATHER_NDIM:
        error = f"gather_all_tensors supports up to {_MAX_GATHER_NDIM} dims, got {leaf.ndim}"
    elif leaf.dtype not in _GATHER_DTYPES:
        error = f"gather_all_tensors cannot align dtype {_dtype_name(leaf.dtype)} across ranks"
    if error is not None:
        row[0], row[-1] = 1, _GATHER_DTYPES.index(torch.float32)
        return row, error
    row[0] = leaf.ndim
    row[1 : 1 + leaf.ndim] = leaf.shape
    row[-1] = _GATHER_DTYPES.index(leaf.dtype)
    return row, None


def _row_count(row: Sequence[int]) -> int:
    return math.prod(row[1 : 1 + row[0]])  # a 0-d leaf counts one element


def _row_layout(rows: Sequence[Sequence[int]]) -> Tuple[List[int], int]:
    """One process's payload layout from its descriptor rows: each leaf's
    byte offset (16-byte aligned) and the total byte count."""
    offsets, total = [], 0
    for row in rows:
        offsets.append(total)
        nbytes = _row_count(row) * _GATHER_DTYPES[row[-1]].itemsize
        total += -(-nbytes // _PAYLOAD_ALIGN) * _PAYLOAD_ALIGN
    return offsets, total


def _align_leaf(
    leaf_desc: Sequence[Sequence[int]], members: List[int]
) -> Tuple[Dict[int, Tuple[int, ...]], List[int], torch.dtype, Optional[str]]:
    """Alignment of one leaf inside ``members`` from its per-slot descriptor
    rows: ``(shapes, counts, target_dtype, group_error)``.

    Consistency is required over the non-empty members only; an empty
    member becomes 0 rows of its peers' trailing dims (a 0-length vector
    when the peers are 0-d). A violation is returned, not raised: the other
    groups of the same rounds are committed to the payload round.
    """
    ndims = [int(row[0]) for row in leaf_desc]
    counts = [_row_count(row) for row in leaf_desc]
    codes = [int(row[-1]) for row in leaf_desc]

    group_error = None
    nonempty = [i for i in members if counts[i] > 0]
    if nonempty:
        if len({ndims[i] for i in nonempty}) > 1:
            group_error = (
                "gather_all_tensors: group members hold data of different ranks"
                f" (ndims {[ndims[i] for i in members]})"
            )
        elif len({codes[i] for i in nonempty}) > 1:
            group_error = "gather_all_tensors: group members hold data of different dtypes"
        ref_ndim = ndims[nonempty[0]]
        target_dtype = _GATHER_DTYPES[codes[nonempty[0]]]
    else:
        ref_ndim = max(ndims[i] for i in members)
        target_dtype = _GATHER_DTYPES[codes[members[0]]]

    shapes: Dict[int, Tuple[int, ...]] = {}
    for i in members:
        nd = min(ndims[i], ref_ndim)
        shapes[i] = tuple(int(d) for d in leaf_desc[i][1 : 1 + nd]) + (0,) * (ref_ndim - nd)
    if nonempty:
        max_shape = [max(shapes[i][d] for i in nonempty) for d in range(ref_ndim)]
    else:
        max_shape = [1] * ref_ndim
    for i in members:
        if counts[i] == 0:
            shapes[i] = (0, *max_shape[1:]) if ref_ndim > 0 else (0,)
    return shapes, counts, target_dtype, group_error


def _gather_all_leaves(
    leaves: List[Tensor],
    group: Optional[Any],
    *,
    participants: Optional[Sequence[int]] = None,
    label: Optional[str] = None,
) -> List[List[Tensor]]:
    """Every leaf from every member of ``group``, in ONE descriptor round and
    at most ONE payload round: per leaf, the members' tensors in ascending
    rank order, each on the device of the local leaf.

    ``participants`` (a transport's subgroup) narrows the decoded members
    and never widens them. With a subgroup channel registered
    (:func:`metrics_tpu_torch.transport.gather.set_subgroup_allgather`) and
    the rounds over the world, both rounds run among the participants
    alone, so a dead peer outside them is never contacted; without one the
    rounds span the group. A thread's :class:`transport_overrides` quorum
    narrows the decode the same way, and its label names the rounds in the
    telemetry (else ``label``, else ``"gather"``). The fault seams
    ``transport.descriptor`` and ``transport.payload`` are consulted before
    each round.
    """
    observed = TELEMETRY.enabled or EVENTS.enabled
    transport_start = time.perf_counter() if observed else 0.0
    round_group = group if isinstance(group, dist.ProcessGroup) else None
    device = _exchange_device(round_group)
    quorum, override_label = current_transport_overrides()
    transport_label = override_label or label or "gather"
    local_rank = _tracing._process_index()
    # the global ranks of the slots when a subgroup channel carries the rounds
    channel_ranks: Optional[List[int]] = None
    channel = None
    if participants is not None and round_group is None:
        world = world_size()
        want = sorted({int(p) for p in participants if 0 <= int(p) < world})
        if want and want != list(range(world)):
            channel = _subgroup_channel()
            if channel is not None:
                channel_ranks = want

    def exchange(buf: Tensor) -> Tensor:
        if channel_ranks is None:
            return _all_gather(buf, round_group)
        return channel(buf.cpu(), list(channel_ranks)).to(buf.device)

    rows: List[List[int]] = []
    local_error: Optional[str] = None
    for leaf in leaves:
        row, err = _leaf_descriptor(leaf)
        rows.append(row)
        local_error = local_error or err
    desc = torch.tensor(rows, dtype=torch.int64).reshape(len(leaves), _MAX_GATHER_NDIM + 2)
    desc_bytes = desc.numel() * desc.element_size()
    if device.type == "cuda":  # from pinned memory the copy does not wait for the card
        desc = desc.pin_memory().to(device, non_blocking=True)
    # the global rank of each slot of a round over a ProcessGroup handle or
    # a subgroup channel
    slot_ranks = dist.get_process_group_ranks(round_group) if round_group is not None else channel_ranks
    t_span = d_span = None
    if TRACER.enabled:
        if channel_ranks is None:
            span_label = _span_group(group, slot_ranks, participants)
        else:  # the channel's participants, as every one of them labels them
            span_label = ",".join(str(r) for r in channel_ranks)
        t_span = TRACER.begin("gather", group=span_label, bucket="transport")
        d_span = TRACER.begin("gather", group=span_label, bucket="descriptor")
    maybe_fault("transport.descriptor", process=local_rank, leaves=len(leaves))
    desc_start = time.perf_counter() if observed else 0.0
    all_desc = to_host(exchange(desc).cpu())  # the sync's one host read
    desc_dur = time.perf_counter() - desc_start if observed else 0.0
    nprocs = len(all_desc)
    if d_span is not None:
        TRACER.end(d_span, leaves=len(leaves), bytes=desc_bytes)

    arg_error: Optional[Exception] = None
    resolve_over = nprocs if channel_ranks is None else world_size()
    try:
        members = _resolve_group(group, resolve_over)
    except (TypeError, ValueError) as err:
        arg_error, members = err, list(range(resolve_over))
    if channel_ranks is not None:
        # decode in slots: the participants' positions in the channel's rounds
        slot_of = {r: i for i, r in enumerate(channel_ranks)}
        members = [slot_of[m] for m in members if m in slot_of] or list(range(nprocs))
    elif participants is not None:
        wanted = set(participants)
        members = [m for m in members if m in wanted] or members
    if quorum is not None:
        healthy = set(quorum)
        members = [m for m in members if _ranks([m], slot_ranks)[0] in healthy] or members

    aligned = [_align_leaf([all_desc[i][j] for i in range(nprocs)], members) for j in range(len(leaves))]
    group_error = next((a[3] for a in aligned if a[3] is not None), None)
    layouts = [_row_layout(slot_rows) for slot_rows in all_desc]
    max_bytes = max(total for _, total in layouts)

    gathered = None
    payload_dur = 0.0
    if max_bytes:
        buf = torch.zeros(max_bytes, dtype=torch.uint8, device=device)
        offsets, _ = _row_layout(rows)
        for leaf, row, offset in zip(leaves, rows, offsets):
            n = _row_count(row) * _GATHER_DTYPES[row[-1]].itemsize
            if n:  # an unalignable leaf's row is empty: it rides as no bytes
                buf[offset : offset + n].copy_(leaf.reshape(-1).view(torch.uint8))
        # a raise between the two rounds (an injected payload fault) still
        # consumes the subgroup channel's round, which the peers run anyway:
        # a channel whose round counter lags by one desyncs every later round
        try:
            maybe_fault("transport.payload", process=local_rank, bytes=max_bytes)
        except BaseException:
            if channel_ranks is not None:
                _consume_subgroup_round(channel_ranks)
            raise
        p_span = TRACER.begin("gather", group=t_span.group, bucket="payload") if t_span is not None else None
        payload_start = time.perf_counter() if observed else 0.0
        gathered = exchange(buf)
        payload_dur = time.perf_counter() - payload_start if observed else 0.0
        if p_span is not None:
            TRACER.end(p_span, leaves=len(leaves), bytes=nprocs * max_bytes)

    span_id = TRACER.end(t_span, leaves=len(leaves), members=_ranks(members, slot_ranks)) if t_span else None
    if observed:
        _record_gather(
            rows=rows,
            all_desc=all_desc,
            aligned=aligned,
            members=members,
            slot_ranks=slot_ranks,
            desc_bytes=desc_bytes,
            max_bytes=max_bytes,
            error=arg_error is not None or local_error is not None or group_error is not None,
            start=transport_start,
            descriptor_s=desc_dur,
            payload_s=payload_dur,
            span_id=span_id,
            transport=transport_label,
        )

    if arg_error is not None:
        raise arg_error
    if local_error is not None:
        raise ValueError(local_error)
    if group_error is not None:
        raise ValueError(group_error)

    out: List[List[Tensor]] = []
    for j, (leaf, (shapes, counts, target_dtype, _)) in enumerate(zip(leaves, aligned)):
        per_member = []
        for s in members:
            if counts[s] == 0:
                per_member.append(torch.zeros(shapes[s], dtype=target_dtype, device=leaf.device))
                continue
            start = layouts[s][0][j]
            raw = gathered[s, start : start + counts[s] * target_dtype.itemsize]
            per_member.append(raw.view(target_dtype).reshape(shapes[s]).to(leaf.device))
        out.append(per_member)
    return out


def _ranks(slots: Sequence[int], slot_ranks: Optional[List[int]]) -> List[int]:
    """Global ranks of slots of a round (slots are global ranks in a round
    over the world)."""
    return [int(s) for s in slots] if slot_ranks is None else [slot_ranks[s] for s in slots]


def _span_group(group: Optional[Any], slot_ranks: Optional[List[int]], participants: Optional[Sequence[int]]) -> str:
    """The gather spans' group label, ``"0,1"``: the ranks whose state the
    gather decodes, as the JAX package labels them. Worked out before the
    rounds from the arguments alone, so every process labels alike; an
    argument the rounds will reject labels the world."""
    nprocs = len(slot_ranks) if slot_ranks is not None else world_size()
    try:
        members = _resolve_group(group, nprocs)
    except (TypeError, ValueError):
        members = list(range(nprocs))
    if participants is not None:
        members = [m for m in members if m in set(participants)] or members
    return ",".join(str(r) for r in _ranks(members, slot_ranks))


def world_size() -> int:
    """Processes of the default group (1 when none is initialised)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _record_gather(
    *,
    rows: List[List[int]],
    all_desc: List[List[List[int]]],
    aligned: List[Tuple[Any, List[int], torch.dtype, Optional[str]]],
    members: List[int],
    slot_ranks: Optional[List[int]],
    desc_bytes: int,
    max_bytes: int,
    error: bool,
    start: float,
    descriptor_s: float,
    payload_s: float,
    span_id: Optional[str],
    transport: str = "gather",
) -> None:
    """One gather into the registry, the histograms and the event log
    (``metrics_tpu/utilities/distributed.py:860-937``). ``bytes_out``/
    ``bytes_in`` are the leaves' own bytes, this process's and its decoded
    members'; ``transport_bytes`` what both rounds moved across the
    processes. Never raises: telemetry must not break a sync."""
    try:
        nprocs = len(all_desc)
        bytes_out = sum(_row_count(row) * _GATHER_DTYPES[row[-1]].itemsize for row in rows)
        bytes_in = sum(
            counts[s] * _GATHER_DTYPES[all_desc[s][j][-1]].itemsize
            for j, (_, counts, _, _) in enumerate(aligned)
            for s in members
        )
        payload_rounds = 1 if max_bytes else 0
        transport_bytes = nprocs * desc_bytes + payload_rounds * nprocs * max_bytes
        participants = _ranks(range(nprocs), slot_ranks)
        member_ranks = _ranks(members, slot_ranks)
        world = max(world_size(), nprocs)
        dur = time.perf_counter() - start
        if TELEMETRY.enabled:
            observe_sync_round_trip(dur, transport=transport)
            observe_sync_round_trip(descriptor_s, transport=f"{transport}_descriptor")
            if payload_rounds:
                observe_sync_round_trip(payload_s, transport=f"{transport}_payload")
            observe_gather_payload(transport_bytes)
            TELEMETRY.record_gather(
                bytes_out=bytes_out,
                bytes_in=bytes_in,
                transport_bytes=transport_bytes,
                descriptor_rounds=1,
                payload_rounds=payload_rounds,
                world=world,
                members=member_ranks,
                error=error,
                leaves=len(rows),
                descriptor_s=descriptor_s,
                payload_s=payload_s,
                transport=transport,
                participants=participants,
            )
        if EVENTS.enabled:
            from metrics_tpu_torch.observability.tracing import _process_index

            EVENTS.record(
                "sync",
                None,
                dur_s=dur,
                t_start=start,
                transport=transport,
                leaves=len(rows),
                bytes_out=bytes_out,
                bytes_in=bytes_in,
                transport_bytes=transport_bytes,
                descriptor_rounds=1,
                payload_rounds=payload_rounds,
                descriptor_s=round(float(descriptor_s), 9),
                payload_s=round(float(payload_s), 9),
                span_id=span_id,
                process=_process_index(),
                world=world,
                members=member_ranks,
                error=bool(error),
                participants=participants,
            )
    except Exception:  # pragma: no cover - telemetry must never break a sync
        pass


def _tree_leaves(tree: Any, out: List[Any]) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, dict keys sorted (as JAX
    flattens them), so that processes agree on the order whatever the
    insertion order of their dicts."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            _tree_leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _tree_leaves(value, out)
    else:
        out.append(tree)
    return out


def _tree_refill(tree: Any, leaves: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_refill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_refill(v, leaves) for v in tree)
    return next(leaves)


def _gather_pytrees_impl(
    trees: List[Any],
    group: Optional[Any] = None,
    *,
    participants: Optional[Sequence[int]] = None,
    label: Optional[str] = None,
) -> List[Any]:
    """The rounds behind :func:`gather_all_pytrees` when distributed, the
    world-1 identity otherwise."""
    leaves = [torch.as_tensor(leaf) for leaf in _tree_leaves(trees, [])]
    if distributed_available():
        gathered = _gather_all_leaves(leaves, group, participants=participants, label=label)
    else:
        gathered = [[leaf] for leaf in leaves]
    return _tree_refill(list(trees), iter(gathered))


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """``result`` from every member of ``group``, in ascending rank order,
    each restored to its true shape: the per-array form of the protocol,
    through the active transport (``metrics_tpu_torch.transport``).

    A member with no data (a never-updated list state) comes back as 0 rows
    of its peers' trailing dims and dtype; errors are raised after the
    rounds. See the module docstring for ``group``."""
    from metrics_tpu_torch.transport import resolve_transport

    return resolve_transport().gather_array(torch.as_tensor(result), group=group)


def gather_all_pytrees(trees: List[Any], group: Optional[Any] = None) -> List[Any]:
    """Every tensor leaf of ``trees`` (dicts, lists, tuples) in ONE
    descriptor round and ONE payload round, through the active transport.

    Returns one tree per input tree with each leaf replaced by the list of
    the group members' tensors, exactly what mapping
    :func:`gather_all_tensors` over the leaves gives, at two rounds in all.
    The leaf count must agree across processes; shapes, ndims and dtypes may
    differ between groups."""
    from metrics_tpu_torch.transport import resolve_transport

    return resolve_transport().gather_pytrees(trees, group=group)


#: the all_reduce each elementwise reduction joins ("mean" sums, then divides)
_REDUCE_OPS = {"sum": "sum", "mean": "sum", "max": "max", "min": "min"}
#: the collective kind each reduction records, in the JAX package's names
#: (``metrics_tpu/utilities/distributed.py:1091``)
_RECORD_KINDS = {"sum": "psum", "mean": "pmean", "max": "pmax", "min": "pmin"}


def sync_state_packed(
    state: Dict[str, Union[Tensor, List[Tensor]]],
    reductions: Dict[str, Any],
    process_group: Any,
) -> Dict[str, Union[Tensor, List[Tensor]]]:
    """The state synced over ``process_group`` (a ``ProcessGroup``, e.g.
    ``torch.distributed.group.WORLD``) with one collective per bucket.

    The eager counterpart of ``metrics_tpu/utilities/distributed.py:1152``:

    * ``"sum"``/``"mean"``/``"max"``/``"min"`` leaves are flattened and
      concatenated per (reduction, dtype) into ONE ``all_reduce`` (a
      ``"mean"`` leaf sums and is divided by the group's size);
    * ``"cat"`` and ``None`` leaves ride one pair of protocol rounds: a
      ``"cat"`` leaf comes back concatenated in rank order, a ``None`` leaf
      stacked ``(world, ...)``;
    * a callable reduction keeps its own gather and sees the stacked leaf.

    ``process_group`` may be a :class:`Hierarchy`: each bucket's
    ``all_reduce`` then runs level by level (see :meth:`Hierarchy.all_reduce`)
    and the gathers over the world.

    List states are concatenated first; an empty one contributes the
    protocol's placeholder and stays as it was when every member is empty.
    Integer, extremal and gathered leaves equal the gather path
    (:meth:`Metric.sync`) bit for bit, float sums to reassociation.

    Telemetry: one ``in_graph`` span per ``all_reduce`` bucket, labelled
    ``"p<op>/<dtype>"`` (a ``"mean"`` leaf rides ``psum``, where the JAX
    package gives it a ``pmean`` bucket), and one
    ``TELEMETRY.record_in_graph_sync`` per call: states per kind
    (``psum``/``pmean``/``pmax``/``pmin``/``all_gather``, as the JAX
    package counts them), bytes, buckets, and the collectives per leaf
    against those issued (``all_reduce`` calls plus gathers).
    """
    hierarchy = process_group if isinstance(process_group, Hierarchy) else None
    if hierarchy is not None:
        process_group = hierarchy.flat
    if not isinstance(process_group, dist.ProcessGroup):
        raise TypeError(
            "sync_state_packed reduces over a torch.distributed ProcessGroup (e.g."
            f" torch.distributed.group.WORLD) or a Hierarchy; got {process_group!r}"
        )
    device = _exchange_device(process_group)
    # where an empty list state's placeholder lives: beside the other states
    home = next((t.device for v in state.values() for t in (v if isinstance(v, list) else [v])), device)
    synced: Dict[str, Union[Tensor, List[Tensor]]] = {}
    buckets: Dict[Tuple[str, torch.dtype], List[Tuple[str, Tensor]]] = {}
    gathers: List[Tuple[str, Tensor, Any]] = []
    callables: List[Tuple[str, Tensor, Callable]] = []
    kinds: Dict[str, int] = {}
    gather_labels: Dict[str, int] = {}
    bytes_traced = 0
    for name, value in state.items():
        fx = reductions.get(name)
        if isinstance(value, list):
            fx = "cat" if fx is None else fx
            if not value:
                if fx != "cat":
                    synced[name] = value
                    continue
                value = torch.zeros((0,), dtype=torch.float32, device=home)
            else:
                value = torch.cat([torch.atleast_1d(v) for v in value])
                bytes_traced += value.numel() * value.element_size()
        else:
            bytes_traced += value.numel() * value.element_size()
        kind = _RECORD_KINDS.get(fx, "all_gather") if not callable(fx) else "all_gather"
        if not (isinstance(state[name], list) and not state[name]):  # the JAX package skips empty lists
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind == "all_gather":
                label = f"all_gather/{_dtype_name(value.dtype)}"
                gather_labels[label] = gather_labels.get(label, 0) + 1
        if callable(fx):
            callables.append((name, value, fx))
        elif fx in _REDUCE_OPS:
            buckets.setdefault((_REDUCE_OPS[fx], value.dtype), []).append((name, value))
        elif fx in ("cat", None):
            gathers.append((name, value, fx))
        else:
            raise ValueError(f"Unknown dist_reduce_fx: {fx!r}")

    world = dist.get_world_size(process_group)
    label = group_label(process_group)
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    for (op, dtype), entries in buckets.items():
        buf = torch.cat([v.reshape(-1) for _, v in entries]).to(device)
        span = TRACER.begin("in_graph", group=label, bucket=f"p{op}/{_dtype_name(dtype)}") if TRACER.enabled else None
        if hierarchy is not None:
            hierarchy.all_reduce(buf, ops[op])
        else:
            dist.all_reduce(buf, op=ops[op], group=process_group)
        if span is not None:
            TRACER.end(span, leaves=len(entries))
        offset = 0
        for name, value in entries:
            piece = buf[offset : offset + value.numel()].reshape(value.shape).to(value.device)
            offset += value.numel()
            if reductions.get(name) == "mean":
                piece = (piece if piece.is_floating_point() else piece.float()) / world
            synced[name] = piece

    if gathers:
        members = _gather_all_leaves([v for _, v, _ in gathers], process_group)
        for (name, value, fx), pieces in zip(gathers, members):
            if isinstance(state[name], list):
                filled = [p for p in pieces if p.numel() > 0]
                synced[name] = [torch.cat(filled)] if filled else state[name]
            elif fx == "cat":
                synced[name] = torch.cat([torch.atleast_1d(p) for p in pieces])
            else:
                synced[name] = torch.stack(pieces)
    for name, value, fx in callables:
        synced[name] = fx(torch.stack(_gather_all_leaves([value], process_group)[0]))
    if kinds and TELEMETRY.enabled:
        bucket_compo = {f"p{op}/{_dtype_name(dtype)}": len(entries) for (op, dtype), entries in buckets.items()}
        TELEMETRY.record_in_graph_sync(
            label,
            kinds,
            bytes_traced,
            buckets={**bucket_compo, **gather_labels},
            collectives_before=sum(kinds.values()),
            collectives_after=len(buckets) + (1 if gathers else 0) + len(callables),
        )
    return {name: synced[name] for name in state}
