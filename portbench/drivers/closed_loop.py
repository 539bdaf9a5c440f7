"""Closed loop with one caller: epochs (or passes) of eager updates, each
ended by ``compute()`` with its values copied to the host.

Set-up makes the cell's inputs on the card from the seed, builds the
program's object, and runs one epoch, which warms every shape the window
uses, then resets it. The window runs whole epochs until ``--seconds`` have
passed: each epoch is one update a batch, then ``compute()`` to the host;
the state accumulates over the window. ``rows_per_s`` is every real row
updated over the window's length, taken after the card has finished.

A traced run profiles ``profile_epochs`` more epochs once the window has
closed, with the benchmark's spans on but not counted (the profiler slows
the host), so the spans and counters read over the window are the
untraced program's plus the program's own telemetry.

Once the window has closed, the peak memory has been read and the program's
object is freed, the configuration's reference judges every epoch's values and the end
state.
"""
import time

from portbench import common


def run(cell, seed, seconds, trace, t_start, device="cuda"):
    import torch

    import metrics_tpu_torch as M
    from metrics_tpu_torch import observability

    observability.enable(trace)
    if not trace:
        observability.disable()
    builder, reference = cell.builder(), cell.reference()
    cfg, traffic = cell.cfg, cell.traffic
    on_card = device == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    batches = builder.inputs(torch, cfg, seed, dev)
    program = builder.build(M, cfg, dev)
    epoch_rows = sum(builder.rows(b) for b in batches)
    epoch_bytes = [builder.update_bytes(b) for b in batches]

    # set-up: one epoch warms every shape the window runs
    warm = time.perf_counter()
    for b in batches:
        builder.update(program, b)
    builder.end_epoch(program)
    builder.reset(program)
    sync()
    warm_epoch_s = time.perf_counter() - warm
    common.quiet_host()
    spans = common.Spans(trace)
    prof = common.Profiled(trace, [dev] if on_card else [])
    prof.prime()
    profile_epochs = int(traffic.get("profile_epochs", 1))
    kept = []
    epochs = 0
    record = common.RunRecord(cell)
    record.end_to_end["setup_s"] = time.time() - t_start

    def epoch():
        for b in batches:
            with spans.span("update"):
                builder.update(program, b)
        with spans.span("compute"):
            values = builder.end_epoch(program)
        kept.append(values)

    t0 = time.perf_counter()
    epoch_ends = []
    while time.perf_counter() - t0 < seconds:
        epoch()
        epochs += 1
        epoch_ends.append(time.perf_counter())
    updates = epochs * len(batches)
    sync()
    window_s = time.perf_counter() - t0
    if trace:
        # the profiled epochs follow the window, so that the profiler's cost
        # falls on none of the spans read over the window
        spans.counting = False
        prof.start()
        for _ in range(profile_epochs):
            epoch()
        prof.stop()
        prof.finish()

    record.end_to_end["rows_per_s"] = epoch_rows * epochs / window_s
    record.attempted, record.failed = updates, 0
    record.device = (common.device_record(torch, 1, [prof.data] if prof.data else None) if on_card else
                     {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    record.spans = spans.seconds
    record.traces = [prof.data] if prof.data else []
    record.extras["bytes_per_update"] = sum(epoch_bytes) / len(epoch_bytes)
    record.extras["launches"] = prof.launches
    if prof.data is not None:
        record.extras["breakdown"] = common.breakdown(prof.data)
        record.notes.append(f"portbench: trace sub-window {prof.data.window_us / 1e6:.3f} s, update spans "
                            f"{len(prof.data.span_device_us.get('update', []))}, device records under them "
                            f"{prof.data.span_records.get('update', 0)}, {len(prof.data.device_ops)} device records, "
                            f"{prof.data.port_records} of the program's kernels against its launches {prof.launches}")
    record.notes.append(f"portbench: {epochs} epochs of {len(batches)} updates in {window_s:.3f} s "
                        f"({common.spread_note(epoch_ends, t0)}); warm epoch {warm_epoch_s:.3f} s; "
                        f"{common.card_line() if on_card else 'cpu'}")

    # the check, once the window has closed, the peak has been read and the program is freed
    end_state = builder.end_state(program)
    del program
    if on_card:
        torch.cuda.empty_cache()
    record.checks = reference.judge(torch, cfg, batches, kept, end_state, len(kept))
    return record
