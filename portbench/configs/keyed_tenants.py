"""The ``keyed_tenants`` configuration: its cohorts, made on the card from
the seed, and the program's keyed collection.

``cohorts`` batches of ``cohort_rows`` rows, the last with
``last_cohort_real_rows`` real rows and the rest padding (id -1, zero rows,
target 0).
"""


def _rows(torch, cfg, gen, n, device):
    ids = torch.randint(0, cfg["num_tenants"], (n,), generator=gen, device=device)
    target = torch.randint(0, cfg["num_classes"], (n,), generator=gen, device=device)
    logits = torch.randn((n, cfg["num_classes"]), generator=gen, device=device)
    logits[torch.arange(n, device=device), target] += cfg["assumed"]["true_class_margin"]
    return ids, torch.softmax(logits, dim=1), target


def inputs(torch, cfg, seed, device):
    """The cohorts ``[(ids, preds, target), ...]`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    r, k = cfg["cohort_rows"], cfg["cohorts"]
    ids, preds, target = _rows(torch, cfg, gen, r * k, device)
    last = (k - 1) * r + cfg["last_cohort_real_rows"]
    ids[last:] = -1
    preds[last:] = 0.0
    target[last:] = 0
    return [(ids[i:i + r], preds[i:i + r], target[i:i + r]) for i in range(0, r * k, r)]


def build(M, cfg, device):
    kw = dict(average=cfg["average"], num_classes=cfg["num_classes"], device=device)
    return M.MultiTenantCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(**kw),
        "Recall": M.Recall(**kw),
        "F1": M.F1(**kw),
    }, num_tenants=cfg["num_tenants"], validate_ids=cfg["validate_ids"], device=device)


def update(keyed, batch):
    keyed.update(*batch)


def end_epoch(keyed):
    """``compute()`` of every tenant, each member's values copied to the host."""
    return {k: v.cpu() for k, v in keyed.compute().items()}


def reset(keyed):
    keyed.reset()


def rows(batch):
    return int((batch[0] >= 0).sum())


def update_bytes(batch):
    """Bytes of the inputs handed to one update, each read once."""
    return sum(t.numel() * t.element_size() for t in batch)


def end_state(keyed):
    """The keyed count leaves of each state bundle, on the host:
    ``{bundle: {leaf: tensor}}`` for ``tp``, ``fp``, ``tn``, ``fn``."""
    return {name: {k: v.cpu() for k, v in km._get_states().items() if k in ("tp", "fp", "tn", "fn")}
            for name, km in keyed._keyed.items()}
