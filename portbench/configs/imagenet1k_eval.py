"""The ``imagenet1k_eval`` configuration: one validation epoch's batches,
made on the card from the seed, and the program's nine-member collection.

``num_samples`` rows in batches of ``batch_size`` (the last one shorter):
softmax rows of standard normal logits with ``true_class_margin`` added to
the true class's logit, and int64 targets uniform over the classes. Each
epoch ends as a validation loop ends it: ``compute()``, every value copied
to the host, then ``reset()``.
"""


def inputs(torch, cfg, seed, device):
    """The epoch's batches ``[(preds, target), ...]`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, c, b = cfg["num_samples"], cfg["num_classes"], cfg["batch_size"]
    target = torch.randint(0, c, (n,), generator=gen, device=device)
    logits = torch.randn((n, c), generator=gen, device=device)
    logits[torch.arange(n, device=device), target] += cfg["assumed"]["true_class_margin"]
    preds = torch.softmax(logits, dim=1)
    return [(preds[i:i + b], target[i:i + b]) for i in range(0, n, b)]


def build(M, cfg, device):
    """The collection of ``chip_smoke.py::build_collection`` at ``num_classes``."""
    c = cfg["num_classes"]
    macro = dict(average=cfg["average"], num_classes=c, device=device)
    return M.MetricCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(**macro),
        "Recall": M.Recall(**macro),
        "F1": M.F1(**macro),
        "Specificity": M.Specificity(**macro),
        "ConfusionMatrix": M.ConfusionMatrix(num_classes=c, device=device),
        "IoU": M.IoU(num_classes=c, device=device),
        "CohenKappa": M.CohenKappa(num_classes=c, device=device),
        "MatthewsCorrcoef": M.MatthewsCorrcoef(num_classes=c, device=device),
    })


def update(collection, batch):
    collection.update(*batch)


def end_epoch(collection):
    """``compute()``, each member's value copied to the host, then ``reset()``."""
    values = {k: v.cpu() for k, v in collection.compute().items()}
    collection.reset()
    return values


def reset(collection):
    collection.reset()


def rows(batch):
    return int(batch[0].shape[0])


def update_bytes(batch):
    """Bytes of the inputs handed to one update, each read once."""
    return sum(t.numel() * t.element_size() for t in batch)


def end_state(collection):
    """The ``ConfusionMatrix`` member's counts on the host (after an epoch's
    ``reset()``, all zero)."""
    return collection["ConfusionMatrix"].confmat.cpu()
