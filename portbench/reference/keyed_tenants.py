"""Plain reference of ``keyed_tenants``: per-tenant counts and values in
float64 from the same tenant ids, predictions and targets the program was
handed.

It imports numpy and torch alone, and nothing of the program. A row's
predicted class is the first largest of its scores, worked out in ``dtype``
on the device the rows lie on; rows with a tenant id below 0 are padding and
count nowhere; the per-tenant, per-class counts are added up on the host
with ``np.add.at``; the values follow from the counts in ``dtype``
(``float64`` the reference, ``bfloat16`` the control).

The program keeps two state bundles a tenant: Accuracy's (one count a
tenant: ``tp`` the rows right, ``fp`` and ``fn`` the rows wrong, ``tn`` the
other classes' true negatives) and the macro members' (one count a tenant
and class). :func:`compare` matches a bundle to its reference by its shape.
"""
import numpy as np

#: the numbers compared and their limits, set from the readings in PERF.md:
#: ``values_gap``, the widest gap of a tenant's value (all lie in [0, 1]);
#: ``state_off``, the count cells of the keyed state that differ (exact)
LIMITS = {"values_gap": 1e-5, "state_off": 0}
MEMBERS = ("Accuracy", "Precision", "Recall", "F1")


def predicted(torch, preds, dtype, block=1 << 20):
    """Each row's predicted class, as an int64 host array (``preds`` a tensor)."""
    return np.concatenate([preds[i:i + block].to(dtype).argmax(dim=1).cpu().numpy()
                           for i in range(0, preds.shape[0], block)])


def counts(ids, pred, target, num_tenants, num_classes):
    """``{"tp", "fp", "fn", "tn": (T, C) int64, "n": (T,)}`` from host arrays."""
    ids, pred, target = (np.asarray(a).astype(np.int64) for a in (ids, pred, target))
    keep = ids >= 0
    ids, pred, target = ids[keep], pred[keep], target[keep]
    hit = pred == target
    tp = np.zeros((num_tenants, num_classes), np.int64)
    fp, fn = tp.copy(), tp.copy()
    np.add.at(tp, (ids[hit], target[hit]), 1)
    np.add.at(fp, (ids[~hit], pred[~hit]), 1)
    np.add.at(fn, (ids[~hit], target[~hit]), 1)
    n = np.zeros(num_tenants, np.int64)
    np.add.at(n, ids, 1)
    return {"tp": tp, "fp": fp, "fn": fn, "tn": n[:, None] - tp - fp - fn, "n": n}


def _safe(torch, num, den):
    return torch.where(den == 0, torch.zeros_like(num), num / torch.where(den == 0, torch.ones_like(den), den))


def values(torch, cnt, dtype):
    """Each member's per-tenant values, in ``dtype``."""
    tp, fp, fn = (torch.from_numpy(cnt[k]).to(dtype) for k in ("tp", "fp", "fn"))
    right = tp.sum(dim=1)
    wrong = fn.sum(dim=1)
    precision, recall = _safe(torch, tp, tp + fp), _safe(torch, tp, tp + fn)
    pr = precision + recall
    f1 = torch.where(pr == 0, torch.zeros_like(pr), 2 * precision * recall / torch.where(pr == 0, torch.ones_like(pr), pr))
    return {
        "Accuracy": _safe(torch, right, right + wrong),
        "Precision": precision.mean(dim=1),
        "Recall": recall.mean(dim=1),
        "F1": f1.mean(dim=1),
    }


def state(cnt, num_classes, times=1):
    """The two bundles' counts as the program keeps them, ``times`` over."""
    right, wrong = cnt["tp"].sum(axis=1), cnt["fn"].sum(axis=1)
    micro = {"tp": right, "fp": wrong, "fn": wrong, "tn": (num_classes - 1) * cnt["n"] - wrong}
    macro = {k: cnt[k] for k in ("tp", "fp", "fn", "tn")}
    return {k: v * times for k, v in micro.items()}, {k: v * times for k, v in macro.items()}


def values_gap(torch, got, want):
    """The widest gap over members and tenants (``inf`` where one is missing or not finite)."""
    gap = 0.0
    for k in MEMBERS:
        if k not in got or tuple(got[k].shape) != tuple(want[k].shape):
            return float("inf")
        d = (got[k].to(torch.float64) - want[k].to(torch.float64)).abs()
        if not bool(torch.isfinite(d).all()):
            return float("inf")
        gap = max(gap, float(d.max()))
    return gap


def state_off(got_state, want_micro, want_macro):
    """The count cells that differ, over both bundles (a missing bundle or leaf counts whole)."""
    off, seen = 0, set()
    for leaves in got_state.values():
        want = want_micro if leaves["tp"].dim() == 1 else want_macro
        seen.add(id(want))
        for k in ("tp", "fp", "fn", "tn"):
            g = leaves[k].numpy().astype(np.int64)
            off += int((g != want[k]).sum()) if g.shape == want[k].shape else want[k].size
    for want in (want_micro, want_macro):
        if id(want) not in seen:
            off += sum(v.size for v in want.values())
    return off


def check(torch, cfg, ids, preds, target, kept, got_state, times):
    """``{name: (reading, limit)}`` of the program's kept per-tenant values
    and end state against the reference over the rows ``ids``, ``preds``
    (a tensor), ``target``, each folded in ``times`` times."""
    t, c = cfg["num_tenants"], cfg["num_classes"]
    cnt = counts(ids, predicted(torch, preds, torch.float64), target, t, c)
    want = values(torch, cnt, torch.float64)
    gap = max((values_gap(torch, got, want) for got in kept), default=float("inf"))
    off = state_off(got_state, *state(cnt, c, times))
    return {"values_gap": (gap, LIMITS["values_gap"]), "state_off": (off, LIMITS["state_off"])}


def control(torch, cfg, ids, preds, target, times):
    """The reference put in the program's place, computed in bfloat16: its
    per-tenant values and end state in the program's layout."""
    t, c = cfg["num_tenants"], cfg["num_classes"]
    cnt = counts(ids, predicted(torch, preds, torch.bfloat16), target, t, c)
    micro, macro = state(cnt, c, times)
    got_state = {"micro": {k: torch.from_numpy(v) for k, v in micro.items()},
                 "macro": {k: torch.from_numpy(v) for k, v in macro.items()}}
    return values(torch, cnt, torch.bfloat16), got_state


def judge(torch, cfg, batches, kept, end_state, times):
    """The closed loop's check: every kept pass's values, and the end state
    after ``times`` passes over the cohorts."""
    ids = torch.cat([b[0] for b in batches]).cpu().numpy()
    preds = torch.cat([b[1] for b in batches])
    target = torch.cat([b[2] for b in batches]).cpu().numpy()
    return check(torch, cfg, ids, preds, target, kept, end_state, times)
