"""Plain reference of ``imagenet1k_eval``: the confusion matrix of one epoch
counted in int64 on the host, and the nine members' values from it in
float64.

It imports numpy and torch alone, and nothing of the program. A row's
predicted class is the first largest of its scores, worked out in ``dtype``
on the device the rows lie on; the ``(C, C)`` matrix (rows the target, columns
the prediction) is counted on the host with ``np.bincount``; the values
follow from the matrix in ``dtype`` (``float64`` the reference, ``bfloat16``
the control). The definitions are those of the JAX package the port follows:

* ``Accuracy``: the rows right over the rows, the trace over the sum;
* macro ``Precision``, ``Recall``, ``F1``, ``Specificity``: the plain mean
  over all C classes of ``tp / (tp + fp)``, ``tp / (tp + fn)``,
  ``2 p r / (p + r)`` and ``tn / (tn + fp)``, each 0 where its denominator
  is 0; a class absent from both the predictions and the targets is not
  left out of the mean: it scores 0 in the first three and 1 in
  ``Specificity`` (``_reduce_stat_scores``' ``zero_division`` 0);
* ``ConfusionMatrix``: the counts, unnormalized;
* ``IoU``: the mean over all C classes of ``diag / (row + column - diag)``,
  ``absent_score`` 0 where that union is 0;
* ``CohenKappa`` (no weights): ``1 - sum(w * M) / sum(w * E)``, ``w`` one off
  the diagonal and zero on it, ``E`` the outer product of the row and column
  sums over the total;
* ``MatthewsCorrcoef``: ``(c s - sum(t p)) / (sqrt(s^2 - sum(p^2))
  sqrt(s^2 - sum(t^2)))``, ``t`` and ``p`` the row and column sums, ``c`` the
  trace, ``s`` the total.

Departures: the JAX package and the port compute the values in float32; the
reference computes them in float64, so the program's values differ from it
by float32 rounding alone (the limit on ``values_gap`` below). The matrix is
counted with ``np.bincount`` over ``target * C + pred``, not by a kernel.
"""
import numpy as np

#: ``values_gap``: the widest gap of the eight members' values (each lies in
#: [-1, 1]) from the float64 reference; float32 rounding of sums over 50,000
#: rows and 1,000 classes reads about 1e-7 (PERF.md), the bfloat16 control
#: above 1e-3, so 1e-5 lies between with room on both sides.
#: ``state_off``: the cells of every kept epoch's ``ConfusionMatrix`` that
#: differ from the reference's counts, and of the matrix left after the
#: window's last ``reset()`` that are not zero: counts are integers, so the
#: limit is exact.
LIMITS = {"values_gap": 1e-5, "state_off": 0}
VALUES = ("Accuracy", "Precision", "Recall", "F1", "Specificity", "IoU", "CohenKappa", "MatthewsCorrcoef")


def _exact(torch):
    """No TF32 in a float32 matrix product on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def predicted(torch, preds, dtype, block=1 << 16):
    """Each row's predicted class, the first largest score in ``dtype``, as
    an int64 host array (``preds`` a tensor)."""
    return np.concatenate([preds[i:i + block].to(dtype).argmax(dim=1).cpu().numpy()
                           for i in range(0, preds.shape[0], block)])


def confmat(pred, target, num_classes):
    """The ``(C, C)`` int64 counts, rows the target, columns the prediction."""
    pred, target = (np.asarray(a).astype(np.int64) for a in (pred, target))
    flat = np.bincount(target * num_classes + pred, minlength=num_classes * num_classes)
    return flat.reshape(num_classes, num_classes)


def _safe(torch, num, den):
    return torch.where(den == 0, torch.zeros_like(num), num / torch.where(den == 0, torch.ones_like(den), den))


def values(torch, cm, dtype):
    """The eight members' values and the matrix, from the int64 counts ``cm``;
    the values in ``dtype``."""
    m = torch.from_numpy(cm).to(dtype)
    rows, cols, diag = m.sum(dim=1), m.sum(dim=0), torch.diagonal(m)
    total = m.sum()
    tp, fp, fn = diag, cols - diag, rows - diag
    tn = total - tp - fp - fn
    precision, recall = _safe(torch, tp, tp + fp), _safe(torch, tp, tp + fn)
    f1 = _safe(torch, 2 * precision * recall, precision + recall)
    expected = rows[:, None] @ cols[None, :] / total
    off = 1 - torch.eye(m.shape[0], dtype=dtype)
    kappa = 1 - (off * m).sum() / (off * expected).sum()
    mcc = (diag.sum() * total - (rows * cols).sum()) / (
        torch.sqrt(total ** 2 - (cols * cols).sum()) * torch.sqrt(total ** 2 - (rows * rows).sum()))
    return {
        "Accuracy": _safe(torch, diag.sum(), total),
        "Precision": precision.mean(),
        "Recall": recall.mean(),
        "F1": f1.mean(),
        "Specificity": _safe(torch, tn, tn + fp).mean(),
        "ConfusionMatrix": torch.from_numpy(cm),
        "IoU": _safe(torch, diag, rows + cols - diag).mean(),
        "CohenKappa": kappa,
        "MatthewsCorrcoef": mcc,
    }


def values_gap(torch, got, want):
    """The widest gap over the eight members' values (``inf`` where one is
    missing, of another shape or not finite)."""
    gap = 0.0
    for k in VALUES:
        if k not in got or tuple(got[k].shape) != tuple(want[k].shape):
            return float("inf")
        d = (got[k].to(torch.float64) - want[k].to(torch.float64)).abs()
        if not bool(torch.isfinite(d).all()):
            return float("inf")
        gap = max(gap, float(d.max()))
    return gap


def state_off(got, want):
    """The cells of the matrix ``got`` that differ from ``want`` (all of them
    where ``got`` is missing or of another shape)."""
    if got is None or tuple(got.shape) != want.shape:
        return want.size
    return int((got.numpy().astype(np.int64) != want).sum())


def check(torch, cfg, preds, target, kept, end_state):
    """``{name: (reading, limit)}`` of every kept epoch's values, each of one
    epoch over the rows ``preds`` (a tensor) and ``target`` (a host array),
    and of the matrix ``end_state`` left after the last ``reset()``."""
    _exact(torch)
    c = cfg["num_classes"]
    cm = confmat(predicted(torch, preds, torch.float64), target, c)
    want = values(torch, cm, torch.float64)
    gap = max((values_gap(torch, got, want) for got in kept), default=float("inf"))
    off = sum(state_off(got.get("ConfusionMatrix"), cm) for got in kept) if kept else cm.size
    off += state_off(end_state, np.zeros_like(cm))
    return {"values_gap": (gap, LIMITS["values_gap"]), "state_off": (off, LIMITS["state_off"])}


def control(torch, cfg, preds, target):
    """The reference put in the program's place, computed in bfloat16: one
    epoch's values and the matrix after a ``reset()``."""
    _exact(torch)
    c = cfg["num_classes"]
    cm = confmat(predicted(torch, preds, torch.bfloat16), target, c)
    return values(torch, cm, torch.bfloat16), torch.zeros((c, c), dtype=torch.int64)


def judge(torch, cfg, batches, kept, end_state, times):
    """The closed loop's check: every kept epoch's values against the one
    reference epoch (each epoch ends with ``reset()``, so ``times`` does not
    enter), and the matrix left after the window."""
    preds = torch.cat([b[0] for b in batches])
    target = torch.cat([b[1] for b in batches]).cpu().numpy()
    return check(torch, cfg, preds, target, kept, end_state)
