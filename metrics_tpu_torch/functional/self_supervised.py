"""Pairwise embedding similarity.

Counterpart of ``metrics_tpu/functional/self_supervised.py``: one
``(B, D) @ (D, B)`` product with optional cosine normalization, a zeroed
diagonal and a row reduction. The JAX package pins ``precision=HIGHEST``
(``self_supervised.py:46``) so that identical embeddings read 1.0; here the
product runs in full float32 on the card, never TF32, whatever
``torch.get_float32_matmul_precision()`` says (:func:`full_fp32`).
"""
import torch

from metrics_tpu_torch.utilities.data import Tensor, full_fp32


def embedding_similarity(
    batch: Tensor,
    similarity: str = "cosine",
    reduction: str = "none",
    zero_diagonal: bool = True,
) -> Tensor:
    """Similarity matrix between every pair of row embeddings.

    Args:
        batch: embeddings of shape ``(batch, dim)``
        similarity: ``'dot'`` or ``'cosine'``
        reduction: ``'none'`` | ``'sum'`` | ``'mean'`` (along the last dim)
        zero_diagonal: if True, self-similarities are set to zero

    Returns:
        a ``(batch, batch)`` matrix (or ``(batch,)`` after reduction)

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import embedding_similarity
        >>> embeddings = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.], [4., 5., 6., 7.]])
        >>> embedding_similarity(embeddings).round(decimals=4)
        tensor([[0.0000, 1.0000, 0.9759],
                [1.0000, 0.0000, 0.9759],
                [0.9759, 0.9759, 0.0000]])
    """
    if similarity == "cosine":
        norm = torch.linalg.vector_norm(batch, ord=2, dim=1)
        batch = batch / norm[:, None]

    with full_fp32(batch.device):
        sqr_mtx = torch.matmul(batch, batch.T)

    if zero_diagonal:
        # out of place, as ``jnp.fill_diagonal(..., inplace=False)``
        eye = torch.eye(sqr_mtx.shape[0], dtype=torch.bool, device=sqr_mtx.device)
        sqr_mtx = torch.where(eye, torch.zeros((), dtype=sqr_mtx.dtype, device=sqr_mtx.device), sqr_mtx)

    if reduction == "mean":
        sqr_mtx = sqr_mtx.mean(dim=-1)
    if reduction == "sum":
        sqr_mtx = sqr_mtx.sum(dim=-1)

    return sqr_mtx
