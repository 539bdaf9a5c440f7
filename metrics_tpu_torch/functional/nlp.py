"""BLEU score for machine-translated text.

Counterpart of ``metrics_tpu/functional/nlp.py``. Tokenized strings are
host data, so the n-gram counting stays host Python with ``Counter``
(``nlp.py:16-23,56-72``); only the precision vector is a tensor, on
``device=``. The early ``0.0`` when an order has no match, the smoothing
that spares order 1 and the brevity penalty's ``c > r`` are the JAX
package's (``nlp.py:75-86``).
"""
import math
from collections import Counter
from typing import List, Sequence, Union

import torch

from metrics_tpu_torch.utilities.data import Tensor, resolve_device


def _count_ngram(ngram_input_list: List[str], n_gram: int) -> Counter:
    """Count every 1..n_gram n-gram occurring in a token list."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_key = tuple(ngram_input_list[j : (i + j)])
            ngram_counter[ngram_key] += 1
    return ngram_counter


def bleu_score(
    translate_corpus: Sequence[str],
    reference_corpus: Sequence[str],
    n_gram: int = 4,
    smooth: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tensor:
    """BLEU score of machine-translated text against one or more references.

    Args:
        translate_corpus: an iterable of tokenized machine-translated sentences
        reference_corpus: an iterable of iterables of tokenized reference sentences
        n_gram: maximum n-gram order (1 to 4)
        smooth: apply Lin et al. 2004 smoothing
        device: where the precision vector and the score live (default
            ``"cuda"``; raises without a card)

    Example:
        >>> from metrics_tpu_torch.functional import bleu_score
        >>> translate_corpus = ['the cat is on the mat'.split()]
        >>> reference_corpus = [['there is a cat on the mat'.split(), 'a cat is on the mat'.split()]]
        >>> print(f"{bleu_score(translate_corpus, reference_corpus, device='cpu'):.4f}")
        0.7598
    """
    device = resolve_device(device)
    if len(translate_corpus) != len(reference_corpus):
        raise ValueError(f"Corpus has different size {len(translate_corpus)} != {len(reference_corpus)}")

    numerator = [0.0] * n_gram
    denominator = [0.0] * n_gram
    c = 0.0  # candidate length
    r = 0.0  # effective reference length (closest-length match)

    for translation, references in zip(translate_corpus, reference_corpus):
        c += len(translation)
        ref_len_list = [len(ref) for ref in references]
        ref_len_diff = [abs(len(translation) - x) for x in ref_len_list]
        r += ref_len_list[ref_len_diff.index(min(ref_len_diff))]

        translation_counter = _count_ngram(list(translation), n_gram)
        reference_counter: Counter = Counter()
        for ref in references:
            reference_counter |= _count_ngram(list(ref), n_gram)

        ngram_counter_clip = translation_counter & reference_counter
        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in translation_counter:
            denominator[len(counter) - 1] += translation_counter[counter]

    if min(numerator) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=device)

    # one copy of both vectors to the device
    numerator_arr, denominator_arr = torch.tensor([numerator, denominator], dtype=torch.float32, device=device)
    if smooth:
        precision_scores = (numerator_arr + 1.0) / (denominator_arr + 1.0)
        precision_scores[0] = numerator_arr[0] / denominator_arr[0]
    else:
        precision_scores = numerator_arr / denominator_arr

    log_precision_scores = (1.0 / n_gram) * torch.log(precision_scores)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    brevity_penalty = 1.0 if c > r else math.exp(1 - r / c)
    return brevity_penalty * geometric_mean
