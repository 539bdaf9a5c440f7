"""The port's BLEU, embedding similarity and image gradients against the JAX package's.

Mirrors ``tests/functional/test_nlp.py`` (BLEU against the JAX package and
NLTK's ``corpus_bleu`` at every order, with and without smoothing, the known
value, no match, a size mismatch, an empty translation),
``tests/functional/test_self_supervised.py`` (every similarity, reduction
and diagonal against the JAX package and sklearn) and the image-gradient
cases of ``tests/image/test_psnr_ssim.py`` (known values, invalid inputs),
each on the same seeded numpy inputs, with ``device="cpu"``. Float32
values agree within ``rtol=1e-6``; the image gradients exactly. Beyond the
JAX tests: a seeded corpus of 300 pairs from a Zipf vocabulary against the
JAX package and a pure-Python float64 oracle, and image gradients of
float64 and integer images.
"""
import math
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from nltk.translate.bleu_score import SmoothingFunction, corpus_bleu
from sklearn.metrics.pairwise import cosine_similarity as sk_cosine
from sklearn.metrics.pairwise import linear_kernel

import metrics_tpu.functional as JF
import metrics_tpu_torch.functional as TF

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-6, atol=1e-6)

HYP1 = "It is a guide to action which ensures that the military always obeys the commands of the party".split()
HYP2 = "he read the book because he was interested in world history".split()
REF1A = "It is a guide to action that ensures that the military will forever heed Party commands".split()
REF1B = "It is a guiding principle which makes the military forces always being under the command of the Party".split()
REF1C = "It is the practical guide for the army always to heed the directions of the party".split()
REF2A = "he was interested in world history because he read the book".split()
TUPLE_OF_REFERENCES = ([REF1A, REF1B, REF1C], [REF2A])
HYPOTHESES = (HYP1, HYP2)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- BLEU -------------------------------------------------------------------------------


@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_vs_jax_and_nltk(n_gram, smooth):
    weights = (1.0 / n_gram,) * n_gram
    nltk_kwargs = {"smoothing_function": SmoothingFunction().method2} if smooth else {}
    nltk_output = corpus_bleu(TUPLE_OF_REFERENCES, HYPOTHESES, weights=weights, **nltk_kwargs)
    got = TF.bleu_score(HYPOTHESES, TUPLE_OF_REFERENCES, n_gram=n_gram, smooth=smooth, **CPU)
    want = JF.bleu_score(HYPOTHESES, TUPLE_OF_REFERENCES, n_gram=n_gram, smooth=smooth)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), nltk_output, atol=1e-4)


def test_bleu_known_value():
    translate_corpus = ["the cat is on the mat".split()]
    reference_corpus = [["there is a cat on the mat".split(), "a cat is on the mat".split()]]
    np.testing.assert_allclose(TF.bleu_score(translate_corpus, reference_corpus, **CPU).numpy(), 0.7598, atol=1e-4)


def test_bleu_no_match_is_zero():
    got = TF.bleu_score(["a b c".split()], [["d e f".split()]], **CPU)
    assert float(got) == float(JF.bleu_score(["a b c".split()], [["d e f".split()]])) == 0.0
    assert got.device.type == "cpu"


def test_bleu_size_mismatch_raises():
    with pytest.raises(ValueError, match="different size"):
        TF.bleu_score(["a b".split()], [["a b".split()], ["c d".split()]], **CPU)


def test_bleu_empty_translation():
    assert float(TF.bleu_score([[]], [["a b".split()]], **CPU)) == 0.0


def _zipf_corpus(seed, pairs=300, vocab=2000):
    """Seeded sentence pairs: references of 5-80 tokens from a Zipf
    vocabulary, hypotheses with 30% of their tokens replaced."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    hyps, refs = [], []
    for _ in range(pairs):
        length = int(np.clip(rng.lognormal(3.2, 0.5), 5, 80))
        ref = [words[min(int(z), vocab) - 1] for z in rng.zipf(1.2, length)]
        hyp = [words[rng.randint(vocab)] if rng.rand() < 0.3 else w for w in ref]
        hyps.append(hyp)
        refs.append([ref])
    return hyps, refs


def _bleu_oracle(hyps, refs, n_gram, smooth):
    """BLEU in Python floats (float64), written from the formula."""
    num, den, c, r = [0] * n_gram, [0] * n_gram, 0, 0
    for hyp, rs in zip(hyps, refs):
        c += len(hyp)
        r += min((abs(len(hyp) - len(x)), len(x)) for x in rs)[1]
        hc = Counter(tuple(hyp[j:j + n]) for n in range(1, n_gram + 1) for j in range(len(hyp) - n + 1))
        rc = Counter()
        for x in rs:
            rc |= Counter(tuple(x[j:j + n]) for n in range(1, n_gram + 1) for j in range(len(x) - n + 1))
        for g, k in (hc & rc).items():
            num[len(g) - 1] += k
        for g, k in hc.items():
            den[len(g) - 1] += k
    if min(num) == 0:
        return 0.0
    prec = [(num[i] + (1 if smooth and i else 0)) / (den[i] + (1 if smooth and i else 0)) for i in range(n_gram)]
    bp = 1.0 if c > r else math.exp(1 - r / c)
    return bp * math.exp(sum(math.log(p) for p in prec) / n_gram)


@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_on_a_seeded_zipf_corpus_matches_jax_and_a_float64_oracle(smooth):
    hyps, refs = _zipf_corpus(4)
    got = TF.bleu_score(hyps, refs, smooth=smooth, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(JF.bleu_score(hyps, refs, smooth=smooth)), **TOL)
    np.testing.assert_allclose(got.numpy(), _bleu_oracle(hyps, refs, 4, smooth), **TOL)


def test_bleu_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.bleu_score(HYPOTHESES, TUPLE_OF_REFERENCES)


# -- embedding similarity --------------------------------------------------------------


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("zero_diagonal", [True, False])
def test_embedding_similarity(similarity, reduction, zero_diagonal):
    batch = np.random.RandomState(3).randn(12, 16).astype(np.float32)
    kw = dict(similarity=similarity, reduction=reduction, zero_diagonal=zero_diagonal)
    got = TF.embedding_similarity(_t(batch), **kw)
    want = JF.embedding_similarity(jnp.asarray(batch), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-6)

    expected = sk_cosine(batch) if similarity == "cosine" else linear_kernel(batch)
    if zero_diagonal:
        np.fill_diagonal(expected, 0)
    if reduction == "mean":
        expected = expected.mean(axis=-1)
    elif reduction == "sum":
        expected = expected.sum(axis=-1)
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-4)


def test_embedding_similarity_reads_identical_rows_as_one_and_leaves_its_input():
    row = np.random.RandomState(5).randn(1, 128).astype(np.float32)
    batch = _t(np.repeat(row, 6, axis=0))
    before = batch.clone()
    got = TF.embedding_similarity(batch, zero_diagonal=False)
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-6)
    assert torch.equal(batch, before)


def test_embedding_similarity_float64_stays_float64():
    batch = np.random.RandomState(6).randn(8, 5)
    got = TF.embedding_similarity(_t(batch))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(JF.embedding_similarity(jnp.asarray(batch))),
                               rtol=1e-12, atol=1e-12)


def test_full_fp32_blocks_overlapping_on_two_threads_keep_tf32_off_and_restore_it_once():
    """Two overlapping ``full_fp32`` blocks on two threads, the first to open
    closing first: TF32 stays off inside both, and the process's own setting
    comes back only when the last closes. The blocks set the process-wide
    flags only, so a CUDA device object needs no card here."""
    import threading

    from metrics_tpu_torch.utilities.data import full_fp32

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    dev = torch.device("cuda", 0)
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    a_open, b_open, a_closed = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def first():
        with full_fp32(dev):
            a_open.set()
            assert b_open.wait(10)
            seen["first"] = flags()
        a_closed.set()

    def second():
        assert a_open.wait(10)
        with full_fp32(dev):
            b_open.set()
            assert a_closed.wait(10)
            seen["second, after the first closed"] = flags()

    try:
        threads = [threading.Thread(target=first), threading.Thread(target=second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen == {"first": (False, False), "second, after the first closed": (False, False)}
        assert flags() == (True, True)
        with full_fp32(dev), full_fp32(dev):
            assert flags() == (False, False)
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- image gradients --------------------------------------------------------------------


def test_image_gradients_known_values():
    dy, dx = TF.image_gradients(torch.arange(25, dtype=torch.float32).reshape(1, 1, 5, 5))
    expected_dy = np.zeros((5, 5), dtype=np.float32)
    expected_dy[:4] = 5.0
    expected_dx = np.zeros((5, 5), dtype=np.float32)
    expected_dx[:, :4] = 1.0
    np.testing.assert_array_equal(dy[0, 0].numpy(), expected_dy)
    np.testing.assert_array_equal(dx[0, 0].numpy(), expected_dx)


def test_image_gradients_invalid():
    with pytest.raises(TypeError):
        TF.image_gradients([[1.0, 2.0]])
    with pytest.raises(TypeError):
        TF.image_gradients(np.zeros((1, 1, 5, 5), np.float32))
    with pytest.raises(RuntimeError, match="4D"):
        TF.image_gradients(torch.zeros((5, 5)))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_image_gradients_match_jax_exactly(dtype):
    rng = np.random.RandomState(8)
    img = (rng.rand(3, 2, 9, 7) * 255).astype(dtype)
    dy, dx = TF.image_gradients(_t(img))
    jdy, jdx = JF.image_gradients(jnp.asarray(img))
    for got, want in ((dy, jdy), (dx, jdx)):
        assert str(got.dtype) == f"torch.{dtype}" and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
