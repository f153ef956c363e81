"""The port's Classifier with an estimator, and its TopKRanker, against
graphembedding_tpu's.

`Classifier(embeddings, LogisticRegression())`, the reference examples'
call, takes any estimator with fit/predict_proba in the port, one copy a
class. Given scikit-learn's LogisticRegression on the same embeddings and
split, it must give the JAX package's predictions exactly and its scores
within 1e-12 (the port's F1 sums, `f1_scores`, are its own). The labels
include a class every training node has and one no training node has,
which one-vs-rest fits as constants. `TopKRanker.predict` is pinned
against the JAX TopKRanker's on the same fitted estimators' inputs.
"""

import numpy as np
import pytest
from sklearn.linear_model import LogisticRegression

from graphembedding_tpu.eval import classify as jc
from graphembedding_tpu_torch.eval import classify as tc


def labelled_embeddings(seed, n=150, d=12, classes=4):
    """Embeddings with a class signal, multi-label Y with a label on every
    node ('all') and one on the last node only ('rare')."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    centers = rng.standard_normal((classes, d)) * 1.5
    emb = (centers[y] + rng.standard_normal((n, d))).astype(np.float32)
    X = [f"n{i}" for i in range(n)]
    Y = [[str(c), "all"] + ([str((c + 1) % classes)] if i % 5 == 0 else [])
         for i, c in enumerate(y)]
    Y[-1] = Y[-1] + ["rare"]
    return {x: emb[i] for i, x in enumerate(X)}, X, Y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classifier_with_sklearn_estimator_equals_jax(seed):
    emb, X, Y = labelled_embeddings(seed)
    split = int(0.8 * len(X))
    order = np.random.RandomState(seed).permutation(len(X))
    rare = X.index(X[-1])
    order = np.concatenate([order[order != rare], [rare]])  # rare: a test
    X_tr, Y_tr = [X[i] for i in order[:split]], [Y[i] for i in order[:split]]
    X_te, Y_te = [X[i] for i in order[split:]], [Y[i] for i in order[split:]]

    want = jc.Classifier(emb, LogisticRegression())
    want.train(X_tr, Y_tr, Y)
    got = tc.Classifier(emb, LogisticRegression())
    got.train(X_tr, Y_tr, Y)
    top_k = [len(lab) for lab in Y_te]
    np.testing.assert_array_equal(got.predict(X_te, top_k),
                                  np.asarray(want.predict(X_te, top_k)))
    res_j, res_t = want.evaluate(X_te, Y_te), got.evaluate(X_te, Y_te)
    assert set(res_t) == set(res_j)
    for k in res_j:
        assert abs(res_t[k] - res_j[k]) < 1e-12, (k, res_t[k], res_j[k])
    # split_train_evaluate, the examples' path, on the same split rule
    res_j = jc.Classifier(emb, LogisticRegression()).split_train_evaluate(
        X, Y, 0.8, seed=seed)
    res_t = tc.Classifier(emb, LogisticRegression()).split_train_evaluate(
        X, Y, 0.8, seed=seed)
    for k in res_j:
        assert abs(res_t[k] - res_j[k]) < 1e-12, (k, res_t[k], res_j[k])


def test_topk_ranker_predict_equals_jax():
    emb, X, Y = labelled_embeddings(3)
    feats = np.stack([emb[x] for x in X])
    classes = sorted({lab for labels in Y for lab in labels})
    Yb = np.array([[int(c in labels) for c in classes] for labels in Y])
    top_k = [len(lab) for lab in Y]
    want = jc.TopKRanker(LogisticRegression()).fit(feats, Yb)
    got = tc.TopKRanker(LogisticRegression()).fit(feats, Yb)
    np.testing.assert_array_equal(got.predict_proba(feats),
                                  want.predict_proba(feats))
    np.testing.assert_array_equal(got.predict(feats, top_k),
                                  want.predict(feats, top_k))
    # the port's default estimator under the same rule
    ranked = tc.TopKRanker(tc.LBFGSLogistic()).fit(feats, Yb)
    pred = ranked.predict(feats, top_k)
    assert (pred.sum(1) == top_k).all()
