"""Node-classification oracle (micro/macro-F1) on numpy and scipy.

Counterpart of `graphembedding_tpu/eval/classify.py`, which uses
scikit-learn. The port keeps its semantics without scikit-learn:

- one-vs-rest L2 logistic regression per class, C = 1, with an
  unpenalised intercept, solved by L-BFGS (max_iter 100) on the objective
  scikit-learn's `LogisticRegression(solver='lbfgs')` minimises;
- the top-k rule: each test node predicts its k most probable classes,
  k being its true label count;
- the seeded split: `numpy.random.seed(seed)`, then one permutation.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.special import expit, log_expit


C = 1.0  # inverse L2 strength, scikit-learn's default
MAX_ITER = 100  # L-BFGS iterations, scikit-learn's default


def _fit_binary(X, y):
    """Weights [F+1] (intercept last) of L2 logistic regression.

    Minimises mean log-loss + ||w||^2 / (2 C n), scikit-learn's scaling
    of C * sum(log-loss) + ||w||^2 / 2, with its L-BFGS tolerances.
    """
    n, f = X.shape
    s = 2.0 * y - 1.0  # labels as +-1
    reg = 1.0 / (C * n)

    def fun(wb):
        w, b = wb[:f], wb[f]
        z = s * (X @ w + b)
        loss = -log_expit(z).mean() + 0.5 * reg * (w @ w)
        gz = -s * expit(-z) / n
        grad = np.empty_like(wb)
        grad[:f] = X.T @ gz + reg * w
        grad[f] = gz.sum()
        return loss, grad

    res = minimize(fun, np.zeros(f + 1), jac=True, method="L-BFGS-B",
                   options={"maxiter": MAX_ITER, "maxls": 50, "gtol": 1e-4,
                            "ftol": 64 * np.finfo(float).eps})
    return res.x


class Classifier:
    """One-vs-rest logistic regression with the reference's top-k rule."""

    def __init__(self, embeddings):
        self.embeddings = embeddings
        self.classes_ = None
        self.coef_ = None  # [n_classes, F+1], None rows are constant
        self.const_ = None

    def _features(self, X):
        return np.asarray([self.embeddings[x] for x in X], dtype=np.float64)

    def _binarize(self, Y):
        index = {c: i for i, c in enumerate(self.classes_)}
        out = np.zeros((len(Y), len(self.classes_)), dtype=np.int64)
        for i, labels in enumerate(Y):
            for lab in labels:
                out[i, index[lab]] = 1
        return out

    def train(self, X, Y, Y_all):
        self.classes_ = sorted({lab for labels in Y_all for lab in labels})
        Xf = self._features(X)
        Yb = self._binarize(Y)
        self.coef_ = []
        self.const_ = []
        for c in range(Yb.shape[1]):
            y = Yb[:, c]
            if y.min() == y.max():
                # one value in training: constant probability, as
                # scikit-learn's one-vs-rest does for such a column
                self.coef_.append(None)
                self.const_.append(float(y[0]))
            else:
                self.coef_.append(_fit_binary(Xf, y))
                self.const_.append(None)

    def predict_proba(self, X):
        Xf = self._features(X)
        cols = []
        for wb, const in zip(self.coef_, self.const_):
            if wb is None:
                cols.append(np.full(Xf.shape[0], const))
            else:
                cols.append(expit(Xf @ wb[:-1] + wb[-1]))
        return np.stack(cols, axis=1)

    def predict(self, X, top_k_list):
        probs = self.predict_proba(X)
        out = np.zeros(probs.shape, dtype=np.int64)
        for i, k in enumerate(top_k_list):
            out[i, probs[i].argsort()[-k:]] = 1
        return out

    def evaluate(self, X, Y):
        Y_pred = self.predict(X, [len(labels) for labels in Y])
        Y_true = self._binarize(Y)
        return f1_scores(Y_true, Y_pred)

    def split_train_evaluate(self, X, Y, train_precent, seed=0):
        """Seeded shuffle split (the reference's argument name kept)."""
        state = np.random.get_state()
        training_size = int(train_precent * len(X))
        np.random.seed(seed)
        shuffle_indices = np.random.permutation(np.arange(len(X)))
        X_train = [X[shuffle_indices[i]] for i in range(training_size)]
        Y_train = [Y[shuffle_indices[i]] for i in range(training_size)]
        X_test = [X[shuffle_indices[i]] for i in range(training_size, len(X))]
        Y_test = [Y[shuffle_indices[i]] for i in range(training_size, len(X))]
        self.train(X_train, Y_train, Y)
        np.random.set_state(state)
        return self.evaluate(X_test, Y_test)


def _f1(tp, fp, fn):
    """Elementwise F1 = 2tp / (2tp + fp + fn), 0 where undefined."""
    den = 2 * tp + fp + fn
    return np.where(den > 0, 2 * tp / np.maximum(den, 1), 0.0)


def f1_scores(Y_true, Y_pred):
    """micro / macro / samples / weighted F1 and subset accuracy of two
    binary indicator matrices [n, classes] (zero_division = 0)."""
    t = np.asarray(Y_true).astype(bool)
    p = np.asarray(Y_pred).astype(bool)
    tp_c = (t & p).sum(0)
    fp_c = (~t & p).sum(0)
    fn_c = (t & ~p).sum(0)
    f1_c = _f1(tp_c, fp_c, fn_c)
    support = t.sum(0)
    f1_r = _f1((t & p).sum(1), (~t & p).sum(1), (t & ~p).sum(1))
    return {
        "micro": float(_f1(tp_c.sum(), fp_c.sum(), fn_c.sum())),
        "macro": float(f1_c.mean()),
        "samples": float(f1_r.mean()),
        "weighted": float((f1_c * support).sum() / max(support.sum(), 1)),
        "acc": float((t == p).all(1).mean()),
    }


def read_node_label(filename, skip_head=False):
    """Read `node label [label...]` lines -> (X nodes, Y label-lists)."""
    X, Y = [], []
    with open(filename) as fin:
        if skip_head:
            fin.readline()
        for line in fin:
            vec = line.strip().split()
            if not vec:
                continue
            X.append(vec[0])
            Y.append(vec[1:])
    return X, Y
