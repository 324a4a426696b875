"""The literal `LogisticRegression` gradient arithmetic in numpy float64,
shared by the dist workers (which compute every gradient) and the chief
(which augments its data the same way): a copy of `_aug` and `grad` of
`repro.dist.store`. Numpy only: workers import this module and must not pay
for torch."""
from __future__ import annotations

import numpy as np


def _aug(X):
    return np.concatenate([X, np.ones((len(X), 1))], axis=1)


def grad(W, Xa, y):
    """Literal LogisticRegression.grad on pre-augmented rows (float64)."""
    z = Xa @ W
    z = z - z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(y)), y] -= 1.0
    return Xa.T @ p / len(y)
