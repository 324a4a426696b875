"""Statistically-matched synthetic analogs of the paper's 9 UCI datasets.

A numpy copy of `repro.data.uci_analogs` (tests/test_torch_spec_copies.py
holds every dataset's arrays equal to the reference's).

The UCI files are not redistributable on this offline image, so each dataset is
generated with the same n_examples, n_features, n_classes and class balance as
the original, with separability/noise calibrated so a sequential-SGD logistic
regression lands near the paper's Table 2/3 accuracy. The paper's *relative*
claims (gSSGD > SSGD, etc.) are what EXPERIMENTS.md validates — see DESIGN.md.

Also implements the paper's preprocessing: statistical IQR outlier filtering
(applied to the 'pima*' and 'liver*' variants, as in Section 5.1).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TabularSpec:
    name: str
    n: int
    d: int
    classes: int
    priors: tuple
    sep: float          # inter-class mean distance (in feature-noise units)
    flip: float         # label flip fraction (irreducible noise)
    outlier_frac: float # fraction of rows with heavy-tailed feature noise
    paper_sgd_acc: float  # Table 3 average SGD accuracy (calibration target)


SPECS = {
    "pima": TabularSpec("pima", 768, 8, 2, (0.65, 0.35), 3.3, 0.10, 0.08, 76.1),
    "breast_cancer_diagnostic": TabularSpec("breast_cancer_diagnostic", 569, 30, 2, (0.63, 0.37), 8.5, 0.01, 0.02, 95.8),
    "haberman": TabularSpec("haberman", 306, 3, 2, (0.74, 0.26), 2.2, 0.13, 0.05, 74.6),
    "liver": TabularSpec("liver", 345, 6, 2, (0.58, 0.42), 2.4, 0.15, 0.10, 64.9),
    "new_thyroid": TabularSpec("new_thyroid", 215, 5, 3, (0.70, 0.16, 0.14), 5.5, 0.02, 0.03, 92.4),
    "cancer": TabularSpec("cancer", 699, 9, 2, (0.66, 0.34), 8.0, 0.01, 0.02, 97.8),
    "phishing": TabularSpec("phishing", 2456, 30, 2, (0.56, 0.44), 8.0, 0.08, 0.04, 82.2),
}

# the paper's 9 rows: two of them are IQR-filtered variants
DATASETS = [
    "pima",
    "pima_filtered",
    "breast_cancer_diagnostic",
    "haberman",
    "liver",
    "liver_filtered",
    "new_thyroid",
    "cancer",
    "phishing",
]


# Conditioning structure shared by all analogs. UCI tabular data is used RAW in
# the paper ("no preprocessing"), i.e. features have wildly different scales.
# That conditioning is what makes the parallel-SGD delay measurable at all:
#   * "stiff" UNINFORMATIVE dims (large scale, no class signal): their optimal
#     weight is 0, but under the parallel effective step eta*c the weights
#     oscillate around 0 with amplitude ~ eta*c -> logit noise -> the smooth,
#     rho-proportional accuracy damage of Figs. 12-13 ("long jump" victims);
#   * "slow" informative dims (small scale): converge slowly at lr 0.2 in the
#     50-epoch budget -> the paper's O(1/(cT)) undertraining term, and what the
#     guided replay's extra verified-consistent updates recover (Fig. 14).
# Values chosen once, globally (not per-dataset): see EXPERIMENTS.md §Paper.
S_STIFF = 3.0
S_SLOW = 0.12


def _generate(spec: TabularSpec, seed: int):
    rng = np.random.default_rng(seed)
    counts = (np.asarray(spec.priors) * spec.n).astype(int)
    counts[0] += spec.n - counts.sum()
    # class-conditional gaussians on a random low-rank structure + noise dims
    informative = max(2, (2 * spec.d) // 3)
    X, y = [], []
    # orthonormal class-mean directions (deterministic geometry: calibration is
    # monotone in `sep`, independent of the seed's random mean placement)
    raw = rng.standard_normal((informative, max(spec.classes, 2)))
    q, _ = np.linalg.qr(raw)
    means = q[:, : spec.classes].T * spec.sep
    for k, nk in enumerate(counts):
        Xi = rng.standard_normal((nk, spec.d))
        Xi[:, :informative] += means[k]
        X.append(Xi)
        y.append(np.full(nk, k))
    X = np.concatenate(X)
    y = np.concatenate(y)
    # heavy-tailed outliers (what the IQR filter is for)
    n_out = int(spec.outlier_frac * spec.n)
    if n_out:
        rows = rng.choice(spec.n, n_out, replace=False)
        X[rows] += rng.standard_t(1.5, size=(n_out, spec.d)) * 4.0
    # label flips (irreducible noise)
    n_flip = int(spec.flip * spec.n)
    if n_flip:
        rows = rng.choice(spec.n, n_flip, replace=False)
        y[rows] = (y[rows] + rng.integers(1, spec.classes, n_flip)) % spec.classes
    # raw-UCI-like heterogeneous conditioning (NO standardization; see above)
    X[:, :informative] *= S_SLOW
    X[:, informative:] *= S_STIFF
    perm = rng.permutation(spec.n)
    X, y = X[perm], y[perm]
    return X.astype(np.float64), y.astype(np.int64)


def iqr_filter(X, y):
    """Statistical inter-quartile-range outlier removal (paper Section 5.1,
    via WEKA's InterquartileRange): drop rows with any feature outside
    [Q1 - 1.5 IQR, Q3 + 1.5 IQR]."""
    q1 = np.percentile(X, 25, axis=0)
    q3 = np.percentile(X, 75, axis=0)
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    keep = np.all((X >= lo) & (X <= hi), axis=1)
    return X[keep], y[keep]


def load_dataset(name: str, seed: int = 0):
    """Returns (X, y, n_classes). '<base>_filtered' applies the IQR filter."""
    base = name.removesuffix("_filtered")
    spec = SPECS[base]
    X, y = _generate(spec, seed=(zlib.crc32(base.encode()) + 7919 * seed) % (2**31))
    if name.endswith("_filtered"):
        X, y = iqr_filter(X, y)
    return X, y, spec.classes


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    """Paper Table 1: training:testing = 80:20 (stratified by class so the
    small minority classes, e.g. new-thyroid's, appear in every test fold)."""
    rng = np.random.default_rng(seed)
    te_idx = []
    for k in np.unique(y):
        rows = np.flatnonzero(y == k)
        rows = rows[rng.permutation(len(rows))]
        te_idx.append(rows[: max(1, int(test_frac * len(rows)))])
    te = np.concatenate(te_idx)
    mask = np.ones(len(X), bool)
    mask[te] = False
    tr = np.flatnonzero(mask)
    tr = tr[rng.permutation(len(tr))]
    return X[tr], y[tr], X[te], y[te]
