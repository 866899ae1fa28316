"""Math helpers (reference core/util/MathUtils.java, 1,291 LoC — the
used-by-something subset, vectorized over numpy instead of per-element
Java loops). Information-theory helpers (entropy/information/idf/tfidf)
feed the NLP stack; the regression/statistics helpers feed evaluation.

Host code: the port's own copy of the JAX package's
`utils/math_utils.py`, the same behaviour line for line.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

SMALL = 1e-6
LOG2 = math.log(2)


# ------------------------------------------------------------- scalar utils
def normalize(val: float, min_: float, max_: float) -> float:
    """Squash val in [min, max] to [0, 1] (MathUtils.normalize :52)."""
    if max_ < min_:
        raise ValueError("max must be >= min")
    if max_ == min_:
        return 0.0
    return (val - min_) / (max_ - min_)


def clamp(value: int, min_: int, max_: int) -> int:
    return max(min_, min(value, max_))


def discretize(value: float, min_: float, max_: float, bin_count: int) -> int:
    """Bin index of value in [min, max] split into bin_count bins (:80)."""
    if bin_count <= 0:
        raise ValueError("bin_count must be positive")
    return int(clamp(int(normalize(value, min_, max_) * bin_count),
                     0, bin_count - 1))


def next_pow_2(v: int) -> int:
    """Smallest power of two >= v (MathUtils.nextPowOf2 :91)."""
    if v <= 0:
        return 1
    return 1 << (int(v) - 1).bit_length()


def binomial(rng: np.random.RandomState, n: int, p: float) -> int:
    return int(rng.binomial(n, p))


def uniform(rng: np.random.RandomState, min_: float, max_: float) -> float:
    return float(rng.uniform(min_, max_))


def sigmoid(x: float) -> float:
    return float(1.0 / (1.0 + np.exp(-np.asarray(x, np.float64))))


def kronecker_delta(i: float, j: float) -> int:
    return 1 if i == j else 0


def factorial(n: float) -> float:
    return float(math.factorial(int(n)))


def permutation(n: float, r: float) -> float:
    return factorial(n) / factorial(n - r)


def combination(n: float, r: float) -> float:
    return factorial(n) / (factorial(r) * factorial(n - r))


def hypotenuse(a: float, b: float) -> float:
    return math.hypot(a, b)


def prob_to_log_odds(prob: float) -> float:
    if prob <= 0 or prob >= 1:
        raise ValueError("probability must be in (0, 1)")
    return math.log(prob / (1 - prob))


def prob_round(value: float, rng: np.random.RandomState) -> int:
    """Stochastic rounding: round up with prob = fractional part (:982)."""
    base = math.floor(value)
    return int(base + (1 if rng.rand() < value - base else 0))


def round_double(value: float, after_decimal_point: int) -> float:
    return round(value, after_decimal_point)


# --------------------------------------------------------------- vector ops
def vector_length(vector: Sequence[float]) -> float:
    """Squared euclidean norm — the reference returns sum of squares
    (MathUtils.vectorLength :235)."""
    v = np.asarray(vector, np.float64)
    return float(np.sum(v * v))


def sum_of_squares(vector: Sequence[float]) -> float:
    return float(np.sum(np.square(np.asarray(vector, np.float64))))


def sum_(nums: Sequence[float]) -> float:
    return float(np.sum(np.asarray(nums, np.float64)))


def times(nums: Sequence[float]) -> float:
    return float(np.prod(np.asarray(nums, np.float64)))


def sum_of_products(*nums: Sequence[float]) -> float:
    arrs = np.asarray(nums, np.float64)
    return float(np.sum(np.prod(arrs, axis=0)))


def variance(vector: Sequence[float]) -> float:
    """Sum of squared mean deviations / (n - 1) (:488)."""
    v = np.asarray(vector, np.float64)
    if v.size < 2:
        return 0.0
    return float(np.sum((v - v.mean()) ** 2) / (v.size - 1))


def min_(doubles: Sequence[float]) -> float:
    return float(np.min(np.asarray(doubles, np.float64)))


def max_(doubles: Sequence[float]) -> float:
    return float(np.max(np.asarray(doubles, np.float64)))


def max_index(doubles: Sequence[float]) -> int:
    return int(np.argmax(np.asarray(doubles, np.float64)))


def normalize_to_one(doubles: Sequence[float]) -> np.ndarray:
    v = np.asarray(doubles, np.float64)
    return v / v.sum()


def logs2probs(a: Sequence[float]) -> np.ndarray:
    """exp(a - max) renormalized (MathUtils.logs2probs :827)."""
    v = np.asarray(a, np.float64)
    p = np.exp(v - v.max())
    return p / p.sum()


# ------------------------------------------------------- information theory
def log2(a: float) -> float:
    return math.log(a) / LOG2


def entropy(vector: Sequence[float]) -> float:
    """Shannon entropy in nats of an (unnormalized) count vector — the
    reference sums -x*log(x) directly (MathUtils.entropy :740)."""
    v = np.asarray(vector, np.float64)
    v = v[v > 0]
    return float(-np.sum(v * np.log(v)))


def information(probabilities: Sequence[float]) -> float:
    """Expected self-information in bits (MathUtils.information :847)."""
    p = np.asarray(probabilities, np.float64)
    p = p[p > 0]
    return float(np.sum(p * np.log(p) / LOG2))


def idf(total_docs: float, num_times_word_appeared: float) -> float:
    """Inverse document frequency (MathUtils.idf :255)."""
    if total_docs <= 0:
        return 0.0
    return math.log10(total_docs / (1.0 + num_times_word_appeared))


def tf(count: int) -> float:
    """Log-scaled term frequency (MathUtils.tf :264)."""
    return math.log10(1 + count)


def tfidf(tf_: float, idf_: float) -> float:
    return tf_ * idf_


def string_similarity(*strings: str) -> float:
    """Shared-character-bigram similarity (MathUtils.stringSimilarity
    :203): |common pairs| * 2 / total pairs."""
    if not strings:
        return 0.0

    def pairs(s: str):
        return [s[i:i + 2] for i in range(len(s) - 1)]

    all_pairs = [pairs(s) for s in strings]
    union = sum(len(p) for p in all_pairs)
    if union == 0:
        return 1.0 if len(set(strings)) == 1 else 0.0
    first = list(all_pairs[0])
    inter = 0
    for other in all_pairs[1:]:
        other = list(other)
        for p in first:
            if p in other:
                inter += 1
                other.remove(p)
    return inter * 2.0 / union


# ----------------------------------------------------- regression/statistics
def correlation(residuals: Sequence[float], target: Sequence[float]) -> float:
    """R^2-style coefficient of determination (MathUtils.correlation :147 —
    ssReg / ssTotal)."""
    ss_total_ = ss_total(residuals, target)
    return ss_reg(residuals, target) / ss_total_ if ss_total_ else 0.0


def ss_reg(residuals: Sequence[float], target: Sequence[float]) -> float:
    """Sum of squares of (target mean - residual) (:172)."""
    r = np.asarray(residuals, np.float64)
    mean = np.mean(np.asarray(target, np.float64))
    return float(np.sum((mean - r) ** 2))


def ss_error(predicted: Sequence[float], target: Sequence[float]) -> float:
    p = np.asarray(predicted, np.float64)
    t = np.asarray(target, np.float64)
    return float(np.sum((t - p) ** 2))


def ss_total(residuals: Sequence[float], target: Sequence[float]) -> float:
    t = np.asarray(target, np.float64)
    return float(np.sum((t - t.mean()) ** 2))


def squared_loss(x: Sequence[float], y: Sequence[float], w0: float,
                 w1: float) -> float:
    xv = np.asarray(x, np.float64)
    yv = np.asarray(y, np.float64)
    return float(np.sum((yv - (w1 * xv + w0)) ** 2))


def w_1(x: Sequence[float], y: Sequence[float], n: int) -> float:
    """OLS slope (MathUtils.w_1 :403)."""
    xv = np.asarray(x, np.float64)[:n]
    yv = np.asarray(y, np.float64)[:n]
    denom = n * np.sum(xv * xv) - np.sum(xv) ** 2
    return float((n * np.sum(xv * yv) - np.sum(xv) * np.sum(yv)) / denom)


def w_0(x: Sequence[float], y: Sequence[float], n: int) -> float:
    """OLS intercept (MathUtils.w_0 :407)."""
    yv = np.asarray(y, np.float64)[:n]
    xv = np.asarray(x, np.float64)[:n]
    return float(yv.mean() - w_1(x, y, n) * xv.mean())


def error_for(actual: float, prediction: float) -> float:
    return actual - prediction


def root_means_squared_error(real: Sequence[float],
                             predicted: Sequence[float]) -> float:
    r = np.asarray(real, np.float64)
    p = np.asarray(predicted, np.float64)
    return float(np.sqrt(np.mean((r - p) ** 2)))


def determination_coefficient(y1: Sequence[float], y2: Sequence[float],
                              n: int) -> float:
    a = np.asarray(y1, np.float64)[:n]
    b = np.asarray(y2, np.float64)[:n]
    c = np.corrcoef(a, b)[0, 1]
    return float(c * c)


def adjusted_r_squared(r_squared: float, num_regressors: int,
                       num_data_points: int) -> float:
    denom = num_data_points - num_regressors - 1
    if denom <= 0:
        return float("nan")
    return 1 - (1 - r_squared) * (num_data_points - 1) / denom
