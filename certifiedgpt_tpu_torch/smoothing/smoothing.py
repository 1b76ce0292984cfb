"""Randomized-smoothing certification core (Cohen et al. 2019).

Re-implements the reference's ``Smooth`` class
(ref ``randomized_smoothing/smoothing.py:13-117``) with the same
statistics and decision rules:

- ``certify``: n0 selection draws pick the top class; n estimation draws
  give a Clopper-Pearson lower bound ``pA_bar`` on its probability at
  one-sided level alpha (the reference calls
  ``proportion_confint(nA, n, alpha=2*alpha, method="beta")[0]``;
  implemented here directly from the Beta quantile, identical values);
  abstain iff ``pA_bar < 0.5`` else certified radius
  ``R = sigma * Phi^-1(pA_bar)`` (the code-form one-class bound — the
  reference README quotes the two-class form, SURVEY.md §2.4 note a).
- ``predict``: two-sided binomial test on the top-2 counts, abstain iff
  p-value > alpha (ref ``smoothing.py:58-79``).

The noise loop is delegated to a ``sample_fn`` that runs the batched
noisy forward on the device (see ``smoothing/classifier.py``); this module
owns only the statistics. It is a copy of
``certifiedgpt_tpu/smoothing/smoothing.py`` (numpy and scipy only), kept in
the PyTorch package so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
from scipy.stats import binomtest, norm
from scipy.stats import beta as beta_dist

ABSTAIN = -1

# certify() draws two independent streams (selection, estimation). The
# agents derive per-image seeds through the splitmix64 hash
# ``agents.certify.certify_seed`` (62-bit, sigma folded in), so the only
# invariant this offset must provide is that one image's selection and
# estimation streams differ; the wide stride additionally keeps the
# streams disjoint even for callers that DO seed consecutively
# (``Smooth`` is a public class — its callers are not required to hash).
_ESTIMATION_SEED_OFFSET = 1 << 20


def clopper_pearson_lower(k: int, n: int, alpha: float) -> float:
    """One-sided lower confidence bound for a binomial proportion.

    Equal to ``statsmodels.stats.proportion.proportion_confint(k, n,
    alpha=2*alpha, method="beta")[0]`` — the exact (Beta-quantile)
    Clopper-Pearson bound the reference uses (ref ``smoothing.py:107-117``).
    """
    if n == 0:
        return 0.0
    if k == 0:
        return 0.0
    return float(beta_dist.ppf(alpha, k, n - k + 1))


def clopper_pearson_upper(k: int, n: int, alpha: float) -> float:
    """One-sided upper confidence bound for a binomial proportion (the
    Beta quantile at 1 - alpha)."""
    if n == 0:
        return 1.0
    if k == n:
        return 1.0
    return float(beta_dist.ppf(1.0 - alpha, k + 1, n - k))


def binom_p_value(k: int, n: int, p: float = 0.5) -> float:
    """Two-sided exact binomial test (scipy.binomtest; the reference's
    deprecated ``scipy.stats.binom_test`` computed the same value)."""
    if n == 0:
        return 1.0
    return float(binomtest(k, n, p).pvalue)


def certified_radius(sigma: float, p_lower: float) -> float:
    """R = sigma * Phi^-1(pA_bar) (ref ``smoothing.py:52-56``)."""
    return float(sigma * norm.ppf(p_lower))


def min_count_for_lower_bound(p: float, n: int, alpha: float) -> int:
    """Smallest count m in [0, n] whose Clopper-Pearson lower bound
    reaches ``p`` — ``n + 1`` when even m = n falls short.

    The exact-early-stopping thresholds both derive from this (the
    bound is monotone in m):

    - abstain-certain: the final decision abstains iff the estimation
      count of the top class ends below ``m* = min_count(0.5, n, alpha)``;
      once the count c after k draws satisfies ``c + (n - k) < m*`` no
      continuation can avoid abstention, so stopping there is
      statistically FREE — no alpha is spent on the stopping rule (it
      conditions on a deterministic implication, not on the data beyond
      what the final test would see) and the returned (ABSTAIN, 0.0) is
      bit-identical to the full-budget run's.
    - success-certain: once ``c >= min_count(p_target, n, alpha)`` the
      final bound is guaranteed to reach ``p_target`` (counts only
      grow), so a caller that only needs radius >= R can stop and report
      the conservative floor ``sigma * Phi^-1(CP_lower(c, n, alpha))`` —
      valid because the full-run count would be >= c and the bound is
      monotone (couple the unseen draws; they can only raise it).
    """
    lo, hi = 0, n + 1
    while lo < hi:
        mid = (lo + hi) // 2
        if clopper_pearson_lower(mid, n, alpha) >= p:
            hi = mid
        else:
            lo = mid + 1
    return lo


def certified_radius_two_class(
    sigma: float, p_a_lower: float, p_b_upper: float
) -> float:
    """The README's two-class form R = sigma/2 (Phi^-1(pA) - Phi^-1(pB))
    (ref ``README.md:54``), provided for analysis parity."""
    return float(0.5 * sigma * (norm.ppf(p_a_lower) - norm.ppf(p_b_upper)))


def certify_from_counts(
    sel_counts: np.ndarray,
    est_counts: np.ndarray,
    n: int,
    alpha: float,
    sigma: float,
) -> Tuple[int, float]:
    """Cohen's certify decision from the two count vectors: top class of
    the selection counts, Clopper-Pearson lower bound of its estimation
    count, abstain iff pA_bar < 0.5 else R = sigma * Phi^-1(pA_bar)
    (ref ``smoothing.py:44-56``). The SINGLE home of the decision rule —
    ``Smooth.certify`` and the continuous-batching scheduler both call
    it, so the serial and continuous modes cannot silently diverge."""
    c_a = int(np.argmax(sel_counts))
    n_a = int(est_counts[c_a])
    p_a_bar = clopper_pearson_lower(n_a, n, alpha)
    if p_a_bar < 0.5:
        return ABSTAIN, 0.0
    return c_a, certified_radius(sigma, p_a_bar)


def predict_from_counts(counts: np.ndarray, alpha: float) -> int:
    """Smooth.predict's decision from the count vector: top class, with
    a two-sided binomial test on the top-2 split; abstain iff the
    p-value exceeds alpha (ref ``smoothing.py:58-79``). Shared by
    ``Smooth.predict`` and the continuous-batching scheduler."""
    top2 = counts.argsort()[::-1][:2]
    c_a, c_b = int(top2[0]), int(top2[1])
    n_a, n_b = int(counts[c_a]), int(counts[c_b])
    if binom_p_value(n_a, n_a + n_b, 0.5) > alpha:
        return ABSTAIN
    return c_a


def predict_stop_certain(
    counts: np.ndarray, remaining: int, alpha: float
) -> bool:
    """True when EVERY completion of the ``remaining`` draws yields the
    same ``predict_from_counts`` decision the partial ``counts`` already
    imply — the completion-certain stopping rule for predict. Stopping
    on it spends no alpha (a deterministic implication of data the final
    test would see, the same argument as ``min_count_for_lower_bound``'s
    abstain-certain rule) and the decision is bit-identical to the
    full-budget run's.

    The test statistic is the top-2 pair (n_a, n_b); at p = 1/2 the
    two-sided exact p-value ``2 P(Binom(n_a+n_b, 1/2) >= n_a)`` is
    monotone by a one-draw coupling — DECREASING in n_a (the extra draw
    can only push the tail further out: P(X + B >= k+1) =
    P(X >= k+1) + P(B=1) P(X = k) <= P(X >= k)) and INCREASING in n_b
    (P(X + B >= k) >= P(X >= k)). Counts never decrease, so the
    reachable (n_a, n_b) pairs form a lattice whose p-value extremes sit
    at corners, and certainty reduces to three corner checks on the
    current top count ``a`` and runner-up count ``b`` with ``r`` draws
    left:

    - class-certain: ``a >= b + r + 1`` (no class can tie the top even
      taking every remaining draw, so the final argmax is today's) AND
      the least significant completion ``(a, b + r)`` still rejects —
      then every completion returns the same class.
    - abstain-certain: the MOST significant completions are
      ``(a + r, b)`` (argmax keeps the lead, takes everything) and
      ``(b + r, a)`` (the strongest challenger overtakes — any other
      class t has c_t <= b and by n_a-monotonicity is dominated); if
      neither rejects, no completion rejects and every completion
      abstains.

    Draws the sampler discards (label < 0) only shrink the effective
    ``r``, which keeps both checks conservative. No reference
    counterpart (the reference always burns the full n,
    ref ``smoothing.py:58-79``).
    """
    r = int(remaining)
    if r <= 0:
        return True
    c = np.asarray(counts, dtype=np.int64)
    order = np.argsort(c)[::-1]
    a = int(c[order[0]])
    b = int(c[order[1]])
    if a >= b + r + 1 and binom_p_value(a, a + b + r, 0.5) <= alpha:
        return True  # class-certain: same top class, always significant
    if binom_p_value(a + r, a + r + b, 0.5) <= alpha:
        return False  # a completion keeping today's argmax can reject
    if b + r >= a and binom_p_value(b + r, b + r + a, 0.5) <= alpha:
        return False  # a challenger-overtakes completion can reject
    return True  # abstain-certain: no completion reaches significance


class Smooth:
    """Smoothed classifier g(x) = argmax_c P(f(x + sigma*eps) = c).

    ``sample_fn(x, num, seed) -> np.ndarray[num] of int labels`` runs the
    base classifier on ``num`` noisy copies of ``x`` — noise included —
    and returns hard labels. It owns all device work; this class owns the
    statistics. ``num_classes`` fixes the label set (required for Cohen's
    guarantee: the set must not depend on the draws).

    Early stopping (``certify(..., early_abstain=True)`` /
    ``early_stop_radius=R``) additionally requires the sample_fn to
    accept a ``should_stop(labels_so_far) -> bool`` keyword and to
    return the labels drawn so far when it fires — the draws must be a
    PREFIX of the full-budget stream (chunk keys independent of the
    total), which ``classifier.make_sample_fn`` guarantees.
    ``last_draws`` records the draws consumed by the most recent
    certify/predict call (n0 + estimation draws actually labeled).
    """

    ABSTAIN = ABSTAIN

    def __init__(
        self,
        sample_fn: Callable[[np.ndarray, int, int], np.ndarray],
        num_classes: int,
        sigma: float,
    ):
        self.sample_fn = sample_fn
        self.num_classes = num_classes
        self.sigma = float(sigma)
        self.last_draws = 0

    # ------------------------------------------------------------------
    def _counts(self, x, num: int, seed: int) -> np.ndarray:
        labels = np.asarray(self.sample_fn(x, num, seed))
        if labels.size and labels.max() >= self.num_classes:
            # a label outside the declared set means the vocab/mapping is
            # broken; silently bincounting past num_classes would let
            # certify return a "certified" class that does not exist in
            # the fixed label set Cohen's guarantee requires
            raise ValueError(
                f"sample_fn returned label {int(labels.max())} >= "
                f"num_classes {self.num_classes}"
            )
        counts = np.bincount(
            labels[labels >= 0], minlength=self.num_classes
        ).astype(np.int64)
        return counts

    # ------------------------------------------------------------------
    def certify(
        self,
        x,
        n0: int,
        n: int,
        alpha: float,
        seed: int = 0,
        early_abstain: bool = False,
        early_stop_radius: Optional[float] = None,
    ) -> Tuple[int, float]:
        """Return (class, certified radius) or (ABSTAIN, 0.0)
        (ref ``smoothing.py:29-56``).

        ``early_abstain``: stop the estimation pass the moment the final
        abstention is already CERTAIN — after k draws with top-class
        count c, if ``c + (n - k) < min_count(0.5, n, alpha)`` no
        continuation reaches pA_bar >= 0.5. Statistically free: no alpha
        spent, (label, radius) bit-identical to the full-budget run
        (see ``min_count_for_lower_bound``). The reference always burns
        the full n (ref ``smoothing.py:44-56``).

        ``early_stop_radius=R``: additionally stop once radius >= R is
        guaranteed, returning the conservative floor
        ``sigma * Phi^-1(CP_lower(c, n, alpha))`` (>= R, <= the
        full-budget radius) — the label matches the full run; only the
        reported radius is a floor. Use when a radius-grid summary is
        the product and R >= max(grid): the grid rows are then identical
        to the full-budget run's.
        """
        self.last_draws = 0
        if self.num_classes < 2:
            # degenerate single-class label set (e.g. every ground-truth
            # answer normalizes to empty): every draw trivially maps to
            # the one class, so a "certificate" would be vacuous — abstain
            # like predict does rather than report a large radius
            return ABSTAIN, 0.0
        counts0 = self._counts(x, n0, seed)
        self.last_draws = n0
        est_seed = seed + _ESTIMATION_SEED_OFFSET
        if not early_abstain and early_stop_radius is None:
            counts = self._counts(x, n, est_seed)
            self.last_draws += n
            return certify_from_counts(counts0, counts, n, alpha, self.sigma)

        c_a = int(np.argmax(counts0))
        m_abstain = min_count_for_lower_bound(0.5, n, alpha) if early_abstain else None
        m_success = None
        if early_stop_radius is not None and self.sigma > 0:
            p_target = float(norm.cdf(early_stop_radius / self.sigma))
            m_success = min_count_for_lower_bound(p_target, n, alpha)
            if m_success > n:
                m_success = None  # unreachable target: never fires

        def should_stop(labels: np.ndarray) -> bool:
            k = labels.size
            c = int(np.count_nonzero(labels == c_a))
            if m_abstain is not None and c + (n - k) < m_abstain:
                return True
            if m_success is not None and c >= m_success:
                return True
            return False

        labels = np.asarray(
            self._call_with_stop(x, n, est_seed, should_stop)
        )
        if labels.size and labels.max() >= self.num_classes:
            raise ValueError(
                f"sample_fn returned label {int(labels.max())} >= "
                f"num_classes {self.num_classes}"
            )
        self.last_draws += int(labels.size)
        counts = np.bincount(
            labels[labels >= 0], minlength=self.num_classes
        ).astype(np.int64)
        # one shared finalization: with partial counts this yields exactly
        # ABSTAIN in the abstain-certain case (the partial count is below
        # m_abstain by construction) and the conservative floor radius in
        # the success-certain case; with full counts it is the standard
        # Cohen decision
        return certify_from_counts(counts0, counts, n, alpha, self.sigma)

    def _call_with_stop(self, x, n: int, seed: int, should_stop):
        try:
            return self.sample_fn(x, n, seed, should_stop=should_stop)
        except TypeError as exc:
            if "should_stop" in str(exc):
                raise TypeError(
                    "early_abstain/early_stop_radius need a sample_fn that "
                    "accepts should_stop= (classifier.make_sample_fn does)"
                ) from exc
            raise

    # ------------------------------------------------------------------
    def predict(
        self,
        x,
        n: int,
        alpha: float,
        seed: int = 0,
        early_stop: bool = False,
    ) -> int:
        """Top class of n draws, abstain unless the top-2 split is
        significant at level alpha (ref ``smoothing.py:58-79``).

        ``early_stop``: stop the moment every completion of the
        remaining draws yields the same decision
        (``predict_stop_certain`` — exact corner checks on the monotone
        two-sided p-value). Statistically free, decision bit-identical
        to the full-budget run; needs the should_stop-capable sample_fn
        that ``early_abstain`` does. The reference always burns the
        full n."""
        self.last_draws = 0
        if self.num_classes < 2:
            # degenerate single-class label set: the two-sided test is
            # meaningless; abstain BEFORE paying the n-draw Monte-Carlo
            # pass (certify guards the same way)
            return ABSTAIN
        if not early_stop:
            counts = self._counts(x, n, seed)
            self.last_draws = n
            return predict_from_counts(counts, alpha)

        def should_stop(labels: np.ndarray) -> bool:
            counts = np.bincount(
                labels[labels >= 0], minlength=self.num_classes
            )
            return predict_stop_certain(counts, n - labels.size, alpha)

        labels = np.asarray(self._call_with_stop(x, n, seed, should_stop))
        if labels.size and labels.max() >= self.num_classes:
            raise ValueError(
                f"sample_fn returned label {int(labels.max())} >= "
                f"num_classes {self.num_classes}"
            )
        self.last_draws = int(labels.size)
        counts = np.bincount(
            labels[labels >= 0], minlength=self.num_classes
        ).astype(np.int64)
        # exact with partial counts: predict_stop_certain only fires when
        # the partial decision is what every completion returns (the
        # class-certain corner keeps the argmax and significance; the
        # abstain-certain corners rule significance out entirely)
        return predict_from_counts(counts, alpha)
