"""Search algorithms: random sampling and TPE (Bayesian).

A copy of asr_finetune_tpu/hpo/search.py, which imports no JAX: the port
imports nothing of the JAX package, so it keeps its own. Change the two
together (tests/test_torch_hpo.py holds them equal).

Capability parity with the reference's searcher modes
(ray_searchers_and_schedulers.py:12-96):
- `small_small`: BasicVariantGenerator (random) (:47-61)
- `large_small_OPTUNA` / `large_small_BOHB`: OptunaSearch — Optuna's default
  sampler is TPE, re-implemented here (independent per-dimension TPE with
  the standard good/bad split, kernel density ratio l(x)/g(x)) with a
  ConcurrencyLimiter-equivalent handled by the controller (:63-76)
- `large_large`: PBT (schedulers.py) (:78-94)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from .space import Choice, Domain, LogUniform, RandInt, Uniform, sample_config


def _rng_state(rng: np.random.Generator) -> Dict[str, Any]:
    return rng.bit_generator.state


def _set_rng_state(rng: np.random.Generator, state: Dict[str, Any]) -> None:
    rng.bit_generator.state = state


class RandomSearch:
    def __init__(self, space: Dict[str, Domain], seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)

    def suggest(self) -> Dict[str, Any]:
        return sample_config(self.space, self.rng)

    def observe(self, hp: Dict[str, Any], metric: float) -> None:
        pass

    # exact-resume searcher state (reference: Tuner.restore hands Optuna its
    # pickled study, train_hyper.py:349-353). RNG state serializes as the
    # bit-generator's state dict — ints round-trip losslessly through JSON.
    def state_dict(self) -> Dict[str, Any]:
        return {"rng": _rng_state(self.rng)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        _set_rng_state(self.rng, sd["rng"])


class TPESearch:
    """Tree-structured Parzen Estimator, independent per dimension.

    Split observations at the gamma-quantile into good/bad sets; model each
    with kernel densities (gaussian in the transformed space for continuous
    dims, categorical counts for discrete); pick the candidate maximizing
    l(x)/g(x) among n_candidates draws from l.
    """

    def __init__(self, space: Dict[str, Domain], seed: int = 0,
                 gamma: float = 0.25, n_candidates: int = 24,
                 n_startup: int = 5, mode: str = "min"):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self.mode = mode
        self.history: List[Dict[str, Any]] = []
        self.metrics: List[float] = []

    # --- transforms to a continuous modelling space -------------------------
    def _fwd(self, name: str, v):
        d = self.space[name]
        if isinstance(d, LogUniform):
            return math.log(v)
        if isinstance(d, (Uniform, RandInt)):
            return float(v)
        return v  # Choice: categorical

    def _inv(self, name: str, x):
        d = self.space[name]
        if isinstance(d, LogUniform):
            return float(np.clip(math.exp(x), d.low, d.high))
        if isinstance(d, Uniform):
            return float(np.clip(x, d.low, d.high))
        if isinstance(d, RandInt):
            return int(np.clip(round(x), d.low, d.high - 1))
        return x

    def suggest(self) -> Dict[str, Any]:
        if len(self.metrics) < self.n_startup:
            return sample_config(self.space, self.rng)
        sign = 1.0 if self.mode == "min" else -1.0
        order = np.argsort([sign * m for m in self.metrics])
        n_good = max(int(math.ceil(self.gamma * len(order))), 1)
        good = [self.history[i] for i in order[:n_good]]
        bad = [self.history[i] for i in order[n_good:]] or good

        out: Dict[str, Any] = {}
        for name, dom in self.space.items():
            if isinstance(dom, Choice):
                vals = list(dom.values)
                # categorical TPE: probability ratio of smoothed counts
                def counts(obs):
                    c = np.ones(len(vals))  # +1 smoothing
                    for o in obs:
                        if name in o:
                            c[vals.index(o[name])] += 1
                    return c / c.sum()
                pl, pg = counts(good), counts(bad)
                ratio = pl / pg
                # SAMPLE from the normalized l/g ratio (Optuna-style)
                # instead of argmax: an argmax would lock a categorical in
                # after a handful of observations; sampling keeps every
                # category drawn in proportion to its evidence
                probs = ratio / ratio.sum()
                out[name] = vals[int(self.rng.choice(len(vals), p=probs))]
                continue

            xs_good = np.array([self._fwd(name, o[name]) for o in good if name in o])
            xs_bad = np.array([self._fwd(name, o[name]) for o in bad if name in o])
            if len(xs_good) == 0:
                out[name] = dom.sample(self.rng)
                continue
            # bandwidth: Silverman-ish on the good set, floored
            spread = np.std(xs_good) if len(xs_good) > 1 else 1.0
            bw = max(spread * (len(xs_good) ** -0.2), 1e-3 * (abs(float(
                np.mean(xs_good))) + 1.0))

            cands = xs_good[self.rng.integers(len(xs_good), size=self.n_candidates)] \
                + self.rng.normal(0, bw, self.n_candidates)

            def log_kde(xs, pts, width):
                if len(xs) == 0:
                    return np.zeros(len(pts))
                d2 = (pts[:, None] - xs[None, :]) ** 2 / (2 * width ** 2)
                return np.log(np.mean(np.exp(-d2), axis=1) + 1e-12)

            score = log_kde(xs_good, cands, bw) - log_kde(xs_bad, cands, bw)
            out[name] = self._inv(name, float(cands[int(np.argmax(score))]))
        return out

    def observe(self, hp: Dict[str, Any], metric: float) -> None:
        self.history.append(dict(hp))
        self.metrics.append(float(metric))

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": _rng_state(self.rng),
                "history": self.history, "metrics": self.metrics}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        _set_rng_state(self.rng, sd["rng"])
        self.history = [dict(h) for h in sd["history"]]
        self.metrics = [float(m) for m in sd["metrics"]]


def make_searcher(mode: str, space: Dict[str, Domain], seed: int = 0,
                  metric_mode: str = "min"):
    if mode in ("large_small_OPTUNA", "large_small_BOHB"):
        return TPESearch(space, seed=seed, mode=metric_mode)
    return RandomSearch(space, seed=seed)
