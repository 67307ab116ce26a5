"""The digits workloads of the port (``mpi_opt_tpu/workloads/digits.py``),
over the 8x8 digits table that ships with the port
(``data/uci/digits.csv.gz``).

- ``DigitsLogReg`` (``digits``): ``BASELINE.json`` config 1, "Random
  search, 16 trials, sklearn LogisticRegression on digits". A per-trial
  workload of the CPU path. ``budget`` is the solver's ``max_iter``.
- ``DigitsMLP`` (``digits_mlp``): config 8's population twin, a small
  MLP (hidden 32, batch 128, no augmentation) tuned over lr, momentum
  and weight decay. Weight decay moves the effective parameter count,
  so accuracy against params is a real trade-off for a multi-objective
  sweep (``BENCH_ALL.json`` config 8).

The JAX package fits scikit-learn's ``LogisticRegression(solver="lbfgs")``.
The port does not import scikit-learn: ``_fit`` minimises the objective
that scikit-learn's lbfgs path minimises (``LinearModelLoss`` over the
multinomial half-loss: the mean loss plus ``0.5 * ||coef||^2 / (C * n)``,
the intercept not penalised) from zero weights with scipy's L-BFGS-B and
scikit-learn's options, in its dtypes: float32 features, logits and
per-sample losses, float64 coefficients.
"""

from __future__ import annotations

import numpy as np

from mpi_opt_tpu_torch.space import Choice, LogUniform, SearchSpace
from mpi_opt_tpu_torch.workloads import register
from mpi_opt_tpu_torch.workloads.base import Workload
from mpi_opt_tpu_torch.workloads.tabular import TabularMLP

_CACHE: dict = {}


def _data(seed: int):
    """(xtr, xva, ytr, yva): the digits features / 16 in float32 and a
    stratified 75/25 split, scikit-learn's ``train_test_split(...,
    test_size=0.25, random_state=seed, stratify=target)``; cached."""
    if seed not in _CACHE:
        from mpi_opt_tpu_torch.data.loaders import read_digits, stratified_split

        data, target = read_digits()
        x = data.astype(np.float32) / 16.0
        train, test = stratified_split(target, 0.25, seed)
        _CACHE[seed] = (x[train], x[test], target[train], target[test])
    return _CACHE[seed]


def _loss_gradient(coef, x, y, l2: float, n_classes: int, fit_intercept: bool):
    """(loss, gradient) of the flat float64 ``coef`` (classes contiguous
    per feature, Fortran order) as scikit-learn's ``LinearModelLoss.
    loss_gradient`` computes them for the multinomial half-loss: logits
    and per-sample terms in float32 (the exponentials summed in float64
    and rounded once), the penalty in float64."""
    w = coef.reshape((n_classes, -1), order="F")
    if fit_intercept:
        weights, intercept = w[:, :-1], w[:, -1]
    else:
        weights, intercept = w, 0.0
    raw = x @ np.asarray(weights, dtype=x.dtype).T + np.asarray(intercept, dtype=x.dtype)
    n = x.shape[0]
    rows = np.arange(n)
    top = raw.max(axis=1)
    e = np.exp(raw.astype(np.float64) - top.astype(np.float64)[:, None]).astype(np.float32)
    total = np.zeros(n, dtype=np.float64)
    for k in range(n_classes):  # in class order, as the per-sample loop adds them
        total += e[:, k]
    sum_exps = total.astype(np.float32)
    loss = (np.log(sum_exps.astype(np.float64)) + top).astype(np.float32) - raw[rows, y]
    grad_pointwise = e / sum_exps[:, None]
    grad_pointwise[rows, y] -= np.float32(1.0)
    value = float(np.sum(loss) / n)
    flat = np.ravel(weights, order="K")
    value += float(0.5 * l2 * np.dot(flat, flat))
    grad_pointwise /= n
    grad = np.empty((n_classes, w.shape[1]), dtype=weights.dtype, order="F")
    grad[:, :x.shape[1]] = grad_pointwise.T @ x + l2 * weights
    if fit_intercept:
        grad[:, -1] = grad_pointwise.sum(axis=0)
    return value, grad.ravel(order="F")


def _fit(params: dict, budget: int, seed: int):
    """(coef float32[K, F], intercept float32[K]) of the L2 logistic
    regression that scikit-learn's ``LogisticRegression(C, tol,
    fit_intercept, max_iter=budget, solver="lbfgs")`` fits on the
    training split; the optimiser's convergence is not checked (low
    budgets stop early on purpose)."""
    from scipy import optimize

    xtr, _, ytr, _ = _data(seed)
    fit_intercept = bool(params["fit_intercept"])
    n_classes = int(ytr.max()) + 1
    n_dof = xtr.shape[1] + int(fit_intercept)
    w0 = np.zeros((n_classes, n_dof), order="F", dtype=xtr.dtype).ravel(order="F")
    tol = float(params["tol"])
    res = optimize.minimize(
        _loss_gradient, w0, method="L-BFGS-B", jac=True,
        args=(xtr, ytr, 1.0 / (float(params["C"]) * xtr.shape[0]), n_classes, fit_intercept),
        options={"maxiter": max(1, int(budget)), "maxls": 50, "gtol": tol,
                 "ftol": 64 * np.finfo(float).eps},
    )
    w = np.asarray(res.x.reshape((n_classes, -1), order="F"), dtype=xtr.dtype)
    if fit_intercept:
        return w[:, :-1], w[:, -1]
    return w, np.zeros(n_classes, dtype=xtr.dtype)


def _accuracy(coef, intercept, seed: int) -> float:
    _, xva, _, yva = _data(seed)
    pred = np.argmax(xva @ coef.T + intercept, axis=1)
    return float(np.mean(pred == yva))


@register
class DigitsLogReg(Workload):
    name = "digits"

    def default_space(self) -> SearchSpace:
        return SearchSpace(
            {
                "C": LogUniform(1e-4, 1e2),
                "tol": LogUniform(1e-6, 1e-2),
                "fit_intercept": Choice([True, False]),
            }
        )

    def evaluate(self, params: dict, budget: int, seed: int) -> float:
        return _accuracy(*_fit(params, budget, seed), seed)

    # -- multi-objective protocol -----------------------------------------

    def objective_metrics(self) -> tuple[str, ...]:
        return ("accuracy", "params", "latency")

    def evaluate_multi(self, params: dict, budget: int, seed: int, names) -> dict:
        """``params``: the classifier's effective (non-negligible
        coefficient) parameter count, which a stronger L2 (smaller ``C``)
        shrinks; ``latency``: the 2-MACs-per-effective-weight inference
        proxy of the population workloads, in pseudo-ms."""
        coef, intercept = _fit(params, budget, seed)
        eff = float(np.sum(np.abs(coef) > 1e-3))
        if params["fit_intercept"]:
            eff += float(np.sum(np.abs(intercept) > 1e-3))
        out = {}
        for name in names:
            if name == "accuracy":
                out[name] = _accuracy(coef, intercept, seed)
            elif name == "params":
                out[name] = eff
            elif name == "latency":
                out[name] = 2e-6 * float(np.sum(np.abs(coef) > 1e-2))
            else:
                raise ValueError(f"unknown digits objective {name!r}")
        return out


@register
class DigitsMLP(TabularMLP):
    name = "digits_mlp"
    dataset = "digits"
    hidden = 32
    datasets = ("digits",)
