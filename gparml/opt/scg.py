"""Scaled Conjugate Gradients (Moller 1993) — jit'd end-to-end.

JAX re-design of GParML ``scg_adapted.py`` (SURVEY.md §2-3 [C-HIGH]),
which adapted Netlab/GPy SCG so that (a) the objective returns value AND
gradient from one MapReduce pass, (b) the parameter vector is split between
in-memory globals and on-disk per-partition embeddings, with every inner
product computed as an in-memory part plus a map-reduced file part
(``embeddings_get_grads_{mu,kappa,gamma}`` etc.), and (c) step updates are
written back to every partition's files.

Here the whole algorithm is one ``lax.while_loop`` under ``jit``:

  * the parameter "vector" is a pytree; sharded leaves (the (N, Q) variational
    params) stay sharded, so inner products are sharded vdots that XLA reduces
    across devices — the entire embeddings-file-ops family disappears;
  * the objective is a single fused ``value_and_grad`` evaluation, so the
    reference's per-x statistics cache (needed because SCG probes re-evaluate
    f at the same x) is unnecessary by construction;
  * data-dependent accept/reject and lambda adaptation use ``lax.cond`` /
    ``jnp.where`` — no recompilation across iterations.

Each SCG iteration costs at most 2 objective evaluations (the sigma probe and
the candidate step; the candidate's gradient doubles as the next iterate's
gradient on acceptance) vs the reference's 2-3 full MapReduce passes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gparml.models.params import tree_axpy, tree_dot, tree_neg


class SCGOptions(NamedTuple):
    max_iters: int = 100
    xtol: float = 1e-8        # min relative step size before convergence declared
    ftol: float = 1e-8        # min relative |f - fold| before convergence declared
    gtol: float = 1e-10       # ||grad||^2 threshold
    sigma0: float = 1e-4      # finite-difference probe scale
    lam0: float = 1.0         # initial scale/regularization lambda
    lam_min: float = 1e-15
    lam_max: float = 1e100
    display: bool = False     # per-iteration jax.debug.print (reference's display flag)
    trace_timing: bool = False  # stamp real per-iteration wall times via io_callback


class SCGHistory(NamedTuple):
    """Per-iteration trace (nan/False where the loop had already converged):
    the reference's SCG ``display`` output (bound, step size, lambda) as
    arrays — SURVEY.md §5 metrics row asks for a structured per-iteration
    log of (f, grad-norm, lambda, alpha, accepted)."""

    f: jnp.ndarray         # objective after the iteration
    gnorm2: jnp.ndarray    # ||grad||^2 at the new iterate
    lam: jnp.ndarray       # scale/regularization lambda after adaptation
    alpha: jnp.ndarray     # step size along d
    accepted: jnp.ndarray  # bool: candidate step accepted


class SCGState(NamedTuple):
    x: object          # current params pytree
    f_now: jnp.ndarray
    f_old: jnp.ndarray
    g_new: object      # gradient at x
    g_old: object
    d: object          # search direction
    lam: jnp.ndarray
    mu: jnp.ndarray    # d . g
    kappa: jnp.ndarray # d . d
    theta: jnp.ndarray # curvature estimate d^T H d
    success: jnp.ndarray   # bool: last step accepted
    nsuccess: jnp.ndarray  # successes since last restart
    iteration: jnp.ndarray
    done: jnp.ndarray
    n_evals: jnp.ndarray   # objective evaluations so far
    history: SCGHistory    # (max_iters,) per-iteration trace (nan-padded)


def _stamp(iteration) -> None:
    """Ordered host callback recording a wall-clock stamp for this iteration
    (collected by utils.logging.iteration_timer). Opt-in: the callback is a
    host round-trip per iteration, so the default fused loop stays untouched."""
    from jax.experimental import io_callback

    from gparml.utils import logging as glog

    io_callback(glog.stamp_iteration, None, iteration, ordered=True)


def _tree_max_abs(t) -> jnp.ndarray:
    leaves = [jnp.max(jnp.abs(l)) for l in jax.tree.leaves(t)]
    return jnp.array(leaves).max()


def _resolve_options(options: SCGOptions, dtype) -> SCGOptions:
    """Clamp lambda bounds into the objective dtype's finite range (e.g. f32)
    and floor the convergence tolerances at ~30 dtype epsilons: the
    reference's absolute 1e-8 defaults assume float64; below f32 resolution
    they fire on rounding noise."""
    fi = jnp.finfo(dtype)
    lam_max = min(options.lam_max, float(fi.max) / 8.0)
    lam_min = max(options.lam_min, float(fi.tiny) * 8.0)
    tol_floor = 30.0 * float(fi.eps)
    return options._replace(
        lam_max=lam_max, lam_min=lam_min,
        xtol=max(options.xtol, tol_floor), ftol=max(options.ftol, tol_floor),
        # curvature probe must out-scale gradient rounding noise
        sigma0=max(options.sigma0, 10.0 * float(fi.eps) ** 0.5),
    )


def _initial_state(x0, f0, g0, options: SCGOptions) -> SCGState:
    """SCG state at the starting point given the (f, grad) there; options
    must already be resolved for f0's dtype."""
    d0 = tree_neg(g0)
    nanrow = jnp.full((options.max_iters,), jnp.nan, dtype=f0.dtype)
    history0 = SCGHistory(
        f=nanrow, gnorm2=nanrow, lam=nanrow, alpha=nanrow,
        accepted=jnp.zeros((options.max_iters,), bool),
    )

    return SCGState(
        x=x0,
        f_now=f0,
        f_old=f0,
        g_new=g0,
        g_old=g0,
        d=d0,
        lam=jnp.asarray(options.lam0, dtype=f0.dtype),
        mu=jnp.zeros((), f0.dtype),
        kappa=jnp.zeros((), f0.dtype),
        theta=jnp.zeros((), f0.dtype),
        success=jnp.asarray(True),
        nsuccess=jnp.zeros((), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
        done=jnp.asarray(False),
        n_evals=jnp.ones((), jnp.int32),
        history=history0,
    )


def _make_body(value_and_grad_fn: Callable, options: SCGOptions, nparams: int):
    """One SCG iteration state -> state (the reference's per-iteration block,
    SURVEY.md §3.3); shared verbatim by the fused while_loop driver and the
    host-stepped driver so the two execute the identical algorithm."""

    def body(st: SCGState) -> SCGState:
        dt = st.f_now.dtype

        # --- (re)compute direction scalars + curvature probe on success ---
        def probe(st: SCGState):
            mu = tree_dot(st.d, st.g_new)
            # if mu >= 0 the direction is not a descent direction: restart
            bad = mu >= 0
            d = jax.tree.map(
                lambda di, gi: jnp.where(bad, -gi, di), st.d, st.g_new
            )
            mu = jnp.where(bad, tree_dot(d, st.g_new), mu)
            kappa = tree_dot(d, d)
            kappa = jnp.maximum(kappa, jnp.asarray(1e-300 if dt == jnp.float64 else 1e-30, dt))
            sigma = options.sigma0 / jnp.sqrt(kappa)
            _, g_plus = value_and_grad_fn(tree_axpy(sigma, d, st.x))
            theta = (tree_dot(d, g_plus) - mu) / sigma
            return st._replace(
                d=d, mu=mu, kappa=kappa, theta=theta,
                n_evals=st.n_evals + 1,
            )

        st = jax.lax.cond(st.success, probe, lambda s: s, st)

        # --- scale curvature: delta = theta + lam * kappa, force positive ---
        delta = st.theta + st.lam * st.kappa
        neg = delta <= 0
        lam = jnp.where(neg, st.lam - st.theta / st.kappa, st.lam)
        delta = jnp.where(neg, lam * st.kappa, delta)

        # --- candidate step ---
        alpha = -st.mu / delta
        x_new = tree_axpy(alpha, st.d, st.x)
        f_new, g_cand = value_and_grad_fn(x_new)
        ratio = 2.0 * (f_new - st.f_old) / (alpha * st.mu)
        ok = jnp.logical_and(ratio >= 0, jnp.isfinite(f_new))

        # --- accept / reject ---
        x = jax.tree.map(
            lambda a, b: jnp.where(ok, a, b), x_new, st.x
        )
        f_now = jnp.where(ok, f_new, st.f_old)
        nsuccess = jnp.where(ok, st.nsuccess + 1, st.nsuccess)

        # on acceptance the candidate gradient is the new gradient
        g_old = jax.tree.map(lambda a, b: jnp.where(ok, a, b), st.g_new, st.g_old)
        g_new = jax.tree.map(lambda a, b: jnp.where(ok, a, b), g_cand, st.g_new)

        # convergence tests (only meaningful after an accepted step); both
        # relative — to parameter scale and objective scale respectively
        x_scale = 1.0 + _tree_max_abs(st.x)
        small_step = (
            _tree_max_abs(jax.tree.map(lambda di: alpha * di, st.d))
            < options.xtol * x_scale
        )
        small_df = jnp.abs(f_new - st.f_old) < options.ftol * (1.0 + jnp.abs(f_new))
        gg = tree_dot(g_new, g_new)
        done = jnp.logical_and(ok, jnp.logical_and(small_step, small_df))
        done = jnp.logical_or(done, gg < options.gtol)

        f_old = jnp.where(ok, f_new, st.f_old)

        # --- lambda adaptation ---
        lam = jnp.where(ratio < 0.25, jnp.minimum(4.0 * lam, options.lam_max), lam)
        lam = jnp.where(ratio > 0.75, jnp.maximum(0.5 * lam, options.lam_min), lam)
        lam = jnp.where(jnp.isfinite(f_new), lam, jnp.minimum(4.0 * lam, options.lam_max))

        # --- new direction: periodic restart or Polak-Ribiere-style update ---
        restart = nsuccess >= nparams
        gamma = (tree_dot(g_old, g_new) - tree_dot(g_new, g_new)) / st.mu
        d = jax.tree.map(
            lambda di, gi: jnp.where(
                restart,
                -gi,
                jnp.where(ok, gamma * di - gi, di),
            ),
            st.d, g_new,
        )
        nsuccess = jnp.where(restart, 0, nsuccess)

        history = SCGHistory(
            f=st.history.f.at[st.iteration].set(f_now),
            gnorm2=st.history.gnorm2.at[st.iteration].set(gg),
            lam=st.history.lam.at[st.iteration].set(lam),
            alpha=st.history.alpha.at[st.iteration].set(alpha),
            accepted=st.history.accepted.at[st.iteration].set(ok),
        )

        if options.display:
            jax.debug.print(
                "SCG iter {i}: f={f} lambda={l} accepted={a}",
                i=st.iteration, f=f_now, l=lam, a=ok,
            )
        if options.trace_timing:
            _stamp(st.iteration)

        return SCGState(
            x=x, f_now=f_now, f_old=f_old, g_new=g_new, g_old=g_old, d=d,
            lam=lam, mu=st.mu, kappa=st.kappa, theta=st.theta,
            success=ok, nsuccess=nsuccess,
            iteration=st.iteration + 1, done=done,
            n_evals=st.n_evals + 1, history=history,
        )

    return body


def bucket_iters(iters: int) -> int:
    """Static history capacity for a given iteration budget: rounds up to a
    shared bucket (>=128, power of two) so fits with different ``iters``
    trace to IDENTICAL programs — the true limit rides as a runtime scalar
    (``iter_limit``) and the loop still stops there. One persistent-cache
    entry then serves every T <= bucket: without this, a resume with a
    different -T recompiled the whole fused fit. History stays nan-padded past the executed
    iterations, which every consumer already drops (utils.logging
    write_history)."""
    if iters <= 0:
        return iters
    return max(128, 1 << (iters - 1).bit_length())


def minimize(
    value_and_grad_fn: Callable,
    x0,
    options: SCGOptions = SCGOptions(),
    iter_limit=None,
) -> SCGState:
    """Minimize ``value_and_grad_fn`` (params -> (f, grad pytree)) with SCG.

    Returns the final SCGState; ``state.x`` are the optimized params,
    ``state.history`` an SCGHistory of per-iteration (f, ||grad||^2, lambda,
    alpha, accepted) arrays (nan/False where the loop had already
    converged). Call under jit for a fully fused loop.

    ``iter_limit`` (optional, <= options.max_iters) may be a TRACED scalar:
    ``options.max_iters`` then only sizes the history arrays (see
    ``bucket_iters``) while the loop stops at the runtime limit — callers
    that jit this with the limit as an argument share one compiled program
    across different iteration budgets.
    """
    nparams = sum(l.size for l in jax.tree.leaves(x0))

    f0, g0 = value_and_grad_fn(x0)
    options = _resolve_options(options, f0.dtype)
    state = _initial_state(x0, f0, g0, options)

    if options.max_iters == 0:
        # pure evaluation at x0 (while_loop would still TRACE the body, and
        # a size-0 history cannot be indexed even in dead code)
        return state

    if iter_limit is None:
        iter_limit = options.max_iters
    # clamp into the history capacity; stays traced if iter_limit is traced
    iter_limit = jnp.minimum(jnp.asarray(iter_limit, jnp.int32),
                             jnp.int32(options.max_iters))

    if options.trace_timing:
        _stamp(jnp.int32(-1))  # loop-entry stamp: baseline free of compile time

    def cond(st: SCGState):
        return jnp.logical_and(st.iteration < iter_limit, ~st.done)

    body = _make_body(value_and_grad_fn, options, nparams)
    return jax.lax.while_loop(cond, body, state)


# Above this many data rows the fit drivers (gplvm.fit / sgpr.fit, mode
# "auto") switch from the fused while_loop to the host-stepped driver, which
# bounds each device program to one SCG iteration. Whether large-N fits
# need that bound on the GPU has not been measured.
STEPPED_N_THRESHOLD = 2_000_000


def use_stepped(mode: str, n_rows: int) -> bool:
    """Resolve a fit driver's scg_mode knob: 'fused' | 'stepped' | 'auto'
    (auto = stepped at/above STEPPED_N_THRESHOLD data rows)."""
    if mode == "stepped":
        return True
    if mode == "fused":
        return False
    if mode != "auto":
        raise ValueError(
            f"scg_mode must be 'fused', 'stepped' or 'auto'; got {mode!r}")
    return n_rows >= STEPPED_N_THRESHOLD


def minimize_stepped(
    value_and_grad_fn: Callable,
    x0,
    options: SCGOptions = SCGOptions(),
    extra: tuple = (),
    iter_limit: int = None,
) -> SCGState:
    """``minimize`` with one jitted device program PER SCG ITERATION instead
    of one fused while_loop program for the whole fit.

    Same algorithm, same SCGState result (the iteration body is shared code,
    ``_make_body``); the loop and the convergence test run on the host, which
    costs one scalar device sync per iteration and buys:

      * bounded per-program execution time and working set (see
        STEPPED_N_THRESHOLD);
      * donation of the ~4x(N-sized) optimizer state between iterations
        (the fused driver gets the same effect from while_loop's carry).

    This is also structurally the reference's execution model: GParML's
    scg_adapted.py runs each objective evaluation as its own MapReduce pass
    with the SCG loop in the host process (SURVEY.md §3.3).

    ``value_and_grad_fn(p, *extra)``: ``extra`` rides as jit arguments (not
    closure constants) — pass data/weights/masks there, exactly like the
    fit drivers do for the fused path. Must NOT be called under jit.
    ``iter_limit`` (host int, <= options.max_iters) bounds the host loop
    when options.max_iters is a bucketed history capacity (bucket_iters).
    """
    nparams = sum(l.size for l in jax.tree.leaves(x0))

    f0, g0 = jax.jit(value_and_grad_fn)(x0, *extra)
    options = _resolve_options(options, f0.dtype)
    state = _initial_state(x0, f0, g0, options)

    if options.max_iters == 0:
        return state

    if options.trace_timing:
        from gparml.utils import logging as glog

        glog.stamp_iteration(-1)

    # Donate the four N-sized trees between iterations (x, g_new, g_old, d
    # — the ~4x(N-sized) optimizer state) so each program updates them in
    # place. They ride as their own argument because donation needs unique
    # buffers: the scalars/history in `rest` can be output-aliased by XLA
    # (f_now/f_old are the same expression), and the initial state aliases
    # g_old to g_new and x to the CALLER's pytree — copied below so the
    # caller's params survive the first donation.
    def _split(st: SCGState):
        return ((st.x, st.g_new, st.g_old, st.d),
                st._replace(x=None, g_new=None, g_old=None, d=None))

    def _merge(big, rest: SCGState) -> SCGState:
        return rest._replace(x=big[0], g_new=big[1], g_old=big[2], d=big[3])

    state = state._replace(
        x=jax.tree.map(jnp.copy, state.x),
        g_old=jax.tree.map(jnp.copy, state.g_old),
    )

    @partial(jax.jit, donate_argnums=0)
    def step(big, rest, *ex):
        st = _make_body(lambda p: value_and_grad_fn(p, *ex),
                        options, nparams)(_merge(big, rest))
        return _split(st)

    # host-side loop bound; max_iters only sizes the history (bucket_iters)
    limit = options.max_iters if iter_limit is None else min(
        int(iter_limit), options.max_iters)
    big, rest = _split(state)
    while (int(rest.iteration) < limit
           and not bool(rest.done)):
        big, rest = step(big, rest, *extra)
    return _merge(big, rest)
