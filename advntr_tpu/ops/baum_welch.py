"""Batched Baum-Welch (EM) statistics and re-estimation on compiled HMMs.

Reference capability class: pomegranate/hmm.pyx:2369 (``fit``) and :2620
(``_summarize``) — expected-count accumulation over reads followed by
normalization.  The reference *runtime* never exercises this path (its EM
calls are commented out, advntr/hmm_utils.py:676-678; ``--update`` is
Viterbi-path-based) — this module closes the capability gap on device:
the silent-eliminated sum-semiring model (models/compiler.compile_graph_sum)
is an ordinary first-order HMM over emitting states, so the textbook
forward-backward xi/gamma statistics are exact on it, and one batched
device pass accumulates them for thousands of reads at once.

Design: one ``lax.scan`` forward storing alpha planes, one reversed scan
accumulating
  xi[i, j]      += E[# transitions i->j]          (per-column (n, n) outer)
  emit[i, s]    += E[# emissions of symbol s from i]
  gamma_start/end: expected start/end occupancies
with every accumulator reduced over the batch inside the scan — the output
is O(n^2), never (L, B, n).  The per-column xi outer product is one
matmul, exp(alpha_t)[B, n] x (exp(e+beta)[B, n]) -> (n, n), after
per-read rescaling by 1/exp(loglik), then an elementwise multiply by
exp(log_T).  Every float32 product here runs at HIGHEST precision: a
TF32 product keeps ~3 decimal digits, which would shift the expected
counts EM re-estimates from.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from advntr_tpu.ops.viterbi import NEG32

HIGHEST = jax.lax.Precision.HIGHEST


def _lse(x, axis):
    mx = jnp.max(x, axis=axis)
    return mx + jnp.log(jnp.sum(jnp.exp(x - jnp.expand_dims(mx, axis)),
                                axis=axis))


@jax.jit
def baum_welch_stats(log_T, log_E, log_start, log_end, seqs, lengths):
    """Expected-count (summarize) pass of Baum-Welch over a read batch.

    Args: sum-closed model tensors (-inf pre-cleaned to ~-1e30, see
    ops/posterior.clean_neg), seqs (B, L) int codes, lengths (B,).

    Returns dict:
      loglik      (B,)   per-read forward log-likelihood
      xi          (n, n) expected transition counts, summed over reads
      emit        (n, 4) expected emission counts
      gamma_start (n,)   expected start-transition counts
      gamma_end   (n,)   expected end-transition counts
    """
    B, L = seqs.shape
    n = log_T.shape[0]
    seqs = seqs.astype(jnp.int32)
    emis = jnp.transpose(jnp.take(log_E, seqs.T, axis=1), (1, 2, 0))
    onehot = jax.nn.one_hot(jnp.clip(seqs, 0, 3), 4, dtype=log_T.dtype)

    # ---- forward, storing alpha planes (frozen past each read's end) ----
    a0 = log_start[None, :] + emis[0]

    def fstep(v, inputs):
        e_t, t = inputs
        nv = _lse(v[:, :, None] + log_T[None, :, :], 1) + e_t
        nv = jnp.where((t < lengths)[:, None], nv, v)
        return nv, nv

    ts = jnp.arange(1, L, dtype=jnp.int32)
    aF, planes = jax.lax.scan(fstep, a0, (emis[1:], ts))
    alphas = jnp.concatenate([a0[None], planes], axis=0)      # (L, B, n)
    loglik = _lse(aF + log_end[None, :], 1)

    gamma_end = jnp.sum(jnp.exp(aF + log_end[None, :] - loglik[:, None]), 0)

    # ---- backward, accumulating xi / emission / start counts ----
    bL = jnp.where((lengths == L)[:, None], log_end[None, :], NEG32)
    emit0 = jnp.dot(jnp.where(
        (lengths == L)[:, None],
        jnp.exp(aF + bL - loglik[:, None]), 0.0).T, onehot[:, L - 1],
        precision=HIGHEST)
    expT = jnp.exp(log_T)

    def bstep(carry, inputs):
        beta_next, xi, emit = carry
        alpha_t, e_next, oh_t, t = inputs
        # xi_t[i, j] = sum_b exp(a_t[b,i] - ll[b]) T[i,j] exp(e+beta)[b,j]
        live = ((t + 1) < lengths)[:, None]
        fa = jnp.exp(alpha_t - loglik[:, None]) * live
        fb = jnp.exp(e_next + beta_next)
        fb = jnp.where(live, fb, 0.0)
        xi = xi + expT * jnp.dot(fa.T, fb, precision=HIGHEST,
                                 preferred_element_type=log_T.dtype)
        # beta at column t (re-seeded at each read's own last column)
        rec = _lse(log_T[None, :, :] + (e_next + beta_next)[:, None, :], 2)
        beta_t = jnp.where((t == lengths - 1)[:, None], log_end[None, :],
                           rec)
        # emission counts at column t: gamma_t^T x onehot_t
        g = jnp.exp(alpha_t + beta_t - loglik[:, None])
        g = jnp.where((t < lengths)[:, None], g, 0.0)
        emit = emit + jnp.dot(g.T, oh_t, precision=HIGHEST,
                              preferred_element_type=log_T.dtype)
        return (beta_t, xi, emit), None

    ts_rev = jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
    (beta0, xi, emit), _ = jax.lax.scan(
        bstep,
        (bL, jnp.zeros((n, n), log_T.dtype), emit0),
        (alphas[:-1][::-1], emis[1:][::-1],
         jnp.transpose(onehot, (1, 0, 2))[:-1][::-1], ts_rev))

    gamma_start = jnp.sum(
        jnp.exp(log_start[None, :] + emis[0] + beta0 - loglik[:, None]), 0)

    return {"loglik": loglik, "xi": xi, "emit": emit,
            "gamma_start": gamma_start, "gamma_end": gamma_end}


def baum_welch_update(log_T, log_E, log_start, log_end, stats,
                      pseudocount: float = 0.0,
                      inertia: float = 0.0):
    """One M-step: normalized expected counts become the new parameters.

    Structural zeros are preserved (a transition/emission at the -1e30
    floor stays there regardless of counts — EM cannot create edges, only
    reweight them, matching pomegranate's from_summaries semantics).
    ``inertia`` linearly mixes old and new probabilities in probability
    space (reference hmm.pyx fit(inertia=...)).  Host-side numpy (f64):
    model re-estimation is offline, exactness beats speed here.
    """
    log_T = np.asarray(log_T, dtype=np.float64)
    log_E = np.asarray(log_E, dtype=np.float64)
    log_start = np.asarray(log_start, dtype=np.float64)
    log_end = np.asarray(log_end, dtype=np.float64)
    floor = np.float64(NEG32) / 2

    xi = np.asarray(stats["xi"], dtype=np.float64) + pseudocount
    emit = np.asarray(stats["emit"], dtype=np.float64) + pseudocount
    g0 = np.asarray(stats["gamma_start"], dtype=np.float64) + pseudocount
    gE = np.asarray(stats["gamma_end"], dtype=np.float64) + pseudocount

    t_mask = log_T > floor
    e_mask = log_E > floor
    s_mask = log_start > floor
    end_mask = log_end > floor

    xi = np.where(t_mask, xi, 0.0)
    emit = np.where(e_mask, emit, 0.0)
    g0 = np.where(s_mask, g0, 0.0)
    gE = np.where(end_mask, gE, 0.0)

    # per-state out-mass includes the end transition
    denom = xi.sum(axis=1) + gE
    with np.errstate(divide="ignore", invalid="ignore"):
        newT = np.where(t_mask & (denom[:, None] > 0),
                        xi / np.maximum(denom[:, None], 1e-300),
                        np.exp(np.where(t_mask, log_T, -np.inf)))
        newEnd = np.where(end_mask & (denom > 0),
                          gE / np.maximum(denom, 1e-300),
                          np.exp(np.where(end_mask, log_end, -np.inf)))
        e_denom = emit.sum(axis=1)
        newE = np.where(e_mask & (e_denom[:, None] > 0),
                        emit / np.maximum(e_denom[:, None], 1e-300),
                        np.exp(np.where(e_mask, log_E, -np.inf)))
        s_denom = g0.sum()
        newS = np.where(s_mask & (s_denom > 0),
                        g0 / max(s_denom, 1e-300),
                        np.exp(np.where(s_mask, log_start, -np.inf)))

    if inertia > 0.0:
        mix = lambda new, old_log, mask: np.where(
            mask, (1 - inertia) * new + inertia * np.exp(old_log), new)
        newT = mix(newT, log_T, t_mask)
        newE = mix(newE, log_E, e_mask)
        newS = mix(newS, log_start, s_mask)
        newEnd = mix(newEnd, log_end, end_mask)

    def relog(p, mask):
        out = np.full(p.shape, np.float64(NEG32))
        np.log(np.maximum(p, 1e-300), out=out, where=mask)
        return out

    return (relog(newT, t_mask), relog(newE, e_mask),
            relog(newS, s_mask), relog(newEnd, end_mask))


def baum_welch_fit(log_T, log_E, log_start, log_end, seqs, lengths,
                   max_iters: int = 10, stop_threshold: float = 1e-3,
                   pseudocount: float = 0.0, inertia: float = 0.0):
    """Full EM loop until total log-likelihood improvement stalls
    (reference fit loop shape: hmm.pyx:2369 max_iterations/stop_threshold).

    Returns (params tuple, history list of total logliks)."""
    from advntr_tpu.ops.posterior import clean_neg
    params = (np.asarray(log_T, np.float64), np.asarray(log_E, np.float64),
              np.asarray(log_start, np.float64),
              np.asarray(log_end, np.float64))
    history = []
    for _ in range(max_iters):
        # device statistics run f32 (f64 needs jax_enable_x64); the f32
        # count noise is far below EM's own stopping threshold
        dev = tuple(clean_neg(p) for p in params)
        stats = baum_welch_stats(*dev, seqs, lengths)
        total = float(np.sum(np.asarray(stats["loglik"])))
        if history and total - history[-1] < stop_threshold:
            history.append(total)
            break
        history.append(total)
        params = baum_welch_update(*params, stats,
                                   pseudocount=pseudocount, inertia=inertia)
    return params, history
