"""Backward / forward-backward posterior kernels over compiled HMMs.

Reference capability class: pomegranate/hmm.pyx:1541 (``_backward``),
:1777 (``_forward_backward``) — per-read sparse-graph passes with silent
states inside the hot loop.  The device design works on the
silent-eliminated sum-semiring model (``compile_graph_sum``): one
``lax.scan`` forward storing alpha planes, one reversed scan computing
beta while accumulating per-read posterior statistics, so the aggregate
path returns O(B) scalars with no (L, B, n) host materialization.

Posterior *deletion* evidence needs care because deletions are silent and
therefore invisible in the eliminated state space: they live inside the
effective-transition closures.  The exact decomposition used here splits
each effective transition weight into

    exp(log_T[i, j]) = exp(log_T_nodel[i, j]) + exp(log_T_del[i, j])

where ``log_T_nodel`` is the sum-closure computed with repeat-region
delete states removed from the silent subgraph, and ``log_T_del`` is the
log-space difference — the total weight of silent routes i -> j passing
at least one repeat delete.  Expected usage of those routes is then an
ordinary expected-transition-count (the xi statistic of forward-backward)
against ``log_T_del``, which equals d loglik / d theta for a weight tilt
``log_T(theta) = logaddexp(log_T_nodel, log_T_del + theta)`` at theta=0 —
the property the conformance tests check by finite differences.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from advntr_tpu.ops.viterbi import NEG32


def _lse(x, axis):
    mx = jnp.max(x, axis=axis)
    return mx + jnp.log(jnp.sum(jnp.exp(x - jnp.expand_dims(mx, axis)),
                                axis=axis))


def clean_neg(x, dtype=jnp.float32):
    """Replace -inf with the f32-safe floor and upload."""
    x = np.asarray(x, dtype=np.float64)
    x = np.where(np.isfinite(x), x, np.float64(NEG32))
    return jnp.asarray(x, dtype=dtype)


def log_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise log(exp(a) - exp(b)) for b <= a (host, float64).
    Entries where b catches up to a (no extra mass) map to -1e30."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        d = b - a
        out = a + np.log1p(-np.exp(np.minimum(d, -1e-12)))
    bad = ~np.isfinite(a) | (d > -1e-9)
    out = np.where(bad, np.float64(NEG32), out)
    return out


@jax.jit
def backward_batch(log_T, log_E, log_start, log_end, seqs, lengths):
    """Batched backward algorithm: per-read log-likelihood computed purely
    from the backward recursion (conformance partner of
    ``viterbi.forward_batch``; reference pomegranate/hmm.pyx:1541).

    beta_t[i] = log P(o_{t+1..len-1}, reach END | state i at t); the
    variable-length batch is handled by re-seeding the carry with log_end
    at each read's own last column (t == len-1) during the reversed scan.
    Returns loglik (B,).
    """
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)
    emis = jnp.transpose(jnp.take(log_E, seqs.T, axis=1), (1, 2, 0))

    bL = jnp.where((lengths == L)[:, None], log_end[None, :], NEG32)

    def step(beta, inputs):
        e_next, t = inputs
        rec = _lse(log_T[None, :, :] + (e_next + beta)[:, None, :], 2)
        beta_t = jnp.where((t == lengths - 1)[:, None], log_end[None, :],
                           rec)
        return beta_t, None

    ts = jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
    beta0, _ = jax.lax.scan(step, bL, (emis[1:][::-1], ts))
    return _lse(log_start[None, :] + emis[0] + beta0, 1)


@jax.jit
def forward_backward_batch(log_T, log_E, log_start, log_end, seqs, lengths):
    """Batched forward-backward: per-position state posteriors.

    Returns (loglik (B,), gamma (L, B, n)) with
    gamma[t, b, j] = log P(state j at position t | read b); positions
    t >= lengths[b] hold garbage (mask downstream).  Materializes the
    (L, B, n) planes — intended for offline/posterior analysis at
    frameshift-scale batches, not the genotyping hot path.
    """
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)
    emis = jnp.transpose(jnp.take(log_E, seqs.T, axis=1), (1, 2, 0))

    a0 = log_start[None, :] + emis[0]

    def fstep(v, inputs):
        e_t, t = inputs
        nv = _lse(v[:, :, None] + log_T[None, :, :], 1) + e_t
        nv = jnp.where((t < lengths)[:, None], nv, v)
        return nv, nv

    ts = jnp.arange(1, L, dtype=jnp.int32)
    aF, planes = jax.lax.scan(fstep, a0, (emis[1:], ts))
    alphas = jnp.concatenate([a0[None], planes], axis=0)
    loglik = _lse(aF + log_end[None, :], 1)

    bL = jnp.where((lengths == L)[:, None], log_end[None, :], NEG32)

    def bstep(beta, inputs):
        e_next, t = inputs
        rec = _lse(log_T[None, :, :] + (e_next + beta)[:, None, :], 2)
        beta_t = jnp.where((t == lengths - 1)[:, None], log_end[None, :],
                           rec)
        return beta_t, beta_t

    ts_rev = jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
    _, bplanes = jax.lax.scan(bstep, bL, (emis[1:][::-1], ts_rev))
    betas = jnp.concatenate([bplanes[::-1], bL[None]], axis=0)
    gamma = alphas + betas - loglik[None, :, None]
    return loglik, gamma


@jax.jit
def posterior_indel_batch(log_T, log_E, log_start, log_end,
                          log_T_del, log_start_del, log_end_del,
                          occ_mask, seqs, lengths):
    """Fused posterior indel statistics (the frameshift posterior).

    Args:
      log_T/log_E/log_start/log_end: sum-closed model (compile_graph_sum),
        -inf pre-cleaned to ~-1e30 (clean_neg)
      log_T_del/log_start_del/log_end_del: the delete-passing closure part
        (log_sub of the full and delete-free closures)
      occ_mask: (n,) float 0/1 — states whose posterior emission occupancy
        to accumulate (repeat-region insert states for frameshift)
      seqs: (B, L) int32 codes; lengths: (B,) int32

    Returns dict:
      loglik          (B,)  forward log-likelihood
      loglik_backward (B,)  backward log-likelihood (conformance cross-check)
      ins_occupancy   (B,)  E[# emissions from occ_mask states]
      del_mass        (B,)  E[# transitions routed through >=1 repeat delete]
    """
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)
    emis = jnp.transpose(jnp.take(log_E, seqs.T, axis=1), (1, 2, 0))
    occ_maskf = occ_mask.astype(log_T.dtype)

    # ---- forward, storing alpha planes (frozen past each read's end) ------
    a0 = log_start[None, :] + emis[0]

    def fstep(v, inputs):
        e_t, t = inputs
        nv = _lse(v[:, :, None] + log_T[None, :, :], 1) + e_t
        nv = jnp.where((t < lengths)[:, None], nv, v)
        return nv, nv

    ts = jnp.arange(1, L, dtype=jnp.int32)
    aF, planes = jax.lax.scan(fstep, a0, (emis[1:], ts))
    alphas = jnp.concatenate([a0[None], planes], axis=0)     # (L, B, n)
    loglik = _lse(aF + log_end[None, :], 1)

    # i -> END closure deletes (aF is frozen at each read's last column)
    end_del = jnp.exp(_lse(aF + log_end_del[None, :], 1) - loglik)

    # ---- backward scan, accumulating occupancy + delete-transition mass ---
    bL = jnp.where((lengths == L)[:, None], log_end[None, :], NEG32)
    occ0 = jnp.where(
        lengths == L,
        jnp.sum(jnp.exp(aF + bL - loglik[:, None]) * occ_maskf[None, :], 1),
        0.0)

    def bstep(carry, inputs):
        beta_next, occ, dmass = carry
        alpha_t, e_next, t = inputs
        # expected delete-routed transitions into column t+1
        m = _lse(alpha_t[:, :, None] + log_T_del[None, :, :], 1)
        d = jnp.sum(jnp.exp(m + e_next + beta_next - loglik[:, None]), 1)
        dmass = dmass + jnp.where(t + 1 < lengths, d, 0.0)
        # beta at column t (re-seeded at each read's own last column)
        rec = _lse(log_T[None, :, :] + (e_next + beta_next)[:, None, :], 2)
        beta_t = jnp.where((t == lengths - 1)[:, None], log_end[None, :],
                           rec)
        # masked posterior occupancy at column t
        g = jnp.exp(alpha_t + beta_t - loglik[:, None])
        occ = occ + jnp.where(
            t < lengths, jnp.sum(g * occ_maskf[None, :], 1), 0.0)
        return (beta_t, occ, dmass), None

    ts_rev = jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
    (beta0, occ, dmass), _ = jax.lax.scan(
        bstep, (bL, occ0, jnp.zeros(B, dtype=log_T.dtype)),
        (alphas[:-1][::-1], emis[1:][::-1], ts_rev))

    loglik_b = _lse(log_start[None, :] + emis[0] + beta0, 1)
    start_del = jnp.exp(
        _lse(log_start_del[None, :] + emis[0] + beta0, 1) - loglik)

    return {
        "loglik": loglik,
        "loglik_backward": loglik_b,
        "ins_occupancy": occ,
        "del_mass": dmass + start_del + end_del,
    }
