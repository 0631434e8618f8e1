"""Batched log-space Viterbi over compiled (silent-free) HMMs.

Replaces the reference's per-read sparse-graph Cython DP
(pomegranate/hmm.pyx:1970-2130) with dense max-plus dynamic programming:

- ``viterbi_numpy``: float64 host implementation (conformance oracle and
  small-scale fallback).
- ``viterbi_batch``: JAX implementation — ``lax.scan`` over sequence
  positions, batched over reads; traceback from stored argmax planes.
  All shapes static; variable read lengths handled by masking/latching, so
  one compiled executable serves a whole (n_states, max_len) bucket.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

NEG32 = np.float32(-1e30)


def viterbi_numpy(art, codes: np.ndarray):
    """Single-read float64 Viterbi over a compiled artifact.

    Returns (logp, path) where path is the emitting-state index sequence.
    """
    log_T, log_E = art.log_T, art.log_E
    n = art.n_states
    L = len(codes)
    v = art.log_start + log_E[:, codes[0]]
    args = np.zeros((L, n), dtype=np.int32)
    for t in range(1, L):
        scores = v[:, None] + log_T
        args[t] = np.argmax(scores, axis=0)
        v = scores[args[t], np.arange(n)] + log_E[:, codes[t]]
    final = v + art.log_end
    end_state = int(np.argmax(final))
    logp = final[end_state]
    if not np.isfinite(logp):
        return float(logp), None
    path = np.zeros(L, dtype=np.int32)
    cur = end_state
    for t in range(L - 1, -1, -1):
        path[t] = cur
        if t > 0:
            cur = args[t][cur]
    return float(logp), path


# ---------------------------------------------------------------------------
# JAX batched kernel
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("return_path",))
def viterbi_batch(log_T, log_E, log_start, log_end, seqs, lengths,
                  return_path: bool = True):
    """Batched Viterbi.

    Structure: the forward scan performs ONE fused
    broadcast+max reduction per symbol (no argmax, no gathers) and stores
    the value planes; the traceback re-derives each argmax on the single
    visited state per step — O(n) instead of O(n^2) — from the stored
    planes.  This keeps the forward pass at one streaming pass over
    (B, n, n) per step and avoids materializing (L, B, n) argmax tensors.

    Args:
      log_T: (n, n) float32 effective transitions (log), -inf -> use ~-1e30
      log_E: (n, 4) float32 emissions (log)
      log_start, log_end: (n,) float32
      seqs: (B, L) int32 in [0,4) (padding value arbitrary in [0,4))
      lengths: (B,) int32 true read lengths (>=1)
      return_path: also run traceback and return (B, L) int32 state paths

    Returns: (logp (B,), end_state (B,), path (B, L) or None)
    """
    B, L = seqs.shape
    n = log_T.shape[0]
    seqs = seqs.astype(jnp.int32)

    emis = jnp.take(log_E, seqs.T, axis=1)          # (n, L, B)
    emis = jnp.transpose(emis, (1, 2, 0))           # (L, B, n)

    v0 = log_start[None, :] + emis[0]               # (B, n)
    finals0 = jnp.max(v0 + log_end[None, :], axis=1)

    def step(carry, inputs):
        v, best = carry
        emis_t, t = inputs
        # new_v[b, j] = max_i v[b, i] + T[i, j]  (single fused reduction)
        new_v = jnp.max(v[:, :, None] + log_T[None, :, :], axis=1) + emis_t
        active = (t < lengths)[:, None]
        new_v = jnp.where(active, new_v, v)
        fin = jnp.max(new_v + log_end[None, :], axis=1)
        best = jnp.where(t == lengths - 1, fin, best)
        return (new_v, best), v

    ts = jnp.arange(1, L, dtype=jnp.int32)
    (vF, best), v_planes = jax.lax.scan(step, (v0, finals0), (emis[1:], ts))
    # v_planes[k] = values at column k (0-based symbol index), k = 0..L-2;
    # vF = values at column L-1 (frozen at each read's own last column)

    if not return_path:
        return best, None, None

    # ---- traceback by argmax re-derivation -------------------------------
    # end state: argmax_j vF[j] + log_end[j]; vF is frozen at column
    # lengths-1 for each read, so it is each read's own final column.
    end_state = jnp.argmax(vF + log_end[None, :], axis=1).astype(jnp.int32)

    log_T_t = log_T.T  # (j, i): row j = in-edge weights of state j

    def back_step(cur, inputs):
        v_prev, t = inputs
        # moving from column t to t-1: prev = argmax_i v_prev[i] + T[i, cur]
        prev = jnp.argmax(v_prev + jnp.take(log_T_t, cur, axis=0),
                          axis=1).astype(jnp.int32)
        active = (t <= lengths - 1)
        new_cur = jnp.where(active, prev, cur)
        return new_cur, cur

    ts_rev = jnp.arange(L - 1, 0, -1, dtype=jnp.int32)
    cur_last, emitted = jax.lax.scan(
        back_step, end_state, (v_planes[::-1], ts_rev))
    # emitted[k] = state at column L-1-k when that column <= read's last;
    # but frozen columns emit end_state repeatedly, which is fine because
    # positions >= length are ignored downstream.
    path = jnp.concatenate([cur_last[:, None], emitted[::-1].T], axis=1)
    path = jnp.where((lengths == 1)[:, None],
                     jnp.broadcast_to(end_state[:, None], path.shape), path)
    return best, end_state, path


@jax.jit
def forward_batch(log_T, log_E, log_start, log_end, seqs, lengths):
    """Batched forward algorithm (log-likelihood) over sum-closed matrices
    from compile_graph_sum.  Same masking/latching scheme as viterbi_batch
    but with log-sum-exp accumulation.  Returns loglik (B,)."""
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)
    emis = jnp.transpose(jnp.take(log_E, seqs.T, axis=1), (1, 2, 0))

    def lse(x, axis):
        mx = jnp.max(x, axis=axis)
        return mx + jnp.log(jnp.sum(jnp.exp(x - jnp.expand_dims(mx, axis)),
                                    axis=axis))

    v0 = log_start[None, :] + emis[0]
    best0 = lse(v0 + log_end[None, :], 1)

    def step(carry, inputs):
        v, best = carry
        emis_t, t = inputs
        new_v = lse(v[:, :, None] + log_T[None, :, :], 1) + emis_t
        active = (t < lengths)[:, None]
        new_v = jnp.where(active, new_v, v)
        fin = lse(new_v + log_end[None, :], 1)
        best = jnp.where(t == lengths - 1, fin, best)
        return (new_v, best), None

    ts = jnp.arange(1, L, dtype=jnp.int32)
    (_, best), _ = jax.lax.scan(step, (v0, best0), (emis[1:], ts))
    return best


def prepare_model_tensors(art, dtype=jnp.float32):
    """Convert a ModelArtifact's -inf entries to a large negative finite value
    (f32-safe) and upload as device arrays."""
    def clean(x):
        x = np.asarray(x, dtype=np.float64)
        x = np.where(np.isfinite(x), x, np.float64(NEG32))
        return jnp.asarray(x, dtype=dtype)
    return (clean(art.log_T), clean(art.log_E),
            clean(art.log_start), clean(art.log_end))
