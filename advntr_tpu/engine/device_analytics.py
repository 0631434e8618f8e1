"""Device-side per-read analytics: everything the genotyper needs, computed
vectorized from the Viterbi traceback without leaving the device.

The reference walks Python lists of state-name strings per read
(hmm_utils.py:155-286).  Here each per-read quantity is a masked gather/
reduction over the (B, L) emitting-state path and compiled metadata tables,
fused behind one jit with the Viterbi kernel, so only O(B) scalars return to
the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from advntr_tpu.models.graph import K_MATCH, R_SUFFIX, R_REPEAT, R_PREFIX  # noqa
from advntr_tpu.ops.viterbi import viterbi_batch, prepare_model_tensors

MIN_BP_IN_REPEAT = 3  # reference: hmm_utils.py:165


@dataclasses.dataclass
class DeviceModel:
    """All per-model tensors the fused genotyping kernel consumes."""
    log_T: jnp.ndarray
    log_E: jnp.ndarray
    log_start: jnp.ndarray
    log_end: jnp.ndarray
    kind: jnp.ndarray          # (n,) int8
    region: jnp.ndarray        # (n,) int8
    exp_base: jnp.ndarray      # (n,) int8
    unit: jnp.ndarray          # (n,) int32

    @classmethod
    def from_artifact(cls, art, dtype=jnp.float32) -> "DeviceModel":
        log_T, log_E, log_start, log_end = prepare_model_tensors(art, dtype)
        return cls(
            log_T=log_T, log_E=log_E, log_start=log_start, log_end=log_end,
            kind=jnp.asarray(art.kind), region=jnp.asarray(art.region),
            exp_base=jnp.asarray(art.exp_base),
            unit=jnp.asarray(art.unit),
        )

    def flat(self):
        return dataclasses.astuple(self)

    @property
    def meta(self):
        return (self.kind, self.region, self.exp_base, self.unit)


@functools.partial(jax.jit, static_argnames=("return_path",))
def read_stats(model_arrays, seqs, lengths, return_path: bool = False):
    """Fused Viterbi + analytics (dense eliminated kernel).

    Args:
      model_arrays: DeviceModel.flat() tuple
      seqs: (B, L) int, lengths: (B,)

    Returns dict of (B,) arrays:
      logp, repeats, n_matches, repeat_bp, left_flank_bp, right_flank_bp,
      left_flank_matches, right_flank_matches (+ path if requested)
    """
    (log_T, log_E, log_start, log_end, kind, region, exp_base,
     unit) = model_arrays
    seqs = seqs.astype(jnp.int32)
    logp, end_state, path = viterbi_batch(log_T, log_E, log_start, log_end,
                                          seqs, lengths, return_path=True)
    return analytics_from_path((kind, region, exp_base, unit), logp, path,
                               seqs, lengths, return_path=return_path)


def analytics_from_path(meta_arrays, logp, path, seqs, lengths,
                        return_path: bool = False):
    """Vectorized per-read statistics from a decoded path (artifact-space
    state indices) + compiled metadata vectors.

    Unit-boundary crossings per hop follow closed-form rules in (region,
    unit, kind) — deletion chains always cost probability, so the
    minimal-crossing silent route wins every argmax; the rules are verified
    against the compiler's exhaustive crossing tables in
    tests/test_crossing_formulas.py.
    """
    (kind, region, exp_base, unit) = meta_arrays
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)

    tpos = jnp.arange(L, dtype=jnp.int32)[None, :]          # (1, L)
    valid = tpos < lengths[:, None]                          # (B, L)

    p_kind = jnp.take(kind, path)
    p_region = jnp.take(region, path)
    p_exp = jnp.take(exp_base, path)
    p_unit = jnp.take(unit, path).astype(jnp.int32)

    is_m = (p_kind == K_MATCH) & valid
    base_match = (p_exp == seqs) & is_m

    def cnt(mask):
        return jnp.sum(mask, axis=1).astype(jnp.int32)

    n_matches = cnt(is_m)
    repeat_bp = cnt((p_region == R_REPEAT) & valid)
    left_bp = cnt((p_region == R_SUFFIX) & valid)
    right_bp = cnt((p_region == R_PREFIX) & valid)
    left_match = cnt(base_match & (p_region == R_SUFFIX))
    right_match = cnt(base_match & (p_region == R_PREFIX))

    # ---- repeat-unit counting (reference: hmm_utils.py:155-188) -----------
    # hop h sits before emitting position h; hop L(ength) is the end hop.
    r_i, r_j = p_region[:, :-1], p_region[:, 1:]
    u_i, u_j = p_unit[:, :-1], p_unit[:, 1:]
    base = jnp.where(r_i == R_REPEAT, u_i, -1)
    starts_rep = u_j - base
    ends_rep = starts_rep - (r_i == R_SUFFIX).astype(jnp.int32)
    hop_us_t = jnp.where(r_j == R_REPEAT, starts_rep,
                         jnp.where((r_j == R_PREFIX) & (r_i == R_SUFFIX),
                                   1, 0))
    hop_ue_t = jnp.where(r_j == R_REPEAT, ends_rep,
                         jnp.where((r_j == R_PREFIX) & (r_i == R_REPEAT), 1,
                                   jnp.where((r_j == R_PREFIX)
                                             & (r_i == R_SUFFIX), 1, 0)))
    hop_us_t = jnp.maximum(hop_us_t, 0)
    hop_ue_t = jnp.maximum(hop_ue_t, 0)
    # start hop: direct entry to a unit-0 match is crossing-free
    j0_region = p_region[:, 0]
    j0_unit = p_unit[:, 0]
    j0_rep = j0_region == R_REPEAT
    j0_unit0_match = j0_rep & (j0_unit == 0) & (p_kind[:, 0] == K_MATCH)
    s_us = jnp.where(j0_rep & ~j0_unit0_match, j0_unit + 1,
                     jnp.where(j0_region == R_PREFIX, 1, 0))
    s_ue = jnp.where(j0_rep & ~j0_unit0_match, j0_unit,
                     jnp.where(j0_region == R_PREFIX, 1, 0))
    hop_us = jnp.concatenate([s_us[:, None], hop_us_t], axis=1)   # (B, L)
    hop_ue = jnp.concatenate([s_ue[:, None], hop_ue_t], axis=1)
    # mask hops past each read: hops 1..length-1 valid, hop 0 always valid
    hop_valid = tpos < lengths[:, None]
    hop_us = jnp.where(hop_valid, hop_us, 0)
    hop_ue = jnp.where(hop_valid, hop_ue, 0)
    # end hop contributes at bp = length: a repeat match exits directly, a
    # repeat insert exits through its unit_end; a suffix exit deletes one
    # whole unit
    last_idx = (lengths - 1)[:, None]
    li_region = jnp.take_along_axis(p_region, last_idx, axis=1)[:, 0]
    li_kind = jnp.take_along_axis(p_kind, last_idx, axis=1)[:, 0]
    end_us = jnp.where(li_region == R_SUFFIX, 1, 0)
    end_ue = jnp.where((li_region == R_REPEAT) & (li_kind != K_MATCH), 1,
                       jnp.where(li_region == R_SUFFIX, 1, 0))

    bp = tpos  # bp count at hop h is h
    guard_start = (lengths[:, None] - bp) >= MIN_BP_IN_REPEAT
    guard_end = bp >= MIN_BP_IN_REPEAT
    cs = jnp.where(guard_start, hop_us, 0)
    ce = jnp.where(guard_end, hop_ue, 0)
    end_guard_start = jnp.zeros_like(end_us)  # length-bp = 0 < 3 always
    end_guard_end = jnp.where(lengths >= MIN_BP_IN_REPEAT, end_ue, 0)

    starts = jnp.sum(cs, axis=1) + end_guard_start
    ends = jnp.sum(ce, axis=1) + end_guard_end

    BIG = jnp.int32(1 << 30)
    hp = jnp.broadcast_to(bp, cs.shape)
    first_start = jnp.min(jnp.where(cs > 0, hp, BIG), axis=1)
    last_start = jnp.max(jnp.where(cs > 0, hp, -BIG), axis=1)
    first_end = jnp.min(jnp.where(ce > 0, hp, BIG), axis=1)
    last_end = jnp.max(jnp.where(ce > 0, hp, -BIG), axis=1)
    # fold the end hop into end positions
    first_end = jnp.where((end_guard_end > 0) & (first_end == BIG),
                          lengths, first_end)
    last_end = jnp.where(end_guard_end > 0, lengths, last_end)

    have_all = ((first_start != BIG) & (last_start != -BIG) &
                (first_end != BIG) & (last_end != -BIG))
    delta = (have_all & (first_end < first_start) &
             (last_start > last_end)).astype(jnp.int32)
    repeats = jnp.maximum(starts, ends) + delta

    out = {
        "logp": logp,
        "repeats": repeats,
        "n_matches": n_matches,
        "repeat_bp": repeat_bp,
        "left_flank_bp": left_bp,
        "right_flank_bp": right_bp,
        "left_flank_matches": left_match,
        "right_flank_matches": right_match,
    }
    if return_path:
        out["path"] = path
    return out


@functools.partial(jax.jit, static_argnames=("return_path",))
def read_stats_struct(struct_arrays, meta_arrays, seqs, lengths,
                      suffix_last, return_path: bool = False):
    """Fused Viterbi + analytics via the structured O(n)-per-step kernel."""
    from advntr_tpu.ops.viterbi_struct import viterbi_struct_batch
    logp, _, path = viterbi_struct_batch(struct_arrays, seqs, lengths,
                                         suffix_last, return_path=True)
    return analytics_from_path(meta_arrays, logp, path, seqs, lengths,
                               return_path=return_path)


@functools.partial(jax.jit, static_argnames=("return_path", "segment"))
def read_stats_struct_ckpt(struct_arrays, meta_arrays, seqs, lengths,
                           suffix_last, return_path: bool = False,
                           segment: int = 512):
    """Fused Viterbi + analytics via the checkpointed (recompute)
    traceback — the memory-safe path for multi-kb lattices."""
    from advntr_tpu.ops.viterbi_ckpt import viterbi_struct_checkpointed
    logp, _, path = viterbi_struct_checkpointed(
        struct_arrays, seqs, lengths, suffix_last, return_path=True,
        segment=segment)
    return analytics_from_path(meta_arrays, logp, path, seqs, lengths,
                               return_path=return_path)


def flank_rates(stats: dict, accuracy_filter: bool = False) -> np.ndarray:
    """min(left, right) flank matching rate per read (host, from counts).

    Reference semantics hmm_utils.py:257-268: an absent flank counts as rate
    1.0 normally (the read simply doesn't span that side) or epsilon under
    the accuracy filter.
    """
    lb = np.asarray(stats["left_flank_bp"], dtype=np.float64)
    rb = np.asarray(stats["right_flank_bp"], dtype=np.float64)
    lm = np.asarray(stats["left_flank_matches"], dtype=np.float64)
    rm = np.asarray(stats["right_flank_matches"], dtype=np.float64)
    default = 0.00001 if accuracy_filter else 1.0
    with np.errstate(invalid="ignore", divide="ignore"):
        lr = np.where(lb > 0, lm / np.maximum(lb, 1), default)
        rr = np.where(rb > 0, rm / np.maximum(rb, 1), default)
    return np.minimum(lr, rr)


@functools.partial(jax.jit, static_argnames=("return_path",))
def read_stats_struct_grouped(stacked_struct, stacked_meta, seqs, lengths,
                              suffix_lasts, return_path: bool = False):
    """Fused Viterbi + analytics for G same-bucket loci in one executable.

    stacked_struct / stacked_meta: per-field stacks with a leading locus
    axis; seqs (G, B, L); lengths (G, B); suffix_lasts (G,).
    Returns dict of (G, B) arrays.
    """
    from advntr_tpu.ops.viterbi_struct import viterbi_struct_batch

    def one(struct, meta, q, ln, sl):
        logp, _, path = viterbi_struct_batch(struct, q, ln, sl,
                                             return_path=True)
        return analytics_from_path(meta, logp, path, q, ln,
                                   return_path=return_path)

    return jax.vmap(one)(stacked_struct, stacked_meta, seqs, lengths,
                         suffix_lasts)
