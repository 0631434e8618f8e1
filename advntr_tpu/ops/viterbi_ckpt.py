"""Checkpointed (recompute) Viterbi traceback for long lattices.

The plain struct kernel materializes per-column planes for the whole read:
(L, B, 2P+nb) f32 value planes.  At PacBio scale (L ~ 10kb+, P ~ 3000)
those planes outgrow device memory (SURVEY §7 hard part 5; the reference
CPU kernel handles arbitrary n per read, pomegranate hmm.pyx:1970-2130,
because its traceback matrix lives in host RAM).

This module trades FLOPs for memory with the classic two-pass scheme:

1. forward pass over ``n_seg`` segments of ``K`` columns each, storing
   ONLY the DP carry (M, I, I0, D, hub — (B, ~3P) floats) at each segment
   start: (L/K, B, ~3P) total instead of (L, B, ~3P);
2. backward pass walking segments in reverse: each segment re-runs its
   forward from the checkpointed carry — this time materializing its K
   value planes — and argmax-decodes its slice of the path before the
   next segment's planes replace them.

Peak plane memory drops from O(L·B·P) to O(K·B·P) + O(L/K·B·P); K ~
sqrt(L) gives the standard O(sqrt) memory Viterbi.  Forward work doubles:
the trade is worth it where device memory, not arithmetic, binds.

Exactness: the per-column math IS viterbi_struct.forward_step /
silent_layer — shared functions, not copies — so scores, paths and
analytics are bit-identical to the unsegmented kernel (tested), which is
itself conformance-locked to the f64 oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from advntr_tpu.ops.viterbi_struct import (StructDeviceModel,
                                           forward_step, initial_column,
                                           struct_plane)


def _segment_emissions(m, codes):
    """Per-segment emission planes from raw 2-bit codes: (K, B) ->
    three (K, B, P*) f32 stacks.  Gathering INSIDE the segment keeps the
    largest live emission plane at O(K·B·P) — precomputing them for the
    whole read (the pre-round-5 layout) materialized three (L, B, P)
    planes before the scan, which at the PacBio tract tail (L=P=20k)
    alone exceeded device memory (measured: 22 GB for B=2)."""
    eM = jnp.transpose(jnp.take(m.eM, codes, axis=1), (1, 2, 0))
    eI = jnp.transpose(jnp.take(m.eI, codes, axis=1), (1, 2, 0))
    eI0 = jnp.transpose(jnp.take(m.eI0, codes, axis=1), (1, 2, 0))
    return eM, eI, eI0


def _forward_segment(m, suffix_last, lengths, carry, codes, ts,
                     store_planes: bool):
    """Run one segment of forward columns from ``carry``; optionally keep
    the per-column value planes (pass 2) or drop them (pass 1)."""
    step = functools.partial(forward_step, m, suffix_last, lengths)
    ems = _segment_emissions(m, codes)
    if store_planes:
        return jax.lax.scan(step, carry, ems + (ts,))
    new_carry, _ = jax.lax.scan(
        lambda c, x: (step(c, x)[0], None), carry, ems + (ts,))
    return new_carry, None


@functools.partial(jax.jit, static_argnames=("return_path", "segment"))
def viterbi_struct_checkpointed(model_arrays, seqs, lengths, suffix_last,
                                return_path: bool = True,
                                segment: int = 512):
    """Two-pass struct Viterbi: same contract as viterbi_struct_batch,
    O(K·B·P + (L/K)·B·P) plane memory instead of O(L·B·P).

    Both passes are a single ``lax.scan`` over segments (inner scan over
    the K columns of each segment), so the compiled program size is
    independent of the number of segments — the round-2 version unrolled a
    host loop per segment and paid ~110s compiles at PacBio shapes."""
    m = StructDeviceModel(*model_arrays)
    B, L = seqs.shape
    seqs = seqs.astype(jnp.int32)

    eM0, eI0_, eI00 = _segment_emissions(m, seqs[None, :, 0])
    carry0 = initial_column(m, suffix_last, eM0[0], eI0_[0], eI00[0])

    n_steps = L - 1
    if n_steps == 0:
        _, _, _, _, _, best = carry0
        if not return_path:
            return best, None, None
        Mf, If, I0f = carry0[0], carry0[1], carry0[2]
        final_plane = struct_plane(Mf, If, I0f)
        end_state_s = jnp.argmax(final_plane + m.log_end_struct[None, :],
                                 axis=1).astype(jnp.int32)
        path = jnp.take(m.struct_to_art, end_state_s[:, None])
        return best, jnp.take(m.struct_to_art, end_state_s), path

    K = max(1, min(segment, n_steps))
    n_seg = -(-n_steps // K)
    pad = n_seg * K - n_steps

    # (n_steps, B) code columns -> (n_seg, K, B); padded columns carry
    # t >= L so the length freeze makes them no-ops for every read
    # (pad code 0 is a valid symbol — its emission value is never used)
    codes_all = seqs.T[1:]
    if pad:
        codes_all = jnp.concatenate(
            [codes_all, jnp.zeros((pad, B), codes_all.dtype)], axis=0)
    codes_seg = codes_all.reshape(n_seg, K, B)
    ts_all = jnp.arange(1, n_seg * K + 1, dtype=jnp.int32)
    ts_seg = ts_all.reshape(n_seg, K)

    # ---- pass 1: forward, checkpoint segment-entry carries ---------------
    def seg_fwd(carry, xs):
        codes, ts = xs
        new_carry, _ = _forward_segment(m, suffix_last, lengths, carry,
                                        codes, ts, store_planes=False)
        return new_carry, carry          # emit the ENTRY carry

    carry_f, checkpoints = jax.lax.scan(seg_fwd, carry0,
                                        (codes_seg, ts_seg))
    Mf, If, I0f, _, _, best = carry_f
    if not return_path:
        return best, None, None

    final_plane = struct_plane(Mf, If, I0f)
    end_state_s = jnp.argmax(final_plane + m.log_end_struct[None, :],
                             axis=1).astype(jnp.int32)

    # ---- pass 2: reverse scan over segments: recompute planes, walk back -
    def back_step(cur, inputs):
        v_prev, t = inputs
        prev = jnp.argmax(v_prev + jnp.take(m.log_T_struct_t, cur, axis=0),
                          axis=1).astype(jnp.int32)
        new_cur = jnp.where(t <= lengths - 1, prev, cur)
        return new_cur, cur

    def seg_bwd(cur, xs):
        ckpt, codes, ts = xs
        _, v_planes = _forward_segment(m, suffix_last, lengths, ckpt,
                                       codes, ts, store_planes=True)
        # reverse inner scan: ys[i] stays aligned with column ts[i]
        cur, emitted = jax.lax.scan(back_step, cur, (v_planes, ts),
                                    reverse=True)
        return cur, emitted              # (K, B) forward-ordered

    cur_final, seg_paths = jax.lax.scan(
        seg_bwd, end_state_s, (checkpoints, codes_seg, ts_seg),
        reverse=True)
    flat = seg_paths.reshape(n_seg * K, B)[:n_steps]       # (n_steps, B)
    path_s = jnp.concatenate([cur_final[:, None], flat.T], axis=1)
    path_s = jnp.where((lengths == 1)[:, None],
                       jnp.broadcast_to(end_state_s[:, None], path_s.shape),
                       path_s)
    path = jnp.take(m.struct_to_art, path_s)
    end_state = jnp.take(m.struct_to_art, end_state_s)
    return best, end_state, path
