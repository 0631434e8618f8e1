"""Checkpointed (recompute) traceback: bit-exact vs the plain struct
kernel, conformant vs the f64 oracle, and memory-bounded at PacBio-scale
lattices (SURVEY §7 hard part 5; the reference handles arbitrary n per
read on CPU, pomegranate hmm.pyx:1970-2130)."""

import random

import numpy as np
import pytest
import jax.numpy as jnp

from advntr_tpu import dna
from advntr_tpu.models.compiler import compile_graph
from advntr_tpu.models.graph import build_read_matcher
from advntr_tpu.models.profile import profile_for_repeats
from advntr_tpu.models.struct_compiler import build_structured
from advntr_tpu.ops.viterbi import viterbi_numpy
from advntr_tpu.ops.viterbi_ckpt import viterbi_struct_checkpointed
from advntr_tpu.ops.viterbi_struct import (StructDeviceModel,
                                           viterbi_struct_batch)


def make(pattern_units, left, right, copies, err=0.05):
    trans, emis = profile_for_repeats(pattern_units, err)
    g = build_read_matcher(left, right, trans, emis, copies, err)
    art = compile_graph(g)
    sm = build_structured(g, art)
    dev = StructDeviceModel.from_struct(sm, art)
    return art, sm, dev


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def _run_both(sm, dev, reads, segment):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    ref = viterbi_struct_batch(dev.flat(), jnp.asarray(batch),
                               jnp.asarray(lengths),
                               suffix_last=sm.suffix_last)
    ckpt = viterbi_struct_checkpointed(dev.flat(), jnp.asarray(batch),
                                       jnp.asarray(lengths),
                                       suffix_last=sm.suffix_last,
                                       segment=segment)
    return ref, ckpt


@pytest.mark.parametrize("segment", [3, 64])
def test_ckpt_matches_plain_struct(segment):
    _, sm, dev = make(["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA",
                      "TTACGGAT", 3)
    reads = [
        "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
        "TTGCACAGCAGCAGCAGTTACG",
        "CAGCAGCAGCAGCAACAG",
        "ACGTTGCACAGCTGCAGCAGTTACGGAT",
        "ACGT",
        "A",                       # lengths == 1 edge case
        "TTTTTTTTTTTTTTTTTT",
    ]
    (logp0, end0, path0), (logp1, end1, path1) = _run_both(
        sm, dev, reads, segment)
    # the column math is shared code, so equality is exact, not approximate
    np.testing.assert_array_equal(np.asarray(logp0), np.asarray(logp1))
    np.testing.assert_array_equal(np.asarray(end0), np.asarray(end1))
    np.testing.assert_array_equal(np.asarray(path0), np.asarray(path1))


def test_ckpt_matches_f64_oracle():
    art, sm, dev = make(["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA",
                        "TTACGGAT", 3)
    reads = ["ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
             "ACGTTGCACAGCTGCAGCAGTTACGGAT"]
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    logp, _, path = viterbi_struct_checkpointed(
        dev.flat(), jnp.asarray(batch), jnp.asarray(lengths),
        suffix_last=sm.suffix_last, segment=5)
    logp = np.asarray(logp)
    path = np.asarray(path)
    log_T = np.asarray(art.log_T, dtype=np.float64)
    log_E = np.asarray(art.log_E, dtype=np.float64)
    log_end = np.asarray(art.log_end, dtype=np.float64)
    log_start = np.asarray(art.log_start, dtype=np.float64)
    for b, codes in enumerate(rows):
        ref_logp, _ = viterbi_numpy(art, codes)
        assert logp[b] == pytest.approx(ref_logp, rel=1e-4, abs=1e-2)
        # decoded path rescoring in f64 must reach the optimum
        p = path[b][: len(codes)]
        score = log_start[p[0]] + log_E[p[0], codes[0]]
        for t in range(1, len(codes)):
            score += log_T[p[t - 1], p[t]] + log_E[p[t], codes[t]]
        score += log_end[p[-1]]
        assert score == pytest.approx(ref_logp, rel=1e-6, abs=1e-6)


def test_ckpt_pacbio_scale():
    """P ~ 3000-state lattice x multi-kb read: the shape class the plain
    kernels cannot hold planes for at production batch sizes."""
    # CI-sized stand-in for the full PacBio shape; chip_smoke.py runs the
    # same kernel at the struct P of a 2432-column read and checks it
    # against the unsegmented kernel bit for bit
    pattern = _rand_seq(5, 30)
    copies = 16
    left = _rand_seq(6, 150)
    right = _rand_seq(7, 150)
    _, sm, dev = make([pattern] * 3, left, right, copies, err=0.3)
    rng = random.Random(11)
    hap = left + pattern * 13 + right

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.03:
                continue                      # deletion
            if r < 0.06:
                out.append(rng.choice("ACGT"))  # substitution
            else:
                out.append(ch)
            if rng.random() < 0.03:
                out.append(rng.choice("ACGT"))  # insertion
        return "".join(out)

    reads = [mutate(hap), mutate(hap[100:500])]
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=64)
    assert batch.shape[1] >= 384
    ref = viterbi_struct_batch(dev.flat(), jnp.asarray(batch),
                               jnp.asarray(lengths),
                               suffix_last=sm.suffix_last)
    ckpt = viterbi_struct_checkpointed(dev.flat(), jnp.asarray(batch),
                                       jnp.asarray(lengths),
                                       suffix_last=sm.suffix_last,
                                       segment=128)
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(ckpt[0]))
    np.testing.assert_array_equal(np.asarray(ref[2]), np.asarray(ckpt[2]))


def test_run_device_routes_long_reads(monkeypatch):
    """finder.run_device picks the checkpointed path for long batches."""
    from advntr_tpu.engine import finder as finder_mod
    from advntr_tpu.engine.finder import LocusModelCache

    monkeypatch.setattr(finder_mod, "CKPT_TRACEBACK_L", 64)
    monkeypatch.setattr(finder_mod, "CKPT_SEGMENT", 16)

    trans, emis = profile_for_repeats(["CAGCAG"] * 3, 0.05)
    g = build_read_matcher("ACGTTGCA", "TTACGGAT", trans, emis, 3, 0.05)
    art = compile_graph(g)
    cache = LocusModelCache()
    lm = cache._build(g, art)
    assert lm.struct is not None

    read = "ACGTTGCA" + "CAGCAG" * 3 + "TTACGGAT"
    rows = [dna.encode(read)]
    batch, lengths = dna.pad_batch(rows, pad_to=128, multiple=128)

    class _Finder:
        run_device = finder_mod.VNTRFinder.run_device

    import advntr_tpu.engine.device_analytics as da
    called = {}
    orig = da.read_stats_struct_ckpt

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(da, "read_stats_struct_ckpt", spy)
    stats = _Finder().run_device(lm, batch, lengths)
    assert called.get("yes")
    # same stats as the plain struct path
    plain = da.read_stats_struct(lm.struct.flat(), lm.meta,
                                 jnp.asarray(batch), jnp.asarray(lengths),
                                 lm.suffix_last)
    for key in ("logp", "repeats", "n_matches", "repeat_bp"):
        np.testing.assert_array_equal(stats[key], np.asarray(plain[key]))


def test_ckpt_no_full_read_planes():
    """Memory-shape regression: the checkpointed kernel must never
    materialize a full-read (L, B, P) plane — precomputing the emission
    lattices before the segment scan ran out of device memory at the
    PacBio tract tail (L=P=20480 needed 22 GB for B=2;
    ``git show de509b1:PERF_NOTES.md``, round 5).
    Every intermediate in the traced program must stay below the
    (L-1)*B*P element count of one such lattice."""
    import jax

    _, sm, dev = make(["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA",
                      "TTACGGAT", 6)
    B, L, segment = 4, 512, 64
    rng = random.Random(11)
    reads = ["".join(rng.choice("ACGT") for _ in range(L)) for _ in range(B)]
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, pad_to=L, multiple=8)
    P = sm.P + 1
    budget = (L - 1) * B * P

    jaxpr = jax.make_jaxpr(
        lambda m, s, ln: viterbi_struct_checkpointed(
            m, s, ln, suffix_last=sm.suffix_last, segment=segment)
    )(dev.flat(), jnp.asarray(batch), jnp.asarray(lengths))

    def walk(jx, seen):
        for eqn in jx.eqns:
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if aval is not None and hasattr(aval, "shape"):
                    sz = int(np.prod(aval.shape)) if aval.shape else 1
                    if np.issubdtype(aval.dtype, np.floating):
                        seen.append((sz, aval.shape, eqn.primitive.name))
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (list, tuple)) else [val]):
                    inner = getattr(sub, "jaxpr", None)
                    if inner is not None:
                        walk(inner, seen)
        return seen

    seen = walk(jaxpr.jaxpr, [])
    worst = max(seen)
    assert worst[0] < budget, (
        f"full-read-scale intermediate {worst[1]} ({worst[2]}) >= "
        f"(L-1)*B*P = {budget}")
