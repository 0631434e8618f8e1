"""Baum-Welch EM on the sum-closed model: statistics vs an f64 numpy
oracle, monotone likelihood ascent, and direction cross-check against the
Viterbi-path --update (reference capability: pomegranate/hmm.pyx:2369)."""

import random

import numpy as np
import jax.numpy as jnp

from advntr_tpu.config import Config
from advntr_tpu.models.compiler import compile_graph_sum
from advntr_tpu.models.graph import build_read_matcher
from advntr_tpu.models.profile import profile_for_repeats
from advntr_tpu.ops.baum_welch import baum_welch_fit, baum_welch_stats
from advntr_tpu.ops.posterior import clean_neg
from advntr_tpu import dna


def _tiny_model(pattern="ACGT", copies=2, flank=6, seed=3):
    rng = random.Random(seed)
    left = "".join(rng.choice("ACGT") for _ in range(flank))
    right = "".join(rng.choice("ACGT") for _ in range(flank))
    trans, emis = profile_for_repeats([pattern] * 3, 0.05)
    g = build_read_matcher(left, right, trans, emis, copies, 0.05)
    return g, left, right


def _oracle_counts(log_T, log_E, log_start, log_end, seq):
    """Explicit f64 forward-backward expected counts for ONE read."""
    n = log_T.shape[0]
    L = len(seq)
    T = np.exp(log_T)
    E = np.exp(log_E)
    s0 = np.exp(log_start)
    e0 = np.exp(log_end)
    alpha = np.zeros((L, n))
    alpha[0] = s0 * E[:, seq[0]]
    for t in range(1, L):
        alpha[t] = (alpha[t - 1] @ T) * E[:, seq[t]]
    lik = float(alpha[-1] @ e0)
    beta = np.zeros((L, n))
    beta[-1] = e0
    for t in range(L - 2, -1, -1):
        beta[t] = T @ (E[:, seq[t + 1]] * beta[t + 1])
    xi = np.zeros((n, n))
    for t in range(L - 1):
        xi += np.outer(alpha[t], E[:, seq[t + 1]] * beta[t + 1]) * T / lik
    gamma = alpha * beta / lik
    emit = np.zeros((n, 4))
    for t in range(L):
        emit[:, seq[t]] += gamma[t]
    return np.log(lik), xi, emit, gamma[0], alpha[-1] * e0 / lik


def test_stats_match_f64_oracle():
    g, left, right = _tiny_model()
    log_T, log_E, log_start, log_end = compile_graph_sum(g)
    rng = random.Random(11)
    reads = []
    for _ in range(4):
        s = left + "ACGT" * 2 + right
        s = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                    for c in s)
        reads.append(dna.encode(s))
    batch, lengths = dna.pad_batch(reads, multiple=8)
    dev = tuple(clean_neg(p) for p in (log_T, log_E, log_start, log_end))
    stats = baum_welch_stats(*dev, jnp.asarray(batch), jnp.asarray(lengths))

    xi_sum = np.zeros_like(log_T)
    emit_sum = np.zeros((log_T.shape[0], 4))
    g0_sum = np.zeros(log_T.shape[0])
    gE_sum = np.zeros(log_T.shape[0])
    logliks = []
    for codes in reads:
        ll, xi, emit, gam0, gamE = _oracle_counts(
            log_T, log_E, log_start, log_end, list(codes))
        logliks.append(ll)
        xi_sum += xi
        emit_sum += emit
        g0_sum += gam0
        gE_sum += gamE

    np.testing.assert_allclose(np.asarray(stats["loglik"]), logliks,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats["xi"]), xi_sum,
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats["emit"]), emit_sum,
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats["gamma_start"]), g0_sum,
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats["gamma_end"]), gE_sum,
                               rtol=2e-3, atol=1e-3)


def test_ragged_batch_counts_match_f64_oracle():
    """Reads of different lengths in one padded batch: every read's
    counts stop at its own last column.  Tolerance: float32 exp/log sums
    over <=30 columns against float64 keep ~5 significant digits, so
    rtol=1e-3 with atol=1e-3 for counts near zero; the matrix products run
    at HIGHEST precision, so no TF32 rounding (~3 digits) enters."""
    g, left, right = _tiny_model(pattern="ACGTTG", copies=2, flank=6,
                                 seed=8)
    log_T, log_E, log_start, log_end = compile_graph_sum(g)
    rng = random.Random(4)
    reads = []
    for reps in (1, 2, 2, 1, 2):
        s = left[rng.randint(0, 3):] + "ACGTTG" * reps + \
            right[:rng.randint(2, 6)]
        s = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                    for c in s)
        reads.append(dna.encode(s))
    assert len({len(r) for r in reads}) > 2
    batch, lengths = dna.pad_batch(reads, multiple=8)
    dev = tuple(clean_neg(p) for p in (log_T, log_E, log_start, log_end))
    stats = baum_welch_stats(*dev, jnp.asarray(batch), jnp.asarray(lengths))
    want = [np.zeros_like(log_T), np.zeros((log_T.shape[0], 4)),
            np.zeros(log_T.shape[0]), np.zeros(log_T.shape[0])]
    logliks = []
    for codes in reads:
        ll, *counts = _oracle_counts(log_T, log_E, log_start, log_end,
                                     list(codes))
        logliks.append(ll)
        for acc, c in zip(want, counts):
            acc += c
    np.testing.assert_allclose(np.asarray(stats["loglik"]), logliks,
                               rtol=1e-4, atol=1e-3)
    for key, w in zip(("xi", "emit", "gamma_start", "gamma_end"), want):
        np.testing.assert_allclose(np.asarray(stats[key]), w, rtol=1e-3,
                                   atol=1e-3, err_msg=key)


def test_em_monotone_loglik():
    g, left, right = _tiny_model(pattern="ACGTTG", copies=3, flank=10)
    log_T, log_E, log_start, log_end = compile_graph_sum(g)
    rng = random.Random(5)
    reads = []
    for _ in range(12):
        s = left + "ACGTTG" * rng.choice([2, 3]) + right
        s = "".join(c if rng.random() > 0.08 else rng.choice("ACGT")
                    for c in s)
        reads.append(dna.encode(s))
    batch, lengths = dna.pad_batch(reads, multiple=8)
    _, history = baum_welch_fit(log_T, log_E, log_start, log_end,
                                jnp.asarray(batch), jnp.asarray(lengths),
                                max_iters=6)
    assert len(history) >= 2
    for a, b in zip(history, history[1:]):
        assert b >= a - 1e-2, history   # f32 slack only


def test_em_update_tracks_viterbi_update_direction():
    """A systematic substitution inside the repeat must pull the repeat
    match-state emission toward the substituted base under BOTH update
    mechanisms (EM here; the Viterbi-path --update re-estimates the same
    direction via profile recounting)."""
    from advntr_tpu.engine.finder import VNTRFinder, LocusModelCache
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    from advntr_tpu.models.msa import msa_from_viterbi_paths
    from advntr_tpu.models.profile import profile_from_alignment
    from advntr_tpu.models.compiler import expand_path
    from advntr_tpu.engine import analytics as an

    pattern = "GATCGATTCGAA"
    mutated = "GATCGATTCGTA"   # A->T at position 10
    rng = random.Random(31)
    ref = ReferenceVNTR(90, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = "".join(rng.choice("ACGT")
                                       for _ in range(200))
    ref.right_flanking_region = "".join(rng.choice("ACGT")
                                        for _ in range(200))
    read_length = 100
    finder = VNTRFinder(ref, Config(), model_cache=LocusModelCache())

    hap = (ref.left_flanking_region[-40:] + mutated * 3 +
           ref.right_flanking_region[:40])
    reads = []
    for i in range(10):
        start = rng.randint(0, max(0, len(hap) - read_length))
        reads.append(hap[start:start + read_length])

    out = finder.em_update(reads, read_length, max_iters=3)
    # the substituted base sits at unit position 11 (1-based); those match
    # states are named M11_<unit>
    names = out["names"]
    idxs = [i for i, nm in enumerate(names) if nm.startswith("M11_")]
    assert idxs
    E1 = np.exp(np.asarray(out["log_E"]))
    # after EM, T mass at those states must exceed the original 0.97-A model
    t_mass = float(np.mean(E1[idxs, dna.encode("T")[0]]))
    a_mass = float(np.mean(E1[idxs, dna.encode("A")[0]]))
    assert t_mass > a_mass, (t_mass, a_mass)
    assert out["history"][-1] >= out["history"][0]

    # Viterbi-path update direction: decode reads, re-estimate the profile
    scored, stats = finder.score_reads(
        [(f"r{i}", s) for i, s in enumerate(reads)], [], read_length,
        return_paths=True)
    art = finder.get_model(read_length).art
    seq_vpaths = []
    for read in scored:
        path = stats["path"][read.row][: len(read.sequence)]
        seq_vpaths.append((read.sequence, expand_path(art, path)))
    reps, vps = [], []
    for seq, visited in seq_vpaths:
        r, v = an.extract_repeating_segments(seq, visited)
        reps += r
        vps += v
    alignment = msa_from_viterbi_paths(reps, vps)
    trans, emis = profile_from_alignment(0.05, alignment)
    m11 = emis["M11"]
    assert m11.get("T", 0.0) > m11.get("A", 0.0)


def test_em_update_genotype_stability_vs_viterbi_update():
    """--update --em conformance (round-4 verdict item 8): on a clean
    panel locus, the EM-updated model, the Viterbi-path-updated model,
    and the unchanged model must all genotype identically — model
    re-estimation refines parameters, it must not move a well-supported
    call (reference --update semantics: vntr_finder.py:668-698)."""
    from advntr_tpu.engine.finder import VNTRFinder
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.models.reference_vntr import ReferenceVNTR

    rng = random.Random(17)
    pattern = "CGCGGGGCGGGG"
    left = "".join(rng.choice("ACGT") for _ in range(120))
    right = "".join(rng.choice("ACGT") for _ in range(120))
    ref = ReferenceVNTR(12, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    reads, _, _ = simulate_diploid_reads(left, pattern, 2, 3, right,
                                         read_length=60, coverage=25,
                                         error_rate=0.002, seed=6)
    finder = VNTRFinder(ref, Config())
    plain = finder.find_repeat_count([], reads, read_length=60)
    vit = finder.find_repeat_count([], reads, read_length=60, update=True)
    em = finder.find_repeat_count([], reads, read_length=60, update=True,
                                  em=True)
    assert sorted(plain.copy_numbers) == [2, 3]
    assert sorted(vit.copy_numbers) == sorted(plain.copy_numbers)
    assert sorted(em.copy_numbers) == sorted(plain.copy_numbers)
