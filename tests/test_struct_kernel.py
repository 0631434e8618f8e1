"""The structured kernel as the one device decode path: scores and decoded
paths against the float64 full-graph oracle and the dense numpy Viterbi,
the analyzer's grouped dispatch on its shape key, and finder.run_device's
routing to the checkpointed twin for long reads."""

import random

import numpy as np
import pytest
import jax.numpy as jnp

from advntr_tpu import dna
from advntr_tpu.engine import device_analytics as da
from advntr_tpu.models.compiler import (compile_graph, expand_path,
                                        score_visited_path,
                                        viterbi_full_graph)
from advntr_tpu.models.graph import build_read_matcher
from advntr_tpu.models.profile import profile_for_repeats
from advntr_tpu.models.struct_compiler import build_structured, pad_structured
from advntr_tpu.ops.viterbi import viterbi_numpy
from advntr_tpu.ops.viterbi_struct import StructDeviceModel

# float32 max-plus sums over a read of <=60 columns vs float64: the decoded
# path's f64 score and the f64 optimum agree with the device score to 1e-3
TOL = 1e-3

CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["CGCGGGGCGGGG"] * 3, "ACGTACTGACGATCGATT", "TTACGGATGCAGTACGTA", 5),
]

READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "CAGCAGCAGCAGCAACAG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
    "ACGTTGCACAGAGCAGCAGTTACGGAT",
    "ACGTTGCACAGGCAGCAGCAGTTACGGAT",
    "ACGTACTGACGATCGATTCGCGGGGCGGGGCGCGGGGCGGGGTTACGGATGCAGTACGTA",
    "GGGGCGGGGCGCGGGGCG",
    "ACGT",
    "TTTTTTTTTTTTTTTTTT",
]


def make(pattern_units, left, right, copies, err=0.05):
    trans, emis = profile_for_repeats(pattern_units, err)
    g = build_read_matcher(left, right, trans, emis, copies, err)
    art = compile_graph(g)
    sm = build_structured(g, art)
    sm = pad_structured(sm, art, ((sm.P + 63) // 64) * 64,
                        ((sm.C + 7) // 8) * 8)
    return g, art, sm, StructDeviceModel.from_struct(sm, art)


def struct_stats(art, sm, dev, reads):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    meta = (jnp.asarray(art.kind), jnp.asarray(art.region),
            jnp.asarray(art.exp_base), jnp.asarray(art.unit))
    out = da.read_stats_struct(dev.flat(), meta, jnp.asarray(batch),
                               jnp.asarray(lengths), sm.suffix_last,
                               return_path=True)
    return rows, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", CASES)
def test_struct_matches_f64_full_graph(case):
    g, art, sm, dev = make(*case)
    rows, out = struct_stats(art, sm, dev, READS)
    for b, codes in enumerate(rows):
        oracle, _ = viterbi_full_graph(g, codes)
        if not np.isfinite(oracle):
            assert out["logp"][b] < -1e20, READS[b]
            continue
        assert out["logp"][b] == pytest.approx(oracle, abs=TOL), READS[b]
        visited = expand_path(art, out["path"][b][: len(codes)])
        assert score_visited_path(g, visited, codes) == \
            pytest.approx(oracle, abs=TOL), READS[b]


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def test_struct_random_soak_vs_viterbi_numpy():
    rng = random.Random(20240817)
    for trial in range(4):
        err = rng.choice([0.05, 0.3])
        plen = rng.choice([5, 11])
        pattern = _rand_seq(rng, plen)
        units = []
        for _ in range(3):
            u = list(pattern)
            if rng.random() < 0.5:
                u[rng.randrange(plen)] = rng.choice("ACGT")
            units.append("".join(u))
        left = _rand_seq(rng, rng.choice([12, 20]))
        right = _rand_seq(rng, rng.choice([12, 20]))
        copies = rng.choice([3, 5])
        g, art, sm, dev = make(units, left, right, copies, err)
        reads = []
        for _ in range(12):
            hap = left + pattern * rng.randint(1, copies + 2) + right
            kind = rng.random()
            if kind < 0.5:
                a = rng.randint(0, max(0, len(hap) - 15))
                read = hap[a:rng.randint(a + 10, len(hap))]
            elif kind < 0.7:
                read = _rand_seq(rng, rng.randint(10, 60))
            else:
                read = hap
            chars = list(read)
            for _ in range(rng.randint(0, 3)):
                chars[rng.randrange(len(chars))] = rng.choice("ACGT")
            reads.append("".join(chars))
        rows, out = struct_stats(art, sm, dev, reads)
        for b, codes in enumerate(rows):
            ref_logp, ref_path = viterbi_numpy(art, codes)
            if not np.isfinite(ref_logp) or ref_logp < -1e20:
                assert out["logp"][b] < -1e20, (trial, reads[b])
                continue
            assert out["logp"][b] == pytest.approx(ref_logp, abs=TOL), \
                (trial, reads[b])
            # the decoded path is optimal: its f64 score is the optimum
            path = out["path"][b][: len(codes)]
            s = (art.log_start[path[0]] + art.log_E[path[0], codes[0]]
                 + sum(art.log_T[path[t - 1], path[t]]
                       + art.log_E[path[t], codes[t]]
                       for t in range(1, len(codes)))
                 + art.log_end[path[-1]])
            assert float(s) == pytest.approx(ref_logp, abs=TOL), \
                (trial, reads[b])


def _panel_bam(tmp_path, refs_alleles, read_length=100, coverage=30):
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.io.bam import BamRead, BamWriter
    bam_path = str(tmp_path / "s.bam")
    with BamWriter(bam_path, ["chr1"], [100000]) as w:
        for i, (ref, (a, b)) in enumerate(refs_alleles):
            reads, _, _ = simulate_diploid_reads(
                ref.left_flanking_region, ref.pattern, a, b,
                ref.right_flanking_region, read_length=read_length,
                coverage=coverage, error_rate=0.002, seed=9 + i)
            for name, seq in reads:
                w.write(BamRead(f"{ref.id}_{name}", 4, -1, -1, 0, [], seq,
                                [38] * len(seq)))
    return bam_path


def test_analyzer_grouped_dispatch_struct_key(monkeypatch, tmp_path):
    """Two loci in two shape buckets go through the grouped struct
    executable (one dispatch per bucket) with no per-locus fallback."""
    import io
    from advntr_tpu.config import Config
    from advntr_tpu.engine.analyzer import GenomeAnalyzer
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    from advntr_tpu.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "panel_mesh", lambda *a, **kw: None)
    rng = random.Random(13)
    refs_alleles = []
    for vid, pattern, alleles in ((56, "GATCGATTCGAA", (2, 4)),
                                  (57, "CAGGT", (3, 5))):
        ref = ReferenceVNTR(vid, pattern, 1000 * vid, "chr1")
        ref.repeat_segments = [pattern] * 3
        ref.left_flanking_region = _rand_seq(rng, 200)
        ref.right_flanking_region = _rand_seq(rng, 200)
        refs_alleles.append((ref, alleles))
    bam_path = _panel_bam(tmp_path, refs_alleles)

    calls = []
    orig = da.read_stats_struct_grouped

    def spy(stacked, meta, seqs, *a, **kw):
        calls.append(tuple(x.shape for x in stacked + meta))
        return orig(stacked, meta, seqs, *a, **kw)

    monkeypatch.setattr(da, "read_stats_struct_grouped", spy)
    buf = io.StringIO()
    analyzer = GenomeAnalyzer([r for r, _ in refs_alleles], [56, 57],
                              str(tmp_path / "w") + "/", "text",
                              config=Config(), out=buf, input_file=bam_path)
    analyzer.find_repeat_counts_from_alignment_file(bam_path)
    assert analyzer.grouped_fallback_vids == []
    assert len(calls) == 2 and calls[0] != calls[1], calls
    assert buf.getvalue().strip().splitlines() == ["56", "2/4", "57", "3/5"]


@pytest.mark.parametrize("ckpt_l,expect", [(4096, "read_stats_struct"),
                                           (64, "read_stats_struct_ckpt")])
def test_run_device_routing(monkeypatch, ckpt_l, expect):
    """Reads at or below CKPT_TRACEBACK_L take the struct kernel, longer
    ones its checkpointed twin; both give identical stats."""
    from advntr_tpu.config import Config
    from advntr_tpu.engine import finder as finder_mod
    from advntr_tpu.engine.finder import LocusModelCache, VNTRFinder
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.models.reference_vntr import ReferenceVNTR

    rng = random.Random(7)
    pattern = "CCGTAGATCGGA"
    ref = ReferenceVNTR(5, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = _rand_seq(rng, 200)
    ref.right_flanking_region = _rand_seq(rng, 200)
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, pattern, 2, 4, ref.right_flanking_region,
        read_length=90, coverage=4, error_rate=0.01, seed=3)
    finder = VNTRFinder(ref, Config(), model_cache=LocusModelCache())
    lm = finder.get_model(90)
    _, rows, _ = finder.prepare_rows([], reads)
    batch, lengths = finder.pad_rows(rows)
    assert batch.shape[1] == 96
    reference = finder.run_device(lm, batch, lengths, return_paths=True)

    used = []
    for name in ("read_stats_struct", "read_stats_struct_ckpt"):
        orig = getattr(da, name)
        monkeypatch.setattr(
            da, name, lambda *a, _o=orig, _n=name, **kw:
            used.append(_n) or _o(*a, **kw))
    monkeypatch.setattr(finder_mod, "CKPT_TRACEBACK_L", ckpt_l)
    monkeypatch.setattr(finder_mod, "CKPT_SEGMENT", 16)
    stats = finder.run_device(lm, batch, lengths, return_paths=True)
    assert used == [expect]
    assert set(stats) == set(reference)
    for k in stats:
        np.testing.assert_array_equal(stats[k], reference[k], err_msg=k)
