"""Tests for auxiliary subsystems: DNN recruitment, coverage bias, SAM
reader, model updating, haplotyper, alignment op, quality gate."""

import numpy as np
import pytest

from advntr_tpu import dna


def test_dnn_recruitment_learns_separation():
    from advntr_tpu.engine import deep_recruitment as dr
    rng = np.random.default_rng(0)
    motif = "CAGCAGTCGATT"
    pos_reads = []
    neg_reads = []
    for _ in range(60):
        pos_reads.append((motif * 10)[: 100])
        neg_reads.append("".join(rng.choice(list("ACGT"), 100)))
    seqs = [dna.encode(s) for s in pos_reads + neg_reads]
    batch, lengths = dna.pad_batch(seqs, multiple=4)
    emb = np.asarray(dr.embed_batch(batch, lengths))
    labels = np.array([1] * 60 + [0] * 60)
    params = dr.train(emb, labels, epochs=3)
    probs = np.asarray(dr.predict(params, emb))
    pred_pos = probs[:60, 0] > probs[:60, 1]
    pred_neg = probs[60:, 0] < probs[60:, 1]
    assert pred_pos.mean() > 0.9
    assert pred_neg.mean() > 0.9


def test_dnn_model_roundtrip(tmp_path):
    from advntr_tpu.engine import deep_recruitment as dr
    import jax
    params = dr.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path / "model.npz")
    dr.save_model(params, path)
    loaded = dr.load_model(path)
    x = np.zeros((2, dr.INPUT_DIM), dtype=np.float32)
    # both sides run the same default-precision products on equal weights,
    # so the outputs agree to float32 rounding (the default rtol=1e-7)
    np.testing.assert_allclose(np.asarray(dr.predict(params, x)),
                               np.asarray(dr.predict(loaded, x)))


def test_coverage_bias_gc_map(tmp_path):
    from advntr_tpu.engine.coverage_bias import (
        CoverageBiasDetector, CoverageCorrector)
    from advntr_tpu.io.bam import BamRead, BamWriter
    # chromosome: first half AT-only (gc bin 0), second half 50% GC (bin 5)
    chrom = "AT" * 2500 + "GGCCATAT" * 625
    bam = str(tmp_path / "cov.bam")
    reads = []
    # AT region at ~10x, GC region at ~20x
    for depth, offset in ((10, 0), (20, 5000)):
        for d in range(depth):
            for start in range(0, 4900, 100):
                reads.append(BamRead(
                    "r%s_%s_%s" % (depth, d, start), 0, 0, offset + start,
                    60, [(0, 100)], "A" * 100, [30] * 100))
    reads.sort(key=lambda r: r.reference_start)
    with BamWriter(bam, ["chr1"], [10000]) as w:
        for r in reads:
            w.write(r)
    det = CoverageBiasDetector(bam, "chr1", {"chr1": chrom})
    gc_map = det.get_gc_content_coverage_map()
    corr = CoverageCorrector(gc_map)
    # note the corrector's epsilon pulls exact bin boundaries down one bin
    # (reference quirk: coverage_bias.py:104-105), so query mid-bin values
    assert corr.get_mean_coverage_of_gc_content(0.05) == pytest.approx(10, abs=1)
    assert corr.get_mean_coverage_of_gc_content(0.55) == pytest.approx(20, abs=1)

    class FakeVNTR:
        def get_repeat_segments(self):
            return ["GGGGGGGGGGG" + "ATATATATA"]  # 11/20 GC -> bin 5
    scaled = corr.get_scaled_coverage(FakeVNTR(), 20.0)
    assert scaled == pytest.approx(15, abs=2)  # 20 * (15/20)


def test_sam_reader(tmp_path):
    from advntr_tpu.io.sam import SamReader, open_alignment
    path = str(tmp_path / "x.sam")
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        fh.write("@SQ\tSN:chr1\tLN:10000\n")
        fh.write("r1\t0\tchr1\t101\t60\t4M\t*\t0\t0\tACGT\tIIII\n")
        fh.write("r2\t4\t*\t0\t0\t*\t*\t0\t0\tGGGG\tIIII\n")
    r = SamReader(path)
    assert r.references == ["chr1"]
    recs = list(r)
    assert recs[0].query_name == "r1"
    assert recs[0].reference_start == 100
    assert recs[0].seq == "ACGT"
    assert recs[0].qual == [40, 40, 40, 40]
    assert recs[1].is_unmapped
    assert [x.query_name for x in r.fetch("chr1", 90, 200)] == ["r1"]
    assert [x.query_name for x in r.fetch_unmapped()] == ["r2"]
    assert isinstance(open_alignment(path), SamReader)


def test_haplotyper_two_clusters():
    from advntr_tpu.engine.haplotyper import PacBioHaplotyper
    a = "ACGTACGTACGTAAATTTGGG"
    b = "ACGTACCTACGTAAATTTCCC"
    reads = [a, a, b, b, a, b]
    hap = PacBioHaplotyper(reads)
    haps = hap.get_error_corrected_haplotypes()
    assert sorted(haps) == sorted([a, b])


def _rand_seq(seed, n):
    import random
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def test_update_model_reselects():
    from advntr_tpu.config import Config
    from advntr_tpu.engine.finder import VNTRFinder
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    pattern = "CGCGGGGCGGGG"
    left = _rand_seq(1, 120)
    right = _rand_seq(2, 120)
    ref = ReferenceVNTR(11, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    finder = VNTRFinder(ref, Config())
    reads, _, _ = simulate_diploid_reads(left, pattern, 3, 3, right,
                                         read_length=60, coverage=15,
                                         error_rate=0.0, seed=4)
    result = finder.find_repeat_count([], reads, read_length=60, update=True)
    assert result.copy_numbers == (3, 3)


def test_quality_gate():
    from advntr_tpu.utils.quality import is_low_quality_read
    good = [35] * 150
    assert not is_low_quality_read(60, good)
    assert is_low_quality_read(0, good)          # mapq <= cutoff
    many_low = [35] * 130 + [10] * 20
    assert is_low_quality_read(60, many_low)     # >=10% low-quality bases
