#!/usr/bin/env python
"""Panel-scale benchmark: loci genotyped per hour through the FULL pipeline.

Builds a synthetic multi-locus panel (model DB + BAM with per-locus diploid
unmapped reads), then runs the complete GenomeAnalyzer flow — native BAM
streaming, k-mer recruitment over all loci at once, prefetched model
compilation, grouped multi-locus device scoring, genotyping — measuring
end-to-end loci/hour.  Correctness is asserted on every locus.  A second
(warm) pass separates steady-state throughput from one-time compile cost.

Usage: python benchmarks/panel_bench.py [n_loci] [coverage]
"""

import io
import json
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

READ_LEN = 150


def make_panel(n_loci: int):
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    rng = random.Random(1234)
    panel = []
    for i in range(n_loci):
        # Illumina-panel-sized loci: total VNTR length must fit inside one
        # read with flanks on both sides (the reference's Illumina panel is
        # restricted to loci < 140bp, advntr_commands.py:38).  Simulated
        # alleles additionally leave >=20bp of flank anchor per side so a
        # spanning read is physically observable at panel coverage — a
        # 120bp allele vs 150bp reads yields ~1 spanning read at 30x and
        # NO short-read method (the reference included) can call it
        # (locus-1082 diagnosis, git show de509b1:PERF_NOTES.md round 2)
        plen = rng.choice([8, 10, 12, 15, 20, 24])
        max_copies = max(2, (READ_LEN - 40) // plen)
        pattern = "".join(rng.choice("ACGT") for _ in range(plen))
        left = "".join(rng.choice("ACGT") for _ in range(300))
        right = "".join(rng.choice("ACGT") for _ in range(300))
        ref_copies = rng.randint(2, max_copies)
        ref = ReferenceVNTR(1000 + i, pattern, 10_000 * (i + 1), "chr1")
        ref.repeat_segments = [pattern] * ref_copies
        ref.left_flanking_region = left
        ref.right_flanking_region = right
        ref.estimated_repeats = ref_copies
        alleles = tuple(sorted((rng.randint(2, max_copies),
                                rng.randint(2, max_copies))))
        panel.append((ref, alleles))
    return panel


def build_inputs(panel, coverage, workdir):
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.io.bam import BamRead, BamWriter
    from advntr_tpu.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    db_file = os.path.join(workdir, "panel.db")
    create_vntrs_database(db_file)
    bam_file = os.path.join(workdir, "panel.bam")
    with BamWriter(bam_file, ["chr1"], [100_000_000]) as w:
        for i, (ref, alleles) in enumerate(panel):
            save_reference_vntr_to_database(ref, db_file)
            reads, _, _ = simulate_diploid_reads(
                ref.left_flanking_region, ref.pattern, alleles[0],
                alleles[1], ref.right_flanking_region,
                read_length=READ_LEN, coverage=coverage,
                error_rate=0.003, seed=100 + i)
            for name, seq in reads:
                w.write(BamRead(f"L{ref.id}_{name}", 4, -1, -1, 0, [],
                                seq, [38] * len(seq)))
    return db_file, bam_file


def run_pipeline(db_file, bam_file, workdir, config):
    from advntr_tpu.engine.analyzer import GenomeAnalyzer
    from advntr_tpu.models.db import load_unique_vntrs_data
    ref_vntrs = load_unique_vntrs_data(db_file)
    out = io.StringIO()
    analyzer = GenomeAnalyzer(ref_vntrs, [r.id for r in ref_vntrs],
                              workdir + "/", "text", config=config, out=out)
    analyzer.find_repeat_counts_from_alignment_file(bam_file)
    if analyzer.grouped_fallback_vids:
        # a silent fast-path loss once masked a ~10x regression (f4e4ee3);
        # benchmarks must never report a number from the fallback path
        raise RuntimeError(
            f"{len(analyzer.grouped_fallback_vids)} loci fell back from "
            f"grouped device dispatch: {analyzer.grouped_fallback_vids[:20]}")
    lines = out.getvalue().strip().splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 30

    from advntr_tpu.config import Config
    config = Config()
    panel = make_panel(n_loci)
    workdir = tempfile.mkdtemp(prefix="panel_bench_")
    db_file, bam_file = build_inputs(panel, coverage, workdir)
    expected = {str(ref.id): "/".join(map(str, alleles))
                for ref, alleles in panel}

    def accuracy(genotypes):
        ok = sum(1 for vid, want in expected.items()
                 if genotypes.get(vid) == want)
        for vid, want in expected.items():
            if genotypes.get(vid) != want:
                print(f"# locus {vid}: expected {want} "
                      f"got {genotypes.get(vid)}", file=sys.stderr)
        return ok / len(expected)

    def clear_result_checkpoint():
        for name in os.listdir(workdir):
            if name.startswith("results_checkpoint_"):
                os.remove(os.path.join(workdir, name))

    t0 = time.perf_counter()
    genotypes = run_pipeline(db_file, bam_file, workdir, config)
    cold_s = time.perf_counter() - t0
    acc_cold = accuracy(genotypes)

    # warm: model bank + jit executables hot, but results recomputed
    clear_result_checkpoint()
    t0 = time.perf_counter()
    genotypes2 = run_pipeline(db_file, bam_file, workdir, config)
    warm_s = time.perf_counter() - t0
    acc_warm = accuracy(genotypes2)

    print(json.dumps({
        "metric": "panel_loci_genotyped_per_hour",
        "value": round(n_loci / warm_s * 3600, 1),
        "unit": "loci/hour",
        "n_loci": n_loci,
        "accuracy": acc_cold,
        "accuracy_warm": acc_warm,
        "cold_s": round(cold_s, 2),
        "warm_s": round(warm_s, 2),
    }))


if __name__ == "__main__":
    main()
