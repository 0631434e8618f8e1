#!/usr/bin/env python
"""PacBio panel benchmark: the BASELINE config-#3 workload shape.

Builds a synthetic multi-locus PacBio panel (model DB + FASTA of noisy
multi-kb reads: 1% substitutions, 4% insertions, 4% deletions, both
orientations), then runs the complete long-read pipeline — 80bp-flank
keyword recruitment, batched flank anchoring + window trimming, max-copies
HMM Viterbi over the trimmed windows, accuracy-filtered RU histograms,
diploid ML genotyping — measuring end-to-end loci/hour.  A --naive subset
exercises the haplotyper (MSA -> clustering -> consensus decode).
Correctness is asserted per locus; a second (warm) pass separates
steady-state throughput from one-time compile cost.

Reference workload: advntr genotype --pacbio over the 8,960-locus DB
(/root/reference/advntr/vntr_finder.py:534-665, genome_analyzer.py:210-234).

Usage: python benchmarks/pacbio_panel_bench.py [n_loci] [coverage] [--naive]
"""

import io
import json
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

READ_LEN = 3000


def make_panel(n_loci: int, long_every: int = 12):
    """Mixed-tract-length PacBio panel.  Most loci carry tracts up to ~1kb
    (the reference's PacBio DB has no <140bp restriction); every
    ``long_every``-th locus is a LONG-tract locus (~2.3-2.9kb), whose
    trimmed decode window exceeds finder.CKPT_TRACEBACK_L=2048 and therefore
    routes through the checkpointed long-lattice kernel inside the panel
    (the reference decodes these with the same unbounded-n host DP,
    hmm.pyx:1970-2130)."""
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    rng = random.Random(777)
    panel = []
    for i in range(n_loci):
        is_long = long_every > 0 and i % long_every == 7
        if is_long:
            plen = rng.choice([20, 25, 30])
            target_bp = rng.randint(2300, 2900)
            ref_copies = max(3, target_bp // plen)
            lo, hi = ref_copies - 3, ref_copies + 3
        else:
            plen = rng.choice([10, 15, 20, 25, 30, 40])
            ref_copies = rng.randint(3, max(3, min(30, 1000 // plen)))
            lo, hi = 3, max(3, min(30, 1000 // plen))
        pattern = "".join(rng.choice("ACGT") for _ in range(plen))
        left = "".join(rng.choice("ACGT") for _ in range(500))
        right = "".join(rng.choice("ACGT") for _ in range(500))
        ref = ReferenceVNTR(2000 + i, pattern, 10_000 * (i + 1), "chr1")
        ref.repeat_segments = [pattern] * ref_copies
        ref.left_flanking_region = left
        ref.right_flanking_region = right
        ref.estimated_repeats = ref_copies
        alleles = tuple(sorted((rng.randint(lo, hi), rng.randint(lo, hi))))
        panel.append((ref, alleles))
    return panel


def build_inputs(panel, coverage, workdir):
    from advntr_tpu.engine.simulate import simulate_pacbio_reads
    from advntr_tpu.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    db_file = os.path.join(workdir, "panel.db")
    create_vntrs_database(db_file)
    fa_file = os.path.join(workdir, "reads.fa")
    with open(fa_file, "w") as fh:
        for i, (ref, alleles) in enumerate(panel):
            save_reference_vntr_to_database(ref, db_file)
            # long-tract loci need reads that still span the tract plus
            # both flank anchors
            tract = max(alleles) * len(ref.pattern)
            read_len = max(READ_LEN, tract + 1200)
            reads, _, _ = simulate_pacbio_reads(
                ref.left_flanking_region, ref.pattern, alleles[0],
                alleles[1], ref.right_flanking_region,
                read_length=read_len, coverage=coverage, seed=900 + i)
            for name, seq in reads:
                fh.write(f">L{ref.id}_{name}\n{seq}\n")
    return db_file, fa_file


def run_pipeline(db_file, fa_file, workdir, config, naive, accuracy_filter):
    from advntr_tpu.engine.analyzer import GenomeAnalyzer
    from advntr_tpu.models.db import load_unique_vntrs_data
    ref_vntrs = load_unique_vntrs_data(db_file)
    out = io.StringIO()
    analyzer = GenomeAnalyzer(ref_vntrs, [r.id for r in ref_vntrs],
                              workdir + "/", "text", config=config, out=out)
    analyzer.find_repeat_counts_from_pacbio_reads(
        fa_file, accuracy_filter=accuracy_filter, naive=naive)
    lines = out.getvalue().strip().splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 10
    naive = "--naive" in sys.argv
    accuracy_filter = "--accuracy_filter" in sys.argv

    from advntr_tpu.config import Config
    config = Config().with_platform(pacbio=True)
    panel = make_panel(n_loci)
    workdir = tempfile.mkdtemp(prefix="pacbio_bench_")
    print(f"# workdir {workdir}", file=sys.stderr)
    db_file, fa_file = build_inputs(panel, coverage, workdir)
    expected = {str(ref.id): "/".join(map(str, alleles))
                for ref, alleles in panel}
    # long-tract loci (decode window > 2048 -> ckpt kernel routing)
    long_vids = {str(ref.id) for ref, alleles in panel
                 if max(alleles) * len(ref.pattern) > 2048}
    print(f"# {len(long_vids)} long-tract loci (ckpt-routed): "
          f"{sorted(long_vids)}", file=sys.stderr)

    def accuracy(genotypes):
        ok = sum(1 for vid, want in expected.items()
                 if genotypes.get(vid) == want)
        mismatches = []
        for vid, want in expected.items():
            if genotypes.get(vid) != want:
                mismatches.append((vid, want, genotypes.get(vid)))
                print(f"# locus {vid}{' [long]' if vid in long_vids else ''}"
                      f": expected {want} got {genotypes.get(vid)}",
                      file=sys.stderr)
        with open(os.path.join(workdir, "mismatches.json"), "w") as fh:
            json.dump(mismatches, fh)
        if long_vids:
            ok_long = sum(1 for v in long_vids
                          if genotypes.get(v) == expected[v])
            print(f"# long-tract accuracy: {ok_long}/{len(long_vids)}",
                  file=sys.stderr)
        return ok / len(expected)

    t0 = time.perf_counter()
    genotypes = run_pipeline(db_file, fa_file, workdir, config, naive,
                             accuracy_filter)
    cold_s = time.perf_counter() - t0
    acc_cold = accuracy(genotypes)

    t0 = time.perf_counter()
    genotypes2 = run_pipeline(db_file, fa_file, workdir, config, naive,
                              accuracy_filter)
    warm_s = time.perf_counter() - t0
    acc_warm = accuracy(genotypes2)

    print(json.dumps({
        "metric": "pacbio_panel_loci_per_hour",
        "value": round(n_loci / warm_s * 3600, 1),
        "unit": "loci/hour",
        "n_loci": n_loci,
        "coverage": coverage,
        "naive": naive,
        "accuracy_filter": accuracy_filter,
        "accuracy": acc_cold,
        "accuracy_warm": acc_warm,
        "cold_s": round(cold_s, 2),
        "warm_s": round(warm_s, 2),
    }))


if __name__ == "__main__":
    main()
