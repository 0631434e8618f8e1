#!/usr/bin/env python
"""Genome-scale feasibility exercise (BASELINE config #5).

Two subcommands:

  panel <workdir> [n_loci] [coverage]
      Build an n_loci genic-style panel (default 12,000 — the 10-20k
      slice of the reference's 158,522-locus genic DB, README.md:34-35),
      `buildbank` it, run the full pipeline cold+warm on the current
      backend, and report loci/hour + accuracy + the extrapolation to
      158,522 loci.  Reuses an existing workdir's inputs/bank on rerun.

  keywords [n_keywords]
      Keyword-bank + counting-kernel scaling: build a keyword table at
      the reference's genome-wide trie sizing (3,801,639 keywords,
      filtering/main.cc:23) across ~158k synthetic loci and measure
      build time, table footprint, and device counting throughput on
      simulated unmapped reads.

  stream [n_reads] [n_keywords]
      Genome-scale device recruitment (round-4 verdict item 3): run the
      counting kernel with the full 3.8M-keyword bank over a >=1M-read
      synthetic unmapped stream on the current JAX backend,
      using the production top-M device compaction + async chunk
      queueing, and report reads/s plus the extrapolated cost of a 30x
      WGS unmapped set (15M reads).  Reference bar: the one-pass all-loci
      C++ scan, filtering/main.cc:229-331.
"""

import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cmd_panel(argv):
    from advntr_tpu.config import Config
    from advntr_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    from benchmarks.panel_bench import make_panel, build_inputs, run_pipeline

    import dataclasses
    argv = list(argv)
    once = "--once" in argv
    if once:
        argv.remove("--once")
    prebank = "--no-prebank" not in argv
    if not prebank:
        argv.remove("--no-prebank")
    io_threads = None
    if "--io-threads" in argv:
        i = argv.index("--io-threads")
        io_threads = int(argv[i + 1])
        del argv[i:i + 2]
    workdir = argv[0]
    n_loci = int(argv[1]) if len(argv) > 1 else 12000
    coverage = float(argv[2]) if len(argv) > 2 else 15
    os.makedirs(workdir, exist_ok=True)
    db_file = os.path.join(workdir, "panel.db")
    bam_file = os.path.join(workdir, "panel.bam")
    exp_file = os.path.join(workdir, "expected.json")

    panel = make_panel(n_loci)
    if not os.path.exists(exp_file):
        t0 = time.perf_counter()
        build_inputs(panel, coverage, workdir)
        with open(exp_file, "w") as fh:
            json.dump({str(ref.id): "/".join(map(str, alleles))
                       for ref, alleles in panel}, fh)
        print(f"# inputs built in {time.perf_counter() - t0:.0f}s",
              flush=True)
    with open(exp_file) as fh:
        expected = json.load(fh)

    bank_dir = os.path.join(workdir, "model_bank")
    if prebank and (not os.path.isdir(bank_dir)
                    or len(os.listdir(bank_dir)) < n_loci):
        from advntr_tpu.cli import main as cli_main
        t0 = time.perf_counter()
        cli_main(["buildbank", "-m", db_file, "-l", "150", "-t", "2",
                  "--working_directory", workdir])
        print(f"# buildbank {n_loci} loci: "
              f"{time.perf_counter() - t0:.0f}s", flush=True)

    def clear_ckpt():
        for name in os.listdir(workdir):
            if name.startswith("results_checkpoint_"):
                os.remove(os.path.join(workdir, name))

    cfg = Config()
    if io_threads is not None:
        # workers = io_threads - 1 process-pool model builders overlap the
        # device dispatch (LocusModelCache.schedule) — the no-prebank mode
        # builds the bank inside the run instead of a serial prepass
        cfg = dataclasses.replace(cfg, io_threads=io_threads)
    results = {"n_loci": n_loci, "coverage": coverage}
    for tag in (("cold",) if once else ("cold", "warm")):
        clear_ckpt()
        t0 = time.perf_counter()
        genotypes = run_pipeline(db_file, bam_file, workdir, cfg)
        dt = time.perf_counter() - t0
        mism = [(vid, want, genotypes.get(vid))
                for vid, want in expected.items()
                if genotypes.get(vid) != want]
        results[f"{tag}_s"] = round(dt, 1)
        results[f"accuracy_{tag}"] = 1 - len(mism) / len(expected)
        results[f"loci_per_hour_{tag}"] = round(n_loci / dt * 3600, 1)
        with open(os.path.join(workdir, f"mismatches_{tag}.json"),
                  "w") as fh:
            json.dump(mism, fh)
        print(json.dumps(results), flush=True)
    rate_key = "loci_per_hour_cold" if once else "loci_per_hour_warm"
    results["extrapolated_hours_158522"] = round(
        158522 / results[rate_key], 2)
    print(json.dumps(results))


def cmd_keywords(argv):
    import numpy as np
    import jax.numpy as jnp
    from advntr_tpu.ops.kmer_filter import (RecruitmentFilter,
                                            build_keyword_table, _count_hits)

    n_keywords = int(argv[0]) if argv else 3_801_639
    per_locus = 24            # ~the reference ratio: 3.8M keywords/158k loci
    n_loci = max(1, n_keywords // per_locus)
    rng = random.Random(99)

    t0 = time.perf_counter()
    keywords = {}
    for li in range(n_loci):
        kws = set()
        while len(kws) < per_locus:
            kws.add("".join(rng.choice("ACGT") for _ in range(15)))
        keywords[li] = kws
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    table = build_keyword_table(keywords)
    build_s = time.perf_counter() - t0
    footprint = table.codes.nbytes + table.locus_ids.nbytes
    print(f"# bank: {len(table.codes)} keywords over {n_loci} loci, "
          f"build {build_s:.1f}s (+{gen_s:.1f}s synth), "
          f"{footprint / 1e6:.1f} MB codes+ids, max_dup={table.max_dup}",
          flush=True)

    # counting throughput: 150bp reads, B capped the way process_batch caps
    filt = RecruitmentFilter(keywords)
    B_cap = max(32, (64 << 20) // n_loci)
    B_cap = 1 << (B_cap.bit_length() - 1)
    B = min(1024, B_cap)
    reads = []
    for i in range(B):
        s = "".join(rng.choice("ACGT") for _ in range(150))
        if i % 4 == 0:      # a quarter of reads carry a true keyword
            kw = rng.choice(sorted(keywords[rng.randrange(n_loci)]))
            p = rng.randint(0, 150 - 15)
            s = s[:p] + kw + s[p + 15:]
        reads.append(s)
    rows = [np.frombuffer(s.encode(), dtype=np.uint8) for s in reads]
    from advntr_tpu import dna
    enc = [dna.encode(s) for s in reads]
    batch, lengths = dna.pad_batch(enc, multiple=128)
    batch_d, lengths_d = jnp.asarray(batch), jnp.asarray(lengths)
    codes_d = jnp.asarray(table.codes)
    locus_d = jnp.asarray(table.locus_ids)

    counts = np.asarray(_count_hits(codes_d, locus_d, batch_d, lengths_d,
                                    table.k, n_loci, table.max_dup))
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        counts = np.asarray(_count_hits(codes_d, locus_d, batch_d,
                                        lengths_d, table.k, n_loci,
                                        table.max_dup))
    dt = (time.perf_counter() - t0) / iters
    planted = int((counts >= 1).sum())
    print(json.dumps({
        "metric": "keyword_counting_reads_per_sec",
        "value": round(B / dt, 1),
        "unit": "reads/s",
        "n_keywords": len(table.codes),
        "n_loci": n_loci,
        "B": B,
        "counts_plane_mb": round(B * n_loci * 4 / 1e6, 1),
        "reads_with_hits": planted,
    }))


def cmd_stream(argv):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from advntr_tpu.ops.kmer_filter import build_keyword_table, _count_topk

    n_reads = int(argv[0]) if argv else 1_000_000
    n_keywords = int(argv[1]) if len(argv) > 1 else 3_801_639
    per_locus = 24
    n_loci = max(1, n_keywords // per_locus)
    read_len = 150
    top_m = 16
    rng = random.Random(99)
    nprng = np.random.default_rng(99)

    t0 = time.perf_counter()
    keywords = {}
    for li in range(n_loci):
        kws = set()
        while len(kws) < per_locus:
            kws.add("".join(rng.choice("ACGT") for _ in range(15)))
        keywords[li] = kws
    table = build_keyword_table(keywords)
    build_s = time.perf_counter() - t0
    print(f"# bank: {len(table.codes)} keywords / {n_loci} loci "
          f"built in {build_s:.1f}s, max_dup={table.max_dup}", flush=True)

    # synthetic unmapped stream as 2-bit codes directly (the production
    # path's dna.encode is a table lookup; generating strings for 1M reads
    # would only benchmark Python string handling)
    t0 = time.perf_counter()
    codes = nprng.integers(0, 4, size=(n_reads, read_len), dtype=np.int8)
    # a 1/16 slice of reads carries >=5 planted keyword occurrences of one
    # locus (recruitment-positive), modeling a panel-heavy stream
    n_pos_reads = n_reads // 16
    for i in range(n_pos_reads):
        li = rng.randrange(n_loci)
        kws = sorted(keywords[li])
        for j in range(5):
            kw = kws[j % len(kws)]
            arr = np.array(["ACGT".find(ch) for ch in kw], dtype=np.int8)
            p = 5 + j * 28
            codes[i, p:p + 15] = arr
    gen_s = time.perf_counter() - t0
    print(f"# stream: {n_reads} reads x {read_len}bp generated in "
          f"{gen_s:.1f}s ({n_pos_reads} recruitment-positive)", flush=True)

    B_cap = max(32, (64 << 20) // n_loci)
    B = min(4096, 1 << (B_cap.bit_length() - 1))
    lengths = np.full(B, read_len, dtype=np.int32)
    lengths_d = jnp.asarray(lengths)
    codes_d = jnp.asarray(table.codes)
    locus_d = jnp.asarray(table.locus_ids)

    def dispatch(chunk):
        if len(chunk) < B:
            pad = np.full((B - len(chunk), read_len), 4, dtype=np.int8)
            chunk = np.concatenate([chunk, pad])
        return _count_topk(codes_d, locus_d, jnp.asarray(chunk), lengths_d,
                           table.k, n_loci, table.max_dup, top_m)

    # compile warmup
    v, ix = dispatch(codes[:B])
    _ = np.asarray(v)
    print(f"# warm: B={B}, first batch compiled", flush=True)

    # async stream: queue every chunk, keep outputs (small), sync ONCE on
    # the final output — then drain.  This is the production dispatch
    # shape (kmer_filter._process_chunk queues, results() drains).
    outs = []
    t0 = time.perf_counter()
    for s in range(0, n_reads, B):
        outs.append(dispatch(codes[s:s + B]))
    _ = np.asarray(outs[-1][0])
    queue_s = time.perf_counter() - t0
    # drain: host-side accumulation of thresholded pairs
    t0 = time.perf_counter()
    n_recruited = 0
    for v, ix in outs:
        vals = np.asarray(v)
        n_recruited += int((vals >= 5).sum())
    drain_s = time.perf_counter() - t0
    rate = n_reads / (queue_s + drain_s)
    result = {
        "metric": "genome_scale_recruitment_reads_per_sec",
        "value": round(rate, 1),
        "unit": "reads/s",
        "backend": jax.devices()[0].platform,
        "n_keywords": len(table.codes),
        "n_loci": n_loci,
        "n_reads": n_reads,
        "B": B,
        "queue_s": round(queue_s, 1),
        "drain_s": round(drain_s, 1),
        "recruited_pairs": n_recruited,
        "expected_positive": n_pos_reads,
        "wgs_15M_hours": round(15e6 / rate / 3600, 2),
    }
    print(json.dumps(result))


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in ("panel", "keywords",
                                                "stream"):
        print(__doc__)
        sys.exit(2)
    if sys.argv[1] == "panel":
        cmd_panel(sys.argv[2:])
    elif sys.argv[1] == "stream":
        cmd_stream(sys.argv[2:])
    else:
        cmd_keywords(sys.argv[2:])


if __name__ == "__main__":
    main()
