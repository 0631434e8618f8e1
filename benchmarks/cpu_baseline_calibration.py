#!/usr/bin/env python
"""Single-core CPU baseline for the bench.py configuration.

Measures the native C++ sparse-graph Viterbi engine (the reference
recurrence, pomegranate hmm.pyx:1970-2130) single-core on EXACTLY the
bench.py configuration (CSTB-like locus, n_states=927, L=150) — repeated
trials, reporting per-trial rates, median, and spread.  Run it on an
otherwise idle host: the rate varies with load and CPU model.

Usage: python benchmarks/cpu_baseline_calibration.py [trials] [reads/trial]
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 96

    # the baseline is host-only: keep JAX off any accelerator
    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import build_locus, simulate_reads
    from advntr_tpu import dna
    from advntr_tpu.native_bridge import SparseViterbiModel

    graph, art, left, right, pattern = build_locus(150)
    reads = simulate_reads(left, pattern, right, 150, n_reads, seed=9)
    rows = [dna.encode(r) for r in reads]
    model = SparseViterbiModel(graph)

    # warmup (page in the model tables)
    for r in rows[:8]:
        model.viterbi(r)

    rates = []
    for t in range(trials):
        t0 = time.perf_counter()
        for r in rows:
            model.viterbi(r)
        dt = time.perf_counter() - t0
        rates.append(n_reads / dt)
        print(f"# trial {t + 1}/{trials}: {rates[-1]:.1f} reads/s "
              f"({dt:.2f}s for {n_reads} reads)", file=sys.stderr, flush=True)

    result = {
        "metric": "cpu_sparse_viterbi_reads_per_sec_single_core",
        "n_states": art.n_states,
        "read_length": 150,
        "trials": trials,
        "reads_per_trial": n_reads,
        "rates": [round(r, 1) for r in rates],
        "median": round(statistics.median(rates), 1),
        "mean": round(statistics.fmean(rates), 1),
        "stdev": round(statistics.stdev(rates), 1) if trials > 1 else 0.0,
        "min": round(min(rates), 1),
        "max": round(max(rates), 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
