#!/usr/bin/env python
"""Benchmark: Viterbi read-decodes/sec on the flagship genotyping kernel.

Compares the fused device pipeline (structured O(n)-per-symbol Viterbi +
traceback + per-read analytics) against the reference-style CPU engine
(native C++ sparse-graph Viterbi with silent states — the same recurrence
as the reference's Cython kernel) on a CSTB-like locus at Illumina read
length.

Prints ONE JSON line naming the device it ran on; refuses to run without
an accelerator:
  {"metric": ..., "value": N, "unit": ..., "vs_inrun_cpu_baseline": N,
   "device": {...}}
"""

import json
import random
import sys
import time


def build_locus(read_length=150):
    from advntr_tpu.models.compiler import compile_graph
    from advntr_tpu.models.graph import build_read_matcher
    from advntr_tpu.models.profile import profile_for_repeats

    pattern = "CGCGGGGCGGGG"  # CSTB dodecamer
    rng = random.Random(42)
    left = "".join(rng.choice("ACGT") for _ in range(read_length))
    right = "".join(rng.choice("ACGT") for _ in range(read_length))
    copies = int(round(read_length / len(pattern) + 0.5))
    trans, emis = profile_for_repeats([pattern] * 3, 0.05)
    graph = build_read_matcher(left, right, trans, emis, copies, 0.05)
    art = compile_graph(graph)
    return graph, art, left, right, pattern


def simulate_reads(left, pattern, right, read_length, n_reads, seed=9):
    from advntr_tpu.engine.simulate import haplotype_sequence, mutate
    rng = random.Random(seed)
    reads = []
    for _ in range(n_reads):
        copies = rng.choice([2, 5])
        hap = haplotype_sequence(left, pattern, copies, right)
        start = rng.randint(0, len(hap) - read_length)
        reads.append(mutate(hap[start:start + read_length], 0.003, rng))
    return reads


def main():
    from advntr_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures the accelerator; JAX found none")

    read_length = 150
    B = 4096
    graph, art, left, right, pattern = build_locus(read_length)
    reads = simulate_reads(left, pattern, right, read_length, B)

    from advntr_tpu import dna
    from advntr_tpu.engine import device_analytics as da
    from advntr_tpu.engine.finder import LocusModelCache

    lm = LocusModelCache()._build(graph, art)
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, pad_to=read_length, multiple=32)
    batch_d = jnp.asarray(batch)
    lengths_d = jnp.asarray(lengths)

    def run():
        return da.read_stats_struct(lm.struct.flat(), lm.meta, batch_d,
                                    lengths_d, lm.suffix_last)

    jax.block_until_ready(run())          # compile + warm up
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(run())
    device_rate = B * iters / (time.perf_counter() - t0)

    # CPU baseline: reference-style sparse Viterbi (C++), single core,
    # median of three trials, measured in this run
    from advntr_tpu.native_bridge import SparseViterbiModel
    cpu_model = SparseViterbiModel(graph)
    n_cpu = 24
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for r in rows[:n_cpu]:
            cpu_model.viterbi(r)
        rates.append(n_cpu / (time.perf_counter() - t0))
    cpu_rate = sorted(rates)[1]
    print(json.dumps({
        "metric": "viterbi_read_decodes_per_sec",
        "value": device_rate,
        "unit": "reads/s",
        "vs_inrun_cpu_baseline": device_rate / cpu_rate,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# n_states={art.n_states} B={B} L={read_length} "
          f"cpu_baseline={cpu_rate:.1f} reads/s (native C++, one core)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
