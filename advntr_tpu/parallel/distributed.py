"""Multi-host scale-out: locus-sharded panels over a jax.distributed runtime.

The reference is single-node (multiprocessing only, vntr_finder.py:424-439).
The layout for genome-wide panels (158,522 loci, reference
README.md:34-35):

- each host process owns a contiguous shard of the locus panel (its model
  DB slice lives in host RAM, compiled models in its device's memory)
- each host streams its own copy of the alignment's unmapped reads (or a
  byte-range shard of the BAM) through the recruitment filter for its loci
- per-locus genotyping is embarrassingly parallel; the only cross-host
  traffic is the final ordered gather of small genotype records to host 0

Per-read results never cross devices, so no per-locus collectives run;
aggregate statistics (e.g. coverage histograms) reduce with psum when used.
"""

from __future__ import annotations

import json
import os
import time


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op when single-process)."""
    import jax
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pin_to_card(index: int) -> str:
    """Make card ``index`` of this host the only one this process sees.

    One process per card: a JAX process reserves most of the memory of
    every card it sees when its backend starts, so processes that share a
    host must each see only their own.  Sets ``CUDA_VISIBLE_DEVICES``
    (inherited by child processes); where it already lists cards, the
    index-th of those is kept.  Must run before JAX's backend starts.
    Returns the card id now visible."""
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        raise RuntimeError("pin_to_card must run before JAX's backend "
                           "initializes")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        card = str(index)
    else:
        cards = [c for c in visible.split(",") if c.strip()]
        if not 0 <= index < len(cards):
            raise ValueError(f"card {index} is not among the visible cards "
                             f"{visible!r}")
        card = cards[index].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def shard_loci(target_vntr_ids, process_id: int, num_processes: int):
    """Contiguous locus shard for this host."""
    n = len(target_vntr_ids)
    per = (n + num_processes - 1) // num_processes
    return target_vntr_ids[process_id * per:(process_id + 1) * per]


def gather_results(local_results: dict, process_id: int,
                   num_processes: int, output_dir: str,
                   timeout_s: float = 600.0):
    """Ordered cross-host merge of per-locus genotype records.

    Genotype records are tiny (a few bytes per locus), so the merge is a
    filesystem gather: each host atomically publishes its shard (write to a
    temp name + rename), host 0 waits for every shard and merges in panel
    order.  A shard that never appears within ``timeout_s`` is a hard error
    — a silently incomplete panel must never look like a complete one.  On
    pod slices with a shared filesystem this needs no network code; swap in
    a jax.experimental.multihost_utils broadcast if desired.
    """
    os.makedirs(output_dir, exist_ok=True)
    shard_file = os.path.join(output_dir, f"results_shard_{process_id}.json")
    tmp_file = shard_file + f".tmp.{os.getpid()}"
    with open(tmp_file, "w") as fh:
        json.dump({str(k): v for k, v in local_results.items()}, fh)
    os.replace(tmp_file, shard_file)  # atomic publish
    if process_id != 0:
        return None
    merged = {}
    deadline = time.monotonic() + timeout_s
    for p in range(num_processes):
        path = os.path.join(output_dir, f"results_shard_{p}.json")
        while not os.path.exists(path):
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"results shard {p} missing after {timeout_s:.0f}s "
                    f"({path}); refusing to emit an incomplete panel")
            time.sleep(0.05)
        with open(path) as fh:
            merged.update(json.load(fh))
    return merged


def run_sharded_panel(ref_vntrs, target_vntr_ids, alignment_file: str,
                      working_dir: str, config, process_id: int = 0,
                      num_processes: int = 1, outfmt: str = "text"):
    """Genotype this host's locus shard and gather to host 0.

    The gather merges the analyzer's STRUCTURED per-locus records
    (vid -> {copy_numbers, recruited, spanning, flanking, ml, error}) —
    never the rendered output stream, which stays display-only.  This
    makes every ``outfmt`` mergeable and immune to multi-line or error-row
    formats (an earlier stdout line-pair zip silently mispaired those).
    Returns host 0's merged {vid: record} dict, None on other hosts."""
    import io
    from advntr_tpu.engine.analyzer import GenomeAnalyzer
    my_loci = shard_loci(list(target_vntr_ids), process_id, num_processes)
    out = io.StringIO()
    analyzer = GenomeAnalyzer(ref_vntrs, my_loci, working_dir, outfmt,
                              config=config, input_file=alignment_file,
                              out=out)
    if num_processes > 1:
        # per-shard result checkpoint: shard processes sharing a
        # working_dir must not interleave resume records in one file
        analyzer.checkpoint_suffix = f".shard{process_id}"
    records = analyzer.find_repeat_counts_from_alignment_file(alignment_file)
    return gather_results(records, process_id, num_processes,
                          working_dir + "/shards")
