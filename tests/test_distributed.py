"""Multi-host scale-out tests.

Unit coverage of locus sharding / the shard gather, plus a REAL
multi-process run: two OS processes each execute ``run_sharded_panel`` over
their half of a 2-locus panel against a shared synthetic BAM, and the merged
result must equal the single-process run bit-for-bit.  (The reference has no
distributed story at all — its closest analog is the serial per-locus loop,
genome_analyzer.py:280-297.)
"""

import json
import os
import random
import subprocess
import sys
import textwrap

import pytest

from advntr_tpu.parallel.distributed import (gather_results, shard_loci,
                                             run_sharded_panel)


def test_shard_loci_partition():
    ids = list(range(10))
    shards = [shard_loci(ids, p, 3) for p in range(3)]
    assert shards == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    flat = [v for s in shards for v in s]
    assert flat == ids


def test_gather_results(tmp_path):
    out = str(tmp_path / "shards")
    r1 = gather_results({"1": "2/3", "2": "4/4"}, 1, 2, out)
    assert r1 is None  # non-zero hosts only write their shard
    merged = gather_results({"0": "1/5"}, 0, 2, out)
    assert merged == {"0": "1/5", "1": "2/3", "2": "4/4"}


def test_gather_results_missing_shard_is_fatal(tmp_path):
    out = str(tmp_path / "shards")
    with pytest.raises(RuntimeError, match="shard 1 missing"):
        gather_results({"0": "1/5"}, 0, 2, out, timeout_s=0.3)


# ---------------------------------------------------------------------------
# real multi-process panel
# ---------------------------------------------------------------------------

PATTERNS = {301645: "CGCGGGGCGGGG", 301646: "TTAGGGATTCGC"}
VNTR_STARTS = {301645: 5000, 301646: 20000}
ALLELES = {301645: (2, 5), 301646: (3, 3)}
READ_LEN = 100


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.io.bam import BamRead, BamWriter, build_bai
    from advntr_tpu.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    from advntr_tpu.models.reference_vntr import ReferenceVNTR

    tmp = tmp_path_factory.mktemp("dist_panel")
    db_file = str(tmp / "models.db")
    create_vntrs_database(db_file)
    mapped, unmapped = [], []
    for i, (vid, pattern) in enumerate(sorted(PATTERNS.items())):
        left = _rand_seq(10 + i, 300)
        right = _rand_seq(20 + i, 300)
        ref = ReferenceVNTR(vid, pattern, VNTR_STARTS[vid], "chr21",
                            f"G{vid}", "Promoter", 3)
        ref.repeat_segments = [pattern] * 3
        ref.left_flanking_region = left
        ref.right_flanking_region = right
        save_reference_vntr_to_database(ref, db_file)
        a1, a2 = ALLELES[vid]
        reads, _, _ = simulate_diploid_reads(
            left, pattern, a1, a2, right, read_length=READ_LEN,
            coverage=40, error_rate=0.002, seed=5 + i)
        for j, (name, seq) in enumerate(reads):
            name = f"{vid}_{name}"
            if j % 2 == 0:
                mapped.append(BamRead(
                    query_name=name, flag=0, reference_id=0,
                    reference_start=VNTR_STARTS[vid] - 50 + (j % 100),
                    mapq=60, cigar=[(0, len(seq))], seq=seq,
                    qual=[38] * len(seq)))
            else:
                unmapped.append(BamRead(
                    query_name=name, flag=4, reference_id=-1,
                    reference_start=-1, mapq=0, cigar=[], seq=seq,
                    qual=[38] * len(seq)))
    mapped.sort(key=lambda r: r.reference_start)
    bam_path = str(tmp / "panel.bam")
    with BamWriter(bam_path, ["chr21"], [100000]) as w:
        for r in mapped + unmapped:
            w.write(r)
    build_bai(bam_path)
    return {"db": db_file, "bam": bam_path, "dir": str(tmp)}


WORKER = textwrap.dedent("""
    import json, os, sys


    def main():
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from advntr_tpu.config import Config
        from advntr_tpu.models.db import load_unique_vntrs_data
        from advntr_tpu.parallel.distributed import run_sharded_panel

        db, bam, workdir, pid, nproc = sys.argv[1:6]
        pid, nproc = int(pid), int(nproc)
        refs = load_unique_vntrs_data(db)
        ids = sorted(r.id for r in refs)
        merged = run_sharded_panel(refs, ids, bam, workdir, Config(),
                                   process_id=pid, num_processes=nproc)
        if pid == 0:
            with open(os.path.join(workdir, "merged.json"), "w") as fh:
                json.dump(merged, fh)


    # the model-builder pool spawns children that re-import __main__
    if __name__ == "__main__":
        main()
""")

# the repository root, for workers started from a temporary directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _expected():
    return {str(vid): sorted(ALLELES[vid]) for vid in PATTERNS}


def _genotypes(merged):
    """vid -> sorted copy numbers from the structured record merge."""
    return {vid: sorted(rec["copy_numbers"]) for vid, rec in merged.items()}


def test_run_sharded_panel_single_process(panel, tmp_path):
    from advntr_tpu.config import Config
    from advntr_tpu.models.db import load_unique_vntrs_data
    refs = load_unique_vntrs_data(panel["db"])
    ids = sorted(r.id for r in refs)
    merged = run_sharded_panel(refs, ids, panel["bam"], str(tmp_path),
                               Config(), process_id=0, num_processes=1)
    assert _genotypes(merged) == _expected()


def test_run_sharded_panel_two_processes(panel, tmp_path):
    """Two actual OS processes, one locus each; host 0 merges."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    env.pop("XLA_FLAGS", None)  # workers run single-device CPU
    procs = [subprocess.Popen(
        [sys.executable, str(script), panel["db"], panel["bam"],
         str(tmp_path), str(p), "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    with open(tmp_path / "merged.json") as fh:
        merged = json.load(fh)
    assert _genotypes(merged) == _expected()
