"""In-repo auditability of the panel mismatch certifications.

The round-4 verdict required the oracle fixtures to be self-contained:
each certified mismatch must carry BOTH the pipeline's call and the
independent oracle's call, and the committed pipeline mismatch lists must
join consistently, so that `oracle == pipeline` is checkable from the
repository alone (no /tmp workdirs).  Reference bar: the mismatch triage
contract of ``git show de509b1:PERF_NOTES.md`` round 4 (33/33 certified
evidence-identical).
"""

import json
import os

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def _load(name):
    path = os.path.join(BENCH, name)
    if not os.path.exists(path):
        pytest.skip(f"fixture {name} not present")
    with open(path) as fh:
        return json.load(fh)


def _check_oracle_fixture(oracle, mismatches):
    pipe = {int(v): g for v, _, g in mismatches}
    assert oracle, "empty oracle fixture"
    for rec in oracle:
        assert "pipeline_genotype" in rec, (
            f"vid {rec['vid']}: fixture lacks pipeline_genotype")
        # the committed pipeline mismatch list must agree with the call
        # stored in the oracle record
        call = pipe.get(rec["vid"])
        if call is not None:
            want = (None if call == "None"
                    else sorted(int(x) for x in call.split("/")))
            got = (None if rec["pipeline_genotype"] is None
                   else sorted(rec["pipeline_genotype"]))
            assert got == want, (
                f"vid {rec['vid']}: oracle fixture records pipeline call "
                f"{got} but the mismatch list says {want}")
    return oracle


def test_r4_panel6719_oracle_is_self_contained():
    oracle = _load("mismatch_oracle_r4.json")
    mism = _load("panel6719_r4_mismatches.json")
    _check_oracle_fixture(oracle, mism)
    assert len(oracle) == len(mism) == 33
    agree = sum(1 for r in oracle
                if (None if r["pipeline_genotype"] is None
                    else sorted(r["pipeline_genotype"])) ==
                   (None if r["oracle_genotype"] is None
                    else sorted(r["oracle_genotype"])))
    assert agree == 33, f"oracle==pipeline only at {agree}/33"
    # every certified mismatch disagrees with simulation truth by
    # construction (that is what made it a mismatch)
    assert all(not r["oracle_matches_truth"] for r in oracle)


def test_r5_genome_oracle_if_present():
    """Same self-containment property for the round-5 genome-scale
    certification fixture (written by the round-5 genome run)."""
    oracle = _load("mismatch_oracle_genome_r5.json")
    mism_name = ("genome50k_r5_mismatches.json"
                 if os.path.exists(os.path.join(
                     BENCH, "genome50k_r5_mismatches.json"))
                 else "genome12k_r4_mismatches.json")
    mism = _load(mism_name)
    _check_oracle_fixture(oracle, mism)
    agree = sum(1 for r in oracle
                if (None if r.get("pipeline_genotype") is None
                    else sorted(r["pipeline_genotype"])) ==
                   (None if r["oracle_genotype"] is None
                    else sorted(r["oracle_genotype"])))
    assert agree == len(oracle), (
        f"oracle==pipeline only at {agree}/{len(oracle)}")
