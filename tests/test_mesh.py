"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax

from advntr_tpu import dna
from advntr_tpu.engine import device_analytics as da
from advntr_tpu.engine.finder import _pad_artifact
from advntr_tpu.models.compiler import compile_graph
from advntr_tpu.models.graph import build_read_matcher
from advntr_tpu.models.profile import profile_for_repeats
from advntr_tpu.parallel.mesh import (
    make_mesh, stack_models, multi_locus_read_stats, data_parallel_read_stats)


def make_model(pattern, copies=3, n_pad=256):
    trans, emis = profile_for_repeats([pattern] * 3, 0.05)
    g = build_read_matcher("ACGTTGCAGT", "TTACGGATCC", trans, emis, copies,
                           0.05)
    art = _pad_artifact(compile_graph(g), n_pad)
    return art, da.DeviceModel.from_artifact(art)


@pytest.fixture(scope="module")
def models():
    return [make_model("CAGCAG"), make_model("TTGGCC")]


def _read_batch(patterns, B=8, L=64):
    seqs, lengths = [], []
    for pattern in patterns:
        rows = []
        for i in range(B):
            s = ("ACGTTGCAGT" + pattern * 4 + "TTACGGATCC")[: L]
            rows.append(dna.encode(s))
        b, ln = dna.pad_batch(rows, pad_to=L, multiple=1)
        seqs.append(b)
        lengths.append(ln)
    return np.stack(seqs), np.stack(lengths)


def test_multi_locus_sharded(models):
    assert len(jax.devices()) == 8
    mesh = make_mesh(n_loci=2, n_reads=4)
    stacked = stack_models([m for _, m in models])
    seqs, lengths = _read_batch(["CAGCAG", "TTGGCC"], B=8)
    out = multi_locus_read_stats(mesh, stacked, seqs, lengths)
    assert out["logp"].shape == (2, 8)
    # cross-check against per-locus unsharded runs
    for gi, (_, model) in enumerate(models):
        ref = da.read_stats(model.flat(), seqs[gi], lengths[gi])
        np.testing.assert_allclose(np.asarray(out["logp"][gi]),
                                   np.asarray(ref["logp"]), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(out["repeats"][gi]),
                                      np.asarray(ref["repeats"]))


def test_data_parallel_single_locus(models):
    mesh = make_mesh(n_loci=1, n_reads=8)
    _, model = models[0]
    seqs, lengths = _read_batch(["CAGCAG"], B=16)
    out = data_parallel_read_stats(mesh, model.flat(), seqs[0], lengths[0])
    ref = da.read_stats(model.flat(), seqs[0], lengths[0])
    np.testing.assert_allclose(np.asarray(out["logp"]),
                               np.asarray(ref["logp"]), rtol=1e-5)


# ---- PRODUCTION grouped dispatch, sharded ----------------------------------

@pytest.fixture(scope="module")
def grouped():
    import __graft_entry__ as ge
    patterns = ["CAGCAG", "TTGGCC", "ACGTAC", "GGCCAA"]
    stacks = ge._make_grouped_models(patterns)
    seqs, lengths = _read_batch(patterns, B=8)
    return patterns, stacks, seqs, lengths


@pytest.mark.parametrize("n_loci,n_reads", [(2, 4), (4, 2)])
def test_sharded_grouped_struct_exact(grouped, n_loci, n_reads):
    """Sharded production struct dispatch == unsharded, bit for bit."""
    from advntr_tpu.parallel.mesh import sharded_grouped_read_stats
    patterns, (st, meta, sl), seqs, lengths = grouped
    mesh = make_mesh(n_loci=n_loci, n_reads=n_reads)
    out = sharded_grouped_read_stats(mesh, st, meta, seqs, lengths,
                                     suffix_lasts=sl)
    import jax.numpy as jnp
    ref = da.read_stats_struct_grouped(st, meta, jnp.asarray(seqs),
                                       jnp.asarray(lengths),
                                       jnp.asarray(sl))
    for k in ref:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]),
                                      err_msg=k)


def test_panel_mesh_factoring():
    from advntr_tpu.parallel.mesh import panel_mesh
    mesh = panel_mesh(group_size=8, batch=512)
    assert mesh is not None
    assert mesh.shape["loci"] * mesh.shape["reads"] == 8
    assert 8 % mesh.shape["loci"] == 0
    assert 512 % mesh.shape["reads"] == 0
    assert panel_mesh(8, 512, devices=jax.devices()[:1]) is None


def test_analyzer_uses_sharded_dispatch(monkeypatch, tmp_path):
    """End-to-end: the analyzer's grouped dispatch routes through the mesh
    when >1 device is visible, and genotypes stay identical to the
    single-device path."""
    import io as _io
    import random
    import advntr_tpu.parallel.mesh as mesh_mod
    from advntr_tpu.config import Config
    from advntr_tpu.engine.analyzer import GenomeAnalyzer
    from advntr_tpu.engine.simulate import simulate_diploid_reads
    from advntr_tpu.io.bam import BamRead, BamWriter
    from advntr_tpu.models.reference_vntr import ReferenceVNTR

    rng = random.Random(31)
    pattern = "GATCGATTCGAA"
    ref = ReferenceVNTR(55, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = "".join(
        rng.choice("ACGT") for _ in range(200))
    ref.right_flanking_region = "".join(
        rng.choice("ACGT") for _ in range(200))
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, pattern, 2, 4, ref.right_flanking_region,
        read_length=100, coverage=30, error_rate=0.002, seed=9)
    bam_path = str(tmp_path / "s.bam")
    with BamWriter(bam_path, ["chr1"], [100000]) as w:
        for name, seq in reads:
            w.write(BamRead(name, 4, -1, -1, 0, [], seq, [38] * len(seq)))

    calls = {"n": 0}
    orig = mesh_mod.sharded_grouped_read_stats

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    outputs = {}
    for tag in ("sharded", "single"):
        if tag == "sharded":
            monkeypatch.setattr(mesh_mod, "sharded_grouped_read_stats", spy)
        else:
            monkeypatch.setattr(mesh_mod, "panel_mesh",
                                lambda *a, **kw: None)
        buf = _io.StringIO()
        analyzer = GenomeAnalyzer([ref], [55],
                                  str(tmp_path / tag) + "/", "text",
                                  config=Config(), out=buf,
                                  input_file=bam_path)
        analyzer.find_repeat_counts_from_alignment_file(bam_path)
        outputs[tag] = buf.getvalue()
    assert calls["n"] >= 1, "sharded dispatch not used with 8 devices"
    assert outputs["sharded"] == outputs["single"]
    assert outputs["sharded"].strip().splitlines() == ["55", "2/4"]

