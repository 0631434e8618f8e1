"""chip_smoke.py's phases at tiny sizes on the CPU (device and reference
both CPU), its refusal to run without a GPU, and its result line.  The
card itself is exercised only by running the script on one."""

import json
import os
import sys

import jax
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_phase_kernel_parity_cpu(cpu):
    out = chip_smoke.phase_kernel_parity(cpu, cpu, n_reads=16,
                                         read_length=48, n_oracle=3,
                                         iters=1)
    assert out["B"] == 16 and out["oracle_reads"] == 3
    assert out["max_logp_diff_vs_cpu"] == 0.0
    assert out["max_logp_diff_vs_f64_oracle"] <= chip_smoke.LOGP_TOL


def test_phase_long_reads_cpu(cpu):
    out = chip_smoke.phase_long_reads(cpu, cpu, L=96, B=4, copies=4,
                                      flank=20)
    assert out["ckpt_equals_unsegmented"]
    assert out["segment"] == 24


def test_phase_recruitment_cpu(cpu):
    out = chip_smoke.phase_recruitment(cpu, cpu, n_loci=24, n_reads=3000)
    assert out["sets_equal_cpu"] and out["planted_recall"] == 1.0
    assert out["recruited_pairs"] >= 12 * 4


def test_phase_panel_cpu(cpu, tmp_path):
    out = chip_smoke.phase_panel(cpu, str(tmp_path), n_loci=2, coverage=12,
                                 n_cpu_loci=2, watch_cards=False)
    assert out["records"] == 2
    assert out["cpu_loci"] == 2
    assert out["executables_warm"] <= out["executables_cold"]


def test_phase_pacbio_frameshift_cpu(tmp_path, monkeypatch):
    from advntr_tpu.engine import finder
    monkeypatch.setattr(finder, "CKPT_TRACEBACK_L", 256)
    monkeypatch.setattr(finder, "CKPT_SEGMENT", 64)
    out = chip_smoke.phase_pacbio_frameshift(
        str(tmp_path), read_length=1200, coverage=30, long_tract=300,
        flank=400, specs=((15, 8), (20, 6), (12, 10)))
    assert out["pacbio_calls_equal_truth"]
    assert out["frameshift_call"].startswith("D")


def test_refuses_without_gpu(cpu):
    with pytest.raises(SystemExit, match="needs a GPU; JAX found cpu"):
        chip_smoke.require_gpu([cpu])
    with pytest.raises(SystemExit, match="needs a GPU; JAX found none"):
        chip_smoke.require_gpu([])


def test_result_line_format(cpu):
    line = chip_smoke.result_line([cpu] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "cpu", "kind": cpu.device_kind, "count": 4}}
    assert "\n" not in line
