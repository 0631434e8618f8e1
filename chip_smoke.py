#!/usr/bin/env python
"""Smoke run of the genotyping path on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the multi-card panel path only

Refuses to run unless JAX's first device is a GPU.  Prints the card's name
and power limit first (from nvidia-smi), then one line per phase with its
numbers, and as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Any failed comparison is reported on stderr and the script exits non-zero
without that line.  The per-phase JSON is also appended to
``chiprun_out/chip_smoke_phases.jsonl``; profiler traces are reduced in
the run and not kept.

Phases (one card):
  1. struct kernel at bench.py's shape (CSTB locus, L=150, B=4096) on the
     GPU vs the same jitted call on the CPU, plus an f64 full-graph rescore
     of decoded paths; reads/s and the top device operations of a trace.
  2. long reads (L=2432, B=64): checkpointed kernel vs the unsegmented
     struct kernel on the GPU (bit for bit), and vs the CPU.
  3. recruitment over a synthetic unmapped stream, GPU vs CPU sets.
  4. the Illumina panel through ``python -m advntr_tpu.cli genotype``,
     cold then warm, checked against truth and a CPU run of the CLI.
  5. PacBio (``genotype -p``, 10 kb reads, one checkpoint-routed locus) and
     frameshift (``genotype -fs``) through the CLI, against truth.
  6. while phase 4 runs, nvidia-smi lists one compute process at most.
"""

from __future__ import annotations

import json
import logging
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# comparison tolerances: max-plus decoding is exact up to float32 rounding
# of the additions, whose order may differ between backends
LOGP_TOL = 1e-3
INT_KEYS = ("repeats", "n_matches", "repeat_bp", "left_flank_bp",
            "right_flank_bp", "left_flank_matches", "right_flank_matches")


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# device, card and result lines
# ---------------------------------------------------------------------------

def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: a smoke run on the CPU would
    say nothing about the card."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {platform}")


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def result_line(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def emit(phase: str, numbers: dict) -> None:
    print(f"{phase}: " + json.dumps(numbers, default=str), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phases.jsonl"), "a") as fh:
        fh.write(json.dumps({"phase": phase, **numbers}, default=str) + "\n")


class CompileCounter:
    """Counts executables JAX compiles or loads from its persistent cache
    (one event per executable, compiled or loaded)."""

    def __init__(self):
        import jax.monitoring
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------

def trace_summary(trace_dir: str, top: int = 8) -> dict:
    """Device time from a jax.profiler trace: busy time (union of kernel
    intervals), the window from first to last kernel, time per kernel name
    and per XLA module (one module per jitted executable, which attributes
    time to a stage).  Kernels are read from the device planes' stream
    lines, else from "XLA Ops", else from every line of the plane."""
    import glob
    import jax
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        return {"device_planes": 0}
    data = jax.profiler.ProfileData.from_file(paths[-1])
    ops: dict[str, int] = {}
    modules: dict[str, int] = {}
    line_events: dict[str, int] = {}
    stat_keys: set[str] = set()
    intervals = []
    planes = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        planes += 1
        lines = list(plane.lines)
        for line in lines:
            line_events[line.name] = line_events.get(line.name, 0) + sum(
                1 for _ in line.events)
        kernel_lines = [ln for ln in lines if ln.name.startswith("Stream")] \
            or [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for line in kernel_lines:
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
                stats = dict(ev.stats)
                stat_keys.update(stats)
                module = stats.get("hlo_module")
                if module is not None:
                    modules[str(module)] = modules.get(str(module), 0) \
                        + ev.duration_ns
    busy = 0
    window = 0
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = intervals[-1][1] - intervals[0][0]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"device_planes": planes, "device_lines": line_events,
            "kernel_stat_keys": sorted(stat_keys),
            "busy_s": busy / 1e9, "kernel_window_s": window / 1e9,
            "modules_s": {k: v / 1e9 for k, v in sorted(
                modules.items(), key=lambda kv: -kv[1])},
            "top_ops_s": [(k, v / 1e9) for k, v in top_ops]}


# ---------------------------------------------------------------------------
# phase 1: struct kernel parity at bench.py's shape
# ---------------------------------------------------------------------------

def _stats_on(device, fn, arrays, *static, **kw):
    import jax
    return fn(*jax.device_put(arrays, device), *static, **kw)


def _compare_stats(got: dict, ref: dict, what: str) -> float:
    import numpy as np
    for k in INT_KEYS:
        check(np.array_equal(np.asarray(got[k]), np.asarray(ref[k])),
              f"{what}: {k} differs")
    g, r = np.asarray(got["logp"]), np.asarray(ref["logp"])
    live = r > -1e20
    check(np.array_equal(g > -1e20, live), f"{what}: reachability differs")
    dmax = float(np.max(np.abs(g[live] - r[live]))) if live.any() else 0.0
    check(dmax <= LOGP_TOL, f"{what}: |logp diff| {dmax} > {LOGP_TOL}")
    return dmax


def phase_kernel_parity(device, ref_device, n_reads: int = 4096,
                        read_length: int = 150, n_oracle: int = 64,
                        iters: int = 10, trace_dir: str | None = None):
    import jax
    import numpy as np
    from bench import build_locus, simulate_reads
    from advntr_tpu import dna
    from advntr_tpu.engine import device_analytics as da
    from advntr_tpu.engine.finder import LocusModelCache
    from advntr_tpu.models.compiler import (expand_path,
                                            score_visited_path,
                                            viterbi_full_graph)

    graph, art, left, right, pattern = build_locus(read_length)
    reads = simulate_reads(left, pattern, right, read_length, n_reads)
    lm = LocusModelCache()._build(graph, art)
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, pad_to=read_length, multiple=32)
    arrays = (lm.struct.flat(), lm.meta, batch, lengths)

    def run(dev, return_path=False):
        return _stats_on(dev, da.read_stats_struct, arrays, lm.suffix_last,
                         return_path=return_path)

    jax.block_until_ready(run(device))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(run(device))
    rate = n_reads * iters / (time.perf_counter() - t0)
    trace = None
    if trace_dir:
        jax.profiler.start_trace(trace_dir)
        for _ in range(3):
            jax.block_until_ready(run(device))
        jax.profiler.stop_trace()
        trace = trace_summary(trace_dir)

    got = {k: np.asarray(v) for k, v in run(device, True).items()}
    ref = {k: np.asarray(v) for k, v in run(ref_device, True).items()}
    dmax = _compare_stats(got, ref, "struct gpu vs cpu")

    worst = 0.0
    for b in range(min(n_oracle, n_reads)):
        codes = rows[b]
        oracle, _ = viterbi_full_graph(graph, codes)
        visited = expand_path(art, got["path"][b][: len(codes)])
        rescored = score_visited_path(graph, visited, codes)
        err = max(abs(float(oracle) - float(got["logp"][b])),
                  abs(rescored - float(got["logp"][b])))
        check(err <= LOGP_TOL, f"read {b}: f64 oracle {oracle}, rescored "
              f"path {rescored}, device {got['logp'][b]}")
        worst = max(worst, err)
    return {"n_states": art.n_states, "B": n_reads, "L": read_length,
            "reads_per_s": rate, "max_logp_diff_vs_cpu": dmax,
            "oracle_reads": min(n_oracle, n_reads),
            "max_logp_diff_vs_f64_oracle": worst, "trace": trace}


# ---------------------------------------------------------------------------
# phase 2: long reads through the checkpointed kernel
# ---------------------------------------------------------------------------

def build_long_locus(L: int, B: int, copies: int = 60, flank: int = 300,
                     seed: int = 5):
    """Long-read lattice: a 25 bp motif at the PacBio error rate with reads
    of L columns that span most of a ``copies``-unit model."""
    from advntr_tpu import dna
    from advntr_tpu.engine.finder import LocusModelCache
    from advntr_tpu.engine.simulate import mutate
    from advntr_tpu.models.compiler import compile_graph
    from advntr_tpu.models.graph import build_read_matcher
    from advntr_tpu.models.profile import profile_for_repeats

    rng = random.Random(seed)
    pattern = "CGCGGGGCGGGGCACCCACGTACGT"
    left = "".join(rng.choice("ACGT") for _ in range(flank))
    right = "".join(rng.choice("ACGT") for _ in range(flank))
    trans, emis = profile_for_repeats([pattern] * 3, 0.3)
    g = build_read_matcher(left, right, trans, emis, copies, 0.3)
    lm = LocusModelCache()._build(g, compile_graph(g))
    hap = left + pattern * max(2, copies - 8) + right
    rows = []
    for _ in range(B):
        s = mutate(hap, 0.08, rng)
        s = (s + "".join(rng.choice("ACGT")
                         for _ in range(max(0, L - len(s)))))[:L]
        rows.append(dna.encode(s))
    batch, lengths = dna.pad_batch(rows, pad_to=L, multiple=32)
    return lm, batch, lengths


def phase_long_reads(device, ref_device, L: int = 2432, B: int = 64,
                     copies: int = 60, flank: int = 300):
    import jax
    import numpy as np
    from advntr_tpu.engine import device_analytics as da
    from advntr_tpu.engine.finder import CKPT_SEGMENT

    lm, batch, lengths = build_long_locus(L, B, copies, flank)
    arrays = (lm.struct.flat(), lm.meta, batch, lengths)
    segment = min(CKPT_SEGMENT, max(1, L // 4))

    def ckpt(dev):
        return _stats_on(dev, da.read_stats_struct_ckpt, arrays,
                         lm.suffix_last, return_path=True, segment=segment)

    jax.block_until_ready(ckpt(device))
    t0 = time.perf_counter()
    got = {k: np.asarray(v) for k, v in ckpt(device).items()}
    rate = B / (time.perf_counter() - t0)
    plain = {k: np.asarray(v) for k, v in _stats_on(
        device, da.read_stats_struct, arrays, lm.suffix_last,
        return_path=True).items()}
    for k in got:
        check(np.array_equal(got[k], plain[k]),
              f"ckpt vs unsegmented struct: {k} differs")
    ref = {k: np.asarray(v) for k, v in ckpt(ref_device).items()}
    dmax = _compare_stats(got, ref, "ckpt gpu vs cpu")
    return {"n_states": lm.art.n_states,
            "struct_P": int(lm.struct.blk_idx.shape[0]), "B": B, "L": L,
            "segment": segment, "ckpt_reads_per_s": rate,
            "ckpt_equals_unsegmented": True, "max_logp_diff_vs_cpu": dmax}


# ---------------------------------------------------------------------------
# phase 3: recruitment
# ---------------------------------------------------------------------------

def make_recruitment_stream(n_loci: int, n_reads: int, read_len: int = 150,
                            planted_per_locus: int = 4, seed: int = 11):
    """Loci with random motifs and flanks, and an unmapped stream of random
    reads with ``planted_per_locus`` tract-spanning reads per locus for the
    first half of the loci."""
    import numpy as np
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    rng = random.Random(seed)
    refs, planted = [], []
    for i in range(n_loci):
        plen = rng.choice([8, 10, 12, 15, 20])
        pattern = "".join(rng.choice("ACGT") for _ in range(plen))
        ref = ReferenceVNTR(5000 + i, pattern, 10_000 * (i + 1), "chr1")
        ref.repeat_segments = [pattern] * max(2, 60 // plen)
        ref.left_flanking_region = "".join(rng.choice("ACGT")
                                           for _ in range(200))
        ref.right_flanking_region = "".join(rng.choice("ACGT")
                                            for _ in range(200))
        refs.append(ref)
        if i < n_loci // 2:
            hap = (ref.left_flanking_region + "".join(ref.repeat_segments)
                   + ref.right_flanking_region)
            mid = 200 + len("".join(ref.repeat_segments)) // 2
            for k in range(planted_per_locus):
                start = max(0, mid - read_len // 2 + rng.randint(-20, 20))
                planted.append((f"p{ref.id}_{k}",
                                hap[start:start + read_len], ref.id))
    n_random = max(0, n_reads - len(planted))
    codes = np.random.default_rng(seed).integers(0, 4, (n_random, read_len),
                                                 dtype=np.uint8)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    stream = [(f"r{j}", letters[j].tobytes().decode())
              for j in range(n_random)]
    stream += [(name, seq) for name, seq, _ in planted]
    random.Random(seed).shuffle(stream)
    return refs, stream, planted


def recruit(device, refs, stream):
    import jax
    from advntr_tpu.engine.recruitment import (build_recruitment_filter,
                                               filter_reads)
    with jax.default_device(device):
        filt = build_recruitment_filter(refs, [r.id for r in refs])
        t0 = time.perf_counter()
        results, _ = filter_reads(filt, iter(stream))
        dt = time.perf_counter() - t0
    return {vid: sorted(name for name, _ in hits)
            for vid, hits in results.items()}, dt


def phase_recruitment(device, ref_device, n_loci: int = 1000,
                      n_reads: int = 200_000):
    refs, stream, planted = make_recruitment_stream(n_loci, n_reads)
    recruit(device, refs, stream[:2048])            # compile
    got, dt = recruit(device, refs, stream)
    ref, _ = recruit(ref_device, refs, stream)
    check(got == ref, "recruited sets differ between GPU and CPU: " + str(
        [v for v in ref if got.get(v) != ref[v]][:10]))
    found = sum(1 for name, _, vid in planted if name in set(got[vid]))
    recall = found / max(1, len(planted))
    check(recall >= 0.99, f"planted recall {recall}")
    return {"n_loci": n_loci, "n_reads": len(stream),
            "reads_per_s": len(stream) / dt,
            "recruited_pairs": sum(len(v) for v in got.values()),
            "planted_recall": recall, "sets_equal_cpu": True}


# ---------------------------------------------------------------------------
# phase 4: the Illumina panel through the CLI
# ---------------------------------------------------------------------------

class LogAlarm(logging.Handler):
    """Collects WARNING+ records; the analyzer logs every per-locus error
    and every grouped-dispatch fallback at these levels."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records: list[str] = []

    def emit(self, record):
        self.records.append(record.getMessage())

    def failures(self) -> list[str]:
        keys = ("Grouped dispatch failed", "Grouped collect failed",
                "FAST-PATH DEGRADATION", "Error genotyping",
                "Error preparing")
        return [r for r in self.records if any(k in r for k in keys)]


def parse_text_output(path: str) -> dict:
    with open(path) as fh:
        lines = fh.read().strip().splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


def run_cli(args: list[str]) -> float:
    """``python -m advntr_tpu.cli <args>`` in this process; returns wall s."""
    from advntr_tpu import cli
    t0 = time.perf_counter()
    cli.main(args)
    return time.perf_counter() - t0


def run_cli_child(args: list[str], env_extra: dict, timeout: float):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "advntr_tpu.cli"] + args,
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    check(proc.returncode == 0, f"CLI child failed: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


CPU_ONLY = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}


def clear_results(workdir: str) -> None:
    for name in os.listdir(workdir):
        if name.startswith("results_checkpoint_"):
            os.remove(os.path.join(workdir, name))


def read_records(workdir: str) -> dict:
    """Per-locus records of a finished run (its JSONL result checkpoint)."""
    out = {}
    for name in os.listdir(workdir):
        if name.startswith("results_checkpoint_"):
            with open(os.path.join(workdir, name)) as fh:
                for line in fh:
                    rec = json.loads(line)
                    out[str(rec["vid"])] = rec
    return out


def make_illumina_panel(workdir: str, n_loci: int, coverage: float):
    from benchmarks.panel_bench import build_inputs, make_panel
    panel = make_panel(n_loci)
    db, bam = build_inputs(panel, coverage, workdir)
    truth = {str(ref.id): "/".join(map(str, alleles))
             for ref, alleles in panel}
    return db, bam, truth


class ComputeAppWatch:
    """Polls nvidia-smi for the processes that hold a card (phase 6)."""

    def __init__(self, interval: float = 1.0):
        self.pids: set[str] = set()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        args=(interval,))

    def _run(self, interval):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=30).stdout
                self.pids.update(p.strip() for p in out.splitlines()
                                 if p.strip())
                self.samples += 1
            except (OSError, subprocess.SubprocessError):
                pass
            self._stop.wait(interval)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def phase_panel(device, workdir: str, n_loci: int = 128,
                coverage: float = 30, n_cpu_loci: int = 16,
                trace_dir: str | None = None, watch_cards: bool = True):
    from advntr_tpu.utils import profiler
    os.makedirs(workdir, exist_ok=True)
    db, bam, truth = make_illumina_panel(workdir, n_loci, coverage)
    gpu_dir = os.path.join(workdir, "gpu")
    cpu_dir = os.path.join(workdir, "cpu")
    os.makedirs(gpu_dir)
    os.makedirs(cpu_dir)
    out = os.path.join(workdir, "gpu.txt")
    args = ["genotype", "-a", bam, "-m", db, "--working_directory", gpu_dir,
            "-o", out]
    alarm = LogAlarm()
    root = logging.getLogger()
    root.addHandler(alarm)
    counter = CompileCounter()
    watch = ComputeAppWatch() if watch_cards else None
    try:
        if watch:
            watch.__enter__()
        n0 = counter.n
        cold_s = run_cli(args)
        cold_compiles = counter.n - n0
        cold = parse_text_output(out)
        clear_results(gpu_dir)
        profiler.STAGE_TOTALS.clear()
        profiler.STAGE_COUNTS.clear()
        n0 = counter.n
        warm_s = run_cli(args)
        warm_compiles = counter.n - n0
        stages = profiler.stage_summary()
        warm = parse_text_output(out)
        records = read_records(gpu_dir)
        trace = None
        if trace_dir:
            import jax
            clear_results(gpu_dir)
            jax.profiler.start_trace(trace_dir)
            traced_s = run_cli(args)
            jax.profiler.stop_trace()
            trace = trace_summary(trace_dir)
            trace["traced_wall_s"] = traced_s
            decode = [v for k, v in trace.get("modules_s", {}).items()
                      if "read_stats_struct" in k]
            trace["decode_device_s"] = sum(decode) if decode else None
            trace["decode_share_of_warm_wall"] = \
                sum(decode) / warm_s if decode else None
            trace["idle_share"] = 1 - trace.get("busy_s", 0.0) / traced_s
    finally:
        if watch:
            watch.__exit__()
        root.removeHandler(alarm)
    check(not alarm.failures(), f"analyzer errors: {alarm.failures()[:5]}")
    errors = [v for v, g in warm.items() if g == "Error"]
    check(not errors, f"error rows: {errors[:10]}")
    check(cold == warm, "cold and warm genotypes differ")
    check(len(warm) == n_loci, f"{len(warm)} of {n_loci} loci reported")

    # the CPU reference: the same command over the first loci, on the CPU
    cpu_vids = sorted(truth, key=int)[:n_cpu_loci]
    cpu_out = os.path.join(workdir, "cpu.txt")
    cpu_s = run_cli_child(
        ["genotype", "-a", bam, "-m", db, "--working_directory", cpu_dir,
         "-o", cpu_out, "-vid", ",".join(cpu_vids)], CPU_ONLY, 900)
    cpu = parse_text_output(cpu_out)
    cpu_right = [v for v in cpu_vids if cpu.get(v) == truth[v]]
    wrong = [v for v in cpu_right if warm.get(v) != truth[v]]
    check(not wrong, f"GPU misses loci the CPU calls right: {wrong}")
    numbers = {
        "n_loci": n_loci, "coverage": coverage, "cold_s": cold_s,
        "warm_s": warm_s, "executables_cold": cold_compiles,
        "executables_warm": warm_compiles,
        "accuracy": sum(warm[v] == truth[v] for v in truth) / len(truth),
        "cpu_loci": len(cpu_vids), "cpu_right": len(cpu_right),
        "cpu_wall_s": cpu_s, "stage_summary": stages, "trace": trace,
        "records": len(records)}
    try:
        numbers["peak_bytes_in_use"] = \
            device.memory_stats()["peak_bytes_in_use"]
    except (TypeError, KeyError):
        numbers["peak_bytes_in_use"] = None
    if watch:
        me = str(os.getpid())
        check(len(watch.pids) <= 1,
              f"more than one process holds the card: {sorted(watch.pids)}")
        numbers["compute_apps"] = sorted(watch.pids)
        numbers["compute_app_is_self"] = (not watch.pids
                                          or watch.pids == {me})
        numbers["nvidia_smi_samples"] = watch.samples
    return numbers


# ---------------------------------------------------------------------------
# phase 5: PacBio and frameshift through the CLI
# ---------------------------------------------------------------------------

PACBIO_SPECS = ((15, 20), (20, 12), (30, 25))   # (motif bp, ref copies)


def make_pacbio_panel(workdir: str, read_length: int, coverage: float,
                      long_tract: int, flank: int,
                      specs=PACBIO_SPECS, seed: int = 31):
    """PacBio loci of the given motif sizes and copy numbers, plus one whose
    tract (25 bp motif, ``long_tract`` bp) makes a decode window (tract
    plus two 100 bp flanks) past finder.CKPT_TRACEBACK_L."""
    from advntr_tpu.engine.simulate import simulate_pacbio_reads
    from advntr_tpu.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    from advntr_tpu.models.reference_vntr import ReferenceVNTR
    rng = random.Random(seed)
    db = os.path.join(workdir, "pacbio.db")
    fa = os.path.join(workdir, "pacbio.fa")
    create_vntrs_database(db)
    truth = {}
    specs = list(specs) + [(25, max(3, long_tract // 25))]
    with open(fa, "w") as fh:
        for i, (plen, copies) in enumerate(specs):
            pattern = "".join(rng.choice("ACGT") for _ in range(plen))
            ref = ReferenceVNTR(7000 + i, pattern, 100_000 * (i + 1), "chr1")
            ref.repeat_segments = [pattern] * copies
            ref.left_flanking_region = "".join(rng.choice("ACGT")
                                               for _ in range(flank))
            ref.right_flanking_region = "".join(rng.choice("ACGT")
                                                for _ in range(flank))
            ref.estimated_repeats = copies
            save_reference_vntr_to_database(ref, db)
            alleles = tuple(sorted((copies - 2, copies + 1)))
            reads, _, _ = simulate_pacbio_reads(
                ref.left_flanking_region, pattern, alleles[0], alleles[1],
                ref.right_flanking_region, read_length=read_length,
                coverage=coverage, seed=900 + i)
            for name, seq in reads:
                fh.write(f">L{ref.id}_{name}\n{seq}\n")
            truth[str(ref.id)] = "/".join(map(str, alleles))
    return db, fa, truth


def make_frameshift_fixture(workdir: str, frameshift: bool):
    """tests/test_frameshift_end_to_end.py's locus and reads, as a model DB
    and an unmapped BAM."""
    from advntr_tpu.engine.simulate import mutate
    from advntr_tpu.io.bam import BamRead, BamWriter
    from advntr_tpu.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    from advntr_tpu.models.reference_vntr import ReferenceVNTR

    def rand_seq(seed, n):
        r = random.Random(seed)
        return "".join(r.choice("ACGT") for _ in range(n))

    pattern, copies, read_length, coverage = "ACGGTCAGT", 8, 100, 30
    left, right = rand_seq(5, 200), rand_seq(6, 200)
    ref = ReferenceVNTR(25561, pattern, 3000, "chr1")
    ref.repeat_segments = [pattern] * copies
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    ref.estimated_repeats = copies
    tag = "fs" if frameshift else "clean"
    db = os.path.join(workdir, f"{tag}.db")
    bam = os.path.join(workdir, f"{tag}.bam")
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    rng = random.Random(2)
    vntr_b = (pattern * 3 + pattern[:4] + pattern[5:]
              + pattern * (copies - 4))
    haps = (left + pattern * copies + right,
            left + (vntr_b if frameshift else pattern * copies) + right)
    with BamWriter(bam, ["chr1"], [100_000]) as w:
        for h, hap in enumerate(haps):
            for k in range(int(len(hap) * coverage / 2 / read_length)):
                start = rng.randint(0, len(hap) - read_length)
                seq = mutate(hap[start:start + read_length], 0.001, rng)
                w.write(BamRead(f"h{h}r{k}", 4, -1, -1, 0, [], seq,
                                [38] * len(seq)))
    return db, bam


def phase_pacbio_frameshift(workdir: str, read_length: int = 10_000,
                            coverage: float = 30, long_tract: int = 2100,
                            flank: int = 5000, specs=PACBIO_SPECS):
    from advntr_tpu.engine.finder import CKPT_TRACEBACK_L
    os.makedirs(workdir, exist_ok=True)
    check(long_tract + 200 > CKPT_TRACEBACK_L,
          "the long PacBio locus must route to the checkpointed kernel")
    db, fa, truth = make_pacbio_panel(workdir, read_length, coverage,
                                      long_tract, flank, specs)
    out = os.path.join(workdir, "pacbio.txt")
    pb_dir = os.path.join(workdir, "pacbio")
    os.makedirs(pb_dir)
    alarm = LogAlarm()
    logging.getLogger().addHandler(alarm)
    try:
        pacbio_s = run_cli(["genotype", "-p", "-f", fa, "-m", db,
                            "--working_directory", pb_dir, "-o", out])
        calls = parse_text_output(out)
        check(calls == truth, f"PacBio calls {calls} != truth {truth}")
        fs_calls = {}
        for frameshift in (True, False):
            fdb, fbam = make_frameshift_fixture(workdir, frameshift)
            fdir = os.path.join(workdir, f"fs_{frameshift}")
            os.makedirs(fdir)
            fout = os.path.join(workdir, f"fs_{frameshift}.txt")
            run_cli(["genotype", "-fs", "-vid", "25561", "-a", fbam, "-m",
                     fdb, "--working_directory", fdir, "-o", fout])
            fs_calls[frameshift] = parse_text_output(fout).get("25561")
    finally:
        logging.getLogger().removeHandler(alarm)
    check(not alarm.failures(), f"analyzer errors: {alarm.failures()[:5]}")
    check(bool(fs_calls[True]) and fs_calls[True].startswith("D"),
          f"frameshift not called: {fs_calls[True]}")
    check(fs_calls[False] == "None",
          f"frameshift called on clean data: {fs_calls[False]}")
    return {"pacbio_loci": len(truth), "read_length": read_length,
            "long_tract_bp": long_tract, "pacbio_wall_s": pacbio_s,
            "pacbio_calls_equal_truth": True,
            "frameshift_call": fs_calls[True],
            "clean_call": fs_calls[False]}


# ---------------------------------------------------------------------------
# --four-cards: the panel on 4 cards, 1 card, and 4 pinned processes
# ---------------------------------------------------------------------------

SHARD_WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
from advntr_tpu.parallel.distributed import pin_to_card, run_sharded_panel
pid, nproc = {pid}, {nproc}
pin_to_card(pid)
from advntr_tpu.config import Config
from advntr_tpu.models.db import load_unique_vntrs_data
refs = load_unique_vntrs_data({db!r})
merged = run_sharded_panel(refs, sorted(r.id for r in refs), {bam!r},
                           {workdir!r}, Config(), process_id=pid,
                           num_processes=nproc)
if pid == 0:
    with open({merged!r}, "w") as fh:
        json.dump(merged, fh)
"""


def run_pinned_processes(db, bam, workdir, nproc, env_extra, timeout):
    """run_sharded_panel in ``nproc`` processes, process i pinned to card i
    before its JAX backend starts."""
    merged = os.path.join(workdir, "merged.json")
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_WORKER.format(
            repo=REPO, pid=p, nproc=nproc, db=db, bam=bam, workdir=workdir,
            merged=merged)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for p in range(nproc)]
    failed = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(err[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(not failed, f"pinned shard processes failed: {failed}")
    with open(merged) as fh:
        return {str(k): v for k, v in json.load(fh).items()}


def probe_devices(env_extra: dict) -> tuple[str, int]:
    """Platform and device count as a child process sees them, so that
    this process stays off the cards while its children use them."""
    env = dict(os.environ, **env_extra)
    code = ("import jax; d = jax.devices(); "
            "print(d[0].platform, len(d))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"device probe failed: {out.stderr[-500:]}")
    platform, count = out.stdout.split()[-2:]
    return platform, int(count)


def phase_four_cards(workdir: str, n_cards: int = 4, n_loci: int = 128,
                     coverage: float = 30, one_card_env: dict | None = None,
                     pinned_env: dict | None = None):
    """Per-locus records of the panel on ``n_cards`` cards (the analyzer's
    mesh), on one card, and from ``n_cards`` pinned processes must agree.
    The one-card run and the pinned processes run first, one after the
    other, while this process holds no card."""
    db, bam, truth = make_illumina_panel(workdir, n_loci, coverage)
    one_dir = os.path.join(workdir, "one")
    os.makedirs(one_dir)
    one_s = run_cli_child(
        ["genotype", "-a", bam, "-m", db, "--working_directory", one_dir,
         "-o", os.path.join(workdir, "one.txt")],
        one_card_env if one_card_env is not None
        else {"CUDA_VISIBLE_DEVICES": "0"}, 1200)
    one = read_records(one_dir)
    pin_dir = os.path.join(workdir, "pinned")
    os.makedirs(pin_dir)
    t0 = time.perf_counter()
    pinned = run_pinned_processes(db, bam, pin_dir, n_cards,
                                  pinned_env or {}, 1200)
    pinned_s = time.perf_counter() - t0

    import jax
    devices = jax.devices()
    check(len(devices) == n_cards,
          f"{len(devices)} devices visible, expected {n_cards}")
    mesh_dir = os.path.join(workdir, "mesh")
    os.makedirs(mesh_dir)
    from advntr_tpu.parallel import mesh as mesh_mod
    used = {"n": 0}
    orig = mesh_mod.sharded_grouped_read_stats

    def spy(*a, **kw):
        used["n"] += 1
        return orig(*a, **kw)

    mesh_mod.sharded_grouped_read_stats = spy
    alarm = LogAlarm()
    logging.getLogger().addHandler(alarm)
    try:
        mesh_s = run_cli(["genotype", "-a", bam, "-m", db,
                          "--working_directory", mesh_dir,
                          "-o", os.path.join(workdir, "mesh.txt")])
    finally:
        mesh_mod.sharded_grouped_read_stats = orig
        logging.getLogger().removeHandler(alarm)
    check(not alarm.failures(), f"analyzer errors: {alarm.failures()[:5]}")
    check(used["n"] > 0, "the analyzer did not use the device mesh")
    mesh = read_records(mesh_dir)
    check(len(one) == n_loci, f"one-card run has {len(one)} records")
    check(mesh == one, "4-card mesh records differ from the 1-card run: "
          + str([v for v in one if mesh.get(v) != one[v]][:10]))
    check(pinned == one, "pinned-process records differ from the 1-card "
          "run: " + str([v for v in one if pinned.get(v) != one[v]][:10]))
    check(not any(r["error"] for r in one.values()), "error rows")
    genotypes = {v: "/".join(map(str, sorted(r["copy_numbers"])))
                 if r["copy_numbers"] else None for v, r in one.items()}
    return {"n_loci": n_loci, "cards": n_cards, "one_card_s": one_s,
            "pinned_processes_s": pinned_s, "mesh_s": mesh_s,
            "mesh_dispatches": used["n"],
            "accuracy": sum(genotypes[v] == truth[v] for v in truth)
            / len(truth), "records_identical": True}


# ---------------------------------------------------------------------------

def run_phases(phases) -> list[str]:
    """Run each (name, fn) in turn; a failure is reported and the next
    phase still runs.  Returns the names of the phases that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            numbers = fn()
            numbers["phase_s"] = time.perf_counter() - t0
            emit(name, numbers)
        except Exception as error:  # report every phase, then fail
            import traceback
            traceback.print_exc()
            print(f"{name} FAILED: {error}", file=sys.stderr, flush=True)
            failed.append(name)
    return failed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    # the package must be importable before anything is printed
    import advntr_tpu  # noqa: F401
    from advntr_tpu.runtime import enable_compilation_cache

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if four:
            platform, count = probe_devices({})
            if platform != "gpu":
                raise SystemExit(
                    f"chip_smoke.py needs a GPU; JAX found {platform}")
            check(count >= 4, f"--four-cards needs 4 GPUs, found {count}")
            for line in card_lines():
                print(line, flush=True)
            enable_compilation_cache()
            failed = run_phases(
                [("four_cards", lambda: phase_four_cards(workdir))])
            import jax
            devices = jax.devices()
        else:
            import jax
            devices = jax.devices()
            require_gpu(devices)
            for line in card_lines():
                print(line, flush=True)
            enable_compilation_cache()
            gpu, cpu = devices[0], jax.devices("cpu")[0]
            traces = os.path.join(workdir, "traces")
            failed = run_phases([
                ("phase1_kernel_parity", lambda: phase_kernel_parity(
                    gpu, cpu, trace_dir=os.path.join(traces, "bench"))),
                ("phase2_long_reads", lambda: phase_long_reads(gpu, cpu)),
                ("phase3_recruitment", lambda: phase_recruitment(gpu, cpu)),
                ("phase4_6_panel", lambda: phase_panel(
                    gpu, os.path.join(workdir, "panel"),
                    trace_dir=os.path.join(traces, "panel"))),
                ("phase5_pacbio_frameshift", lambda: phase_pacbio_frameshift(
                    os.path.join(workdir, "pacbio"))),
            ])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr, flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
