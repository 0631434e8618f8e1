"""Per-locus VNTR genotyping engine.

Capability-equivalent to the reference ``VNTRFinder``
(advntr/vntr_finder.py:59-887) but organized around batched device scoring:
all candidate reads of a locus (mapped, plus both orientations of unmapped)
are encoded, padded and decoded in one fused Viterbi+analytics kernel call;
the host only applies the cheap scalar gates and the genotype model.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import jax.numpy as jnp

from advntr_tpu import dna
from advntr_tpu.config import Config, DEFAULT_CONFIG
from advntr_tpu.engine import device_analytics as da
from advntr_tpu.engine.genotype import find_genotype, identify_frameshift
from advntr_tpu.models.compiler import compile_graph, expand_path
from advntr_tpu.models.graph import build_read_matcher
from advntr_tpu.models.profile import profile_for_repeats
from advntr_tpu.utils.profiler import time_usage


@dataclasses.dataclass
class GenotypeResult:
    copy_numbers: tuple | None
    recruited_reads_count: int
    spanning_reads_count: int
    flanking_reads_count: int
    maximum_likelihood: float


class FrameshiftCall(str):
    """Frameshift candidate state name (a plain str for reference-parity
    printing/comparison) carrying the posterior indel-support report as
    attributes: ``lr_support`` (Viterbi-path indel count that fed the
    binomial LR) and ``posterior`` (frameshift_posterior dict or None)."""
    lr_support: int = 0
    posterior: dict | None = None


@dataclasses.dataclass
class ScoredRead:
    sequence: str
    logp: float
    repeats: int
    repeat_bp: int
    left_flank_bp: int
    right_flank_bp: int
    flank_rate: float
    flank_rate_strict: float
    n_matches: int
    is_mapped: bool
    query_name: str | None = None
    row: int = -1  # batch row of the winning orientation (for path fetch)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class LocusModel:
    """Everything score_reads needs for one compiled locus model."""
    art: object                    # unpadded ModelArtifact (decode tables)
    meta: tuple                    # analytics tensors (artifact space)
    struct: object | None          # padded StructDeviceModel
    suffix_last: int
    dense: object | None = None    # DeviceModel fallback (no struct model)


# reads longer than this route to the checkpointed (recompute) traceback:
# the plain struct kernel keeps one (B, ~3P) value plane per read column,
# so past ~2k columns those planes outgrow device memory.  The threshold
# and segment length were sized for a 16 GB card and still await
# re-derivation on the current one.
CKPT_TRACEBACK_L = int(os.environ.get("ADVNTR_TPU_CKPT_L", "2048"))
CKPT_SEGMENT = int(os.environ.get("ADVNTR_TPU_CKPT_SEGMENT", "512"))


def _host_only_worker() -> None:
    """Process-pool initializer: model builders are host-only numpy work,
    so hide every accelerator from them.  A worker that initialized a GPU
    backend would reserve most of the card's memory next to the parent."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def host_process_pool(workers: int):
    """Spawn-context pool of host-only workers.  Spawn, not fork: the pool
    is created after JAX's (multithreaded) runtime starts, and a forked
    child can inherit a held lock; forking after CUDA initializes is
    unsafe outright."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_host_only_worker)


def build_locus_payload(ref_vntr, copies: int, flank_size: int,
                        error_rate: float):
    """Host-side model construction for one locus: profile estimation,
    graph build, silent-state elimination, structured extraction.
    Pure numpy output (picklable) so it can run in worker processes."""
    from advntr_tpu.models.struct_compiler import build_structured
    left = ref_vntr.left_flanking_region[-flank_size:]
    right = ref_vntr.right_flanking_region[:flank_size]
    trans, emis = profile_for_repeats(
        list(ref_vntr.get_repeat_segments()), error_rate)
    g = build_read_matcher(left, right, trans, emis, copies, error_rate)
    art = compile_graph(g)
    sm = build_structured(g, art)
    return art, sm


def bank_payload_path(bank_dir: str, vid, copies: int, flank_size: int,
                      error_rate: float) -> str:
    """Canonical per-locus bank filename (shared by LocusModelCache and the
    offline ``buildbank`` CLI so banks are reusable across runs and across
    ``--models`` paths: the key is locus parameters, not the DB file)."""
    return os.path.join(bank_dir, "model_%s_%s_%s_%s.pkl.gz"
                        % (vid, copies, flank_size, error_rate))


def build_and_save_payload(ref_vntr, copies: int, flank_size: int,
                           error_rate: float, path: str) -> str:
    """Worker for offline bank construction: build one locus payload and
    atomically publish it (tmp + rename so concurrent builders and readers
    never see a torn pickle)."""
    import gzip
    import pickle
    if os.path.exists(path):
        return path
    payload = build_locus_payload(ref_vntr, copies, flank_size, error_rate)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with gzip.open(tmp, "wb", compresslevel=1) as fh:
        pickle.dump(payload, fh)
    os.replace(tmp, path)
    return path


class LocusModelCache:
    """Per-(locus, read-length-bucket) compiled model cache.

    Pads the structured position/unit axes to buckets so XLA compiles one
    executable per bucket, not per locus (the reference re-builds a
    pomegranate model per locus and read length, vntr_finder.py:117-138).

    Optional scale-out of the host-side model compilation:
    - ``workers``: a process pool builds scheduled loci concurrently so
      model compilation overlaps device scoring of earlier loci
    - ``bank_dir``: compiled payloads are pickled to disk and reused across
      runs (the compiled model-bank checkpoint; the reference's analog is
      its per-(locus, read-length) HMM JSON cache, vntr_finder.py:117-138)
    """

    def __init__(self, state_bucket: int = 128, pos_bucket: int = 128,
                 unit_bucket: int = 8, use_struct: bool = True,
                 workers: int = 0, bank_dir: str | None = None):
        self.state_bucket = state_bucket
        self.pos_bucket = pos_bucket
        self.unit_bucket = unit_bucket
        self.use_struct = use_struct
        self.bank_dir = bank_dir
        self._cache: dict = {}
        self._futures: dict = {}
        self._pool = None
        if workers:
            self._pool = host_process_pool(workers)

    @staticmethod
    def _key(ref_vntr, copies, flank_size, error_rate):
        return (ref_vntr.id, copies, flank_size, error_rate)

    def _bank_path(self, key):
        if not self.bank_dir:
            return None
        return bank_payload_path(self.bank_dir, *key)

    def schedule(self, ref_vntr, copies: int, flank_size: int,
                 error_rate: float) -> None:
        """Queue background compilation of a locus model."""
        key = self._key(ref_vntr, copies, flank_size, error_rate)
        if key in self._cache or key in self._futures or self._pool is None:
            return
        path = self._bank_path(key)
        if path is not None:
            import os
            if os.path.exists(path):
                return  # bank hit; loaded lazily in get()
        self._futures[key] = self._pool.submit(
            build_locus_payload, ref_vntr, copies, flank_size, error_rate)

    def get(self, ref_vntr, copies: int, flank_size: int,
            error_rate: float) -> LocusModel:
        key = self._key(ref_vntr, copies, flank_size, error_rate)
        if key in self._cache:
            return self._cache[key]
        import gzip
        import os
        import pickle
        payload = None
        built = False
        fut = self._futures.pop(key, None)
        if fut is not None:
            payload = fut.result()
            built = True
        if payload is None:
            path = self._bank_path(key)
            if path is not None and os.path.exists(path):
                with gzip.open(path, "rb") as fh:
                    payload = pickle.load(fh)
        if payload is None:
            payload = build_locus_payload(ref_vntr, copies, flank_size,
                                          error_rate)
            built = True
        if built:
            # persist pool-built payloads too: the no-prebank genome mode
            # builds its bank inside the run
            path = self._bank_path(key)
            if path is not None and not os.path.exists(path):
                os.makedirs(self.bank_dir, exist_ok=True)
                tmp = "%s.tmp.%d" % (path, os.getpid())
                with gzip.open(tmp, "wb", compresslevel=1) as fh:
                    pickle.dump(payload, fh)
                os.replace(tmp, path)
        art, sm = payload
        self._cache[key] = self._build_from_payload(art, sm)
        return self._cache[key]

    def evict(self, ref_vntr, copies: int, flank_size: int,
              error_rate: float) -> None:
        """Drop a locus's compiled model from the in-RAM cache (the bank
        copy on disk, if any, is untouched).  Panel runs hold ~14 MB of
        host decode tables per locus; genome-scale panels (158,522 loci,
        reference README.md:34-35) must evict completed waves or the host
        OOMs long before the device does."""
        self._cache.pop(self._key(ref_vntr, copies, flank_size,
                                  error_rate), None)

    def _build(self, g, art) -> LocusModel:
        sm = None
        if self.use_struct:
            from advntr_tpu.models.struct_compiler import build_structured
            sm = build_structured(g, art)
        return self._build_from_payload(art, sm)

    @staticmethod
    def _coarse_bucket(size: int, bucket: int) -> int:
        """Coarsen shape buckets above the Illumina scale: axes past 1024
        pad to 512-multiples (PacBio tract-length spread would otherwise
        compile one executable per locus); Illumina-panel shapes
        (n_states<=1024, P<=512) keep the fine default buckets and their
        existing executables."""
        return max(bucket, 512) if size > 1024 else bucket

    def _build_from_payload(self, art, sm) -> LocusModel:
        import jax.numpy as jnp
        # metadata vectors padded to the state bucket so same-bucket loci
        # can stack into one grouped executable
        n_pad = _round_up(art.n_states,
                          self._coarse_bucket(art.n_states,
                                              self.state_bucket))
        meta = tuple(
            jnp.asarray(_pad_vector(v, n_pad, fill))
            for v, fill in ((art.kind, 3), (art.region, 3),
                            (art.exp_base, -1), (art.unit, -1)))
        struct = None
        suffix_last = -1
        if self.use_struct and sm is not None:
            from advntr_tpu.models.struct_compiler import pad_structured
            from advntr_tpu.ops.viterbi_struct import StructDeviceModel
            P_pad = _round_up(sm.P + 1,
                              self._coarse_bucket(sm.P + 1, self.pos_bucket))
            C_pad = _round_up(sm.C, self.unit_bucket if sm.C <= 24
                              else max(self.unit_bucket, 32))
            sm = pad_structured(sm, art, P_pad, C_pad)
            suffix_last = sm.suffix_last
            struct = StructDeviceModel.from_struct(sm, art)
        dense = None
        if struct is None:
            dense = da.DeviceModel.from_artifact(_pad_artifact(art, n_pad))
        return LocusModel(art=art, meta=meta, struct=struct,
                          suffix_last=suffix_last, dense=dense)


def _pad_vector(x, n_pad: int, fill):
    x = np.asarray(x)
    if x.shape[0] == n_pad:
        return x
    out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _pad_artifact(art, n_pad: int):
    """Pad an artifact to n_pad states with unreachable dummy states."""
    n = art.n_states
    if n_pad == n:
        return art
    pad = n_pad - n

    def pad2(x, fill):
        out = np.full((n_pad, n_pad), fill, dtype=x.dtype)
        out[:n, :n] = x
        return out

    def pad1(x, fill):
        out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    return dataclasses.replace(
        art,
        log_T=pad2(art.log_T, -np.inf),
        log_E=pad1(art.log_E, -np.inf),
        log_start=pad1(art.log_start, -np.inf),
        log_end=pad1(art.log_end, -np.inf),
        t_unit_starts=pad2(art.t_unit_starts, 0),
        t_unit_ends=pad2(art.t_unit_ends, 0),
        s_unit_starts=pad1(art.s_unit_starts, 0),
        s_unit_ends=pad1(art.s_unit_ends, 0),
        e_unit_starts=pad1(art.e_unit_starts, 0),
        e_unit_ends=pad1(art.e_unit_ends, 0),
        kind=pad1(art.kind, 3), region=pad1(art.region, 3),
        pos=pad1(art.pos, 0), unit=pad1(art.unit, -1),
        exp_base=pad1(art.exp_base, -1),
        names=art.names + [f"__pad_{i}" for i in range(pad)],
    )


_GLOBAL_MODEL_CACHE = LocusModelCache()


def flank_pattern_homology(pattern: str, left_flank: str,
                           right_flank: str) -> tuple[int, int]:
    """(left, right) homology runs between the flanks and the repeat.

    right = the longest prefix of the right flank that continues some
    rotation of the pattern (a read ending mid-unit continues the tract at
    an arbitrary rotation); left = the symmetric longest flank suffix that
    precedes some rotation.  Bounded by the flank length scanned."""
    if not pattern:
        return 0, 0
    p = len(pattern)
    best_r = 0
    for r in range(p):
        tiled = (pattern[r:] + pattern * (len(right_flank) // p + 1))
        k = 0
        while k < len(right_flank) and right_flank[k] == tiled[k]:
            k += 1
        best_r = max(best_r, k)
    best_l = 0
    rev_f = left_flank[::-1]
    rev_p = pattern[::-1]
    for r in range(p):
        tiled = (rev_p[r:] + rev_p * (len(left_flank) // p + 1))
        k = 0
        while k < len(rev_f) and rev_f[k] == tiled[k]:
            k += 1
        best_l = max(best_l, k)
    return best_l, best_r


class VNTRFinder:
    """Find the VNTR genotype of one locus in a pool of candidate reads."""

    def __init__(self, reference_vntr, config: Config = DEFAULT_CONFIG,
                 is_haploid: bool = False,
                 model_cache: LocusModelCache | None = None):
        self.reference_vntr = reference_vntr
        self.config = config
        self.is_haploid = is_haploid
        self.cache = model_cache or _GLOBAL_MODEL_CACHE
        # optional GC coverage-bias corrector for the expansion workload
        # (set by the analyzer when --expansion runs with a reference FASTA)
        self.coverage_corrector = None
        # reference: vntr_finder.py:66-73
        self.min_repeat_bp_to_add_read = 2
        self.min_repeat_bp_to_count_repeats = 2
        self.minimum_flanking_size = 5
        self.minimum_left_flanking_size = 5
        self.minimum_right_flanking_size = 5
        if config.spanning_homology_guard:
            # flank bp that continues the repeat pattern verbatim is
            # indistinguishable from tract sequence, so it carries zero
            # spanning evidence: raise each side's flank-bp minimum to at
            # least the flank<->pattern homology run.  At loci whose flank
            # shares no prefix/suffix with the pattern this is a no-op
            # (reference behavior unchanged); at homologous loci it stops
            # mid-tract reads from masquerading as spanning (the reference
            # has the same failure mode and only its --accuracy_filter
            # flank minima of 10, settings.py:42-43, paper over it).
            lh, rh = flank_pattern_homology(
                reference_vntr.pattern,
                reference_vntr.left_flanking_region,
                reference_vntr.right_flanking_region)
            self.minimum_left_flanking_size = max(
                self.minimum_left_flanking_size, lh)
            self.minimum_right_flanking_size = max(
                self.minimum_right_flanking_size, rh)
        self.vntr_start = reference_vntr.start_point
        self.vntr_end = self.vntr_start + reference_vntr.get_length()

    # -- model construction --------------------------------------------------

    def get_copies_for_hmm(self, read_length: int) -> int:
        # reference: vntr_finder.py:98-99
        return int(round(read_length / len(self.reference_vntr.pattern) + 0.5))

    def get_model(self, read_length: int, copies: int | None = None,
                  flank_size: int | None = None):
        trained = self._load_trained_hmm(read_length)
        if trained is not None:
            return trained
        copies = copies if copies is not None else self.get_copies_for_hmm(read_length)
        flank_size = flank_size if flank_size is not None else read_length
        return self.cache.get(self.reference_vntr, copies, flank_size,
                              self.config.max_error_rate)

    def _load_trained_hmm(self, read_length: int):
        """Per-(locus, read-length) pomegranate-JSON checkpoint, if a
        trained-HMM cache dir is configured (reference
        vntr_finder.py:117-138: <TRAINED_HMMS_DIR>/<vid>_<readlen>.json)."""
        if not self.config.trained_hmms_dir:
            return None
        key = ("trained", self.reference_vntr.id, read_length)
        cached = getattr(self, "_trained_cache", {})
        if key in cached:
            return cached[key]
        path = os.path.join(self.config.trained_hmms_dir,
                            f"{self.reference_vntr.id}_{read_length}.json")
        lm = None
        if os.path.exists(path):
            from advntr_tpu.models.compiler import compile_graph
            from advntr_tpu.models.hmm_json import load_trained_hmm
            g = load_trained_hmm(path)
            art = compile_graph(g)
            try:
                lm = self.cache._build(g, art)
            except Exception:
                # imported topology outside the struct extractor's shape:
                # fall back to the dense kernel
                lm = self.cache._build_from_payload(art, None)
            logging.info("loaded trained HMM %s", path)
        cached[key] = lm
        self._trained_cache = cached
        return lm

    def _load_dnn_model(self):
        """Per-locus DNN recruitment model, if trained
        (reference: vntr_finder.py:755-759, model file dnn_models/<vid>)."""
        import os
        if getattr(self, "_dnn_cache", "unset") != "unset":
            return self._dnn_cache
        from advntr_tpu.engine import deep_recruitment as dr
        path = os.path.join(self.config.dnn_models_dir,
                            f"{self.reference_vntr.id}.npz")
        self._dnn_cache = dr.load_model(path)
        return self._dnn_cache

    def get_unique_left_flank(self) -> int:
        """Shortest left-flank margin distinguishable from the tandem array
        (reference semantics: vntr_finder.py:78-86)."""
        from advntr_tpu.ops.align import global_align_score
        patterns = self.reference_vntr.get_repeat_segments()[0] * 10
        left = self.reference_vntr.left_flanking_region
        for i in range(self.minimum_flanking_size, 30):
            if global_align_score(patterns[-i:], left[-i:]) < i * 0.5:
                return i
        return 30

    def get_unique_right_flank(self) -> int:
        """Shortest right-flank margin distinguishable from the tandem array
        (reference semantics: vntr_finder.py:88-96)."""
        from advntr_tpu.ops.align import global_align_score
        patterns = self.reference_vntr.get_repeat_segments()[-1] * 10
        right = self.reference_vntr.right_flanking_region
        for i in range(self.minimum_flanking_size, 30):
            if global_align_score(patterns[:i], right[:i]) < i * 0.5:
                return i
        return 30

    def recruitment_score_threshold(self, read_length: int):
        # reference: vntr_finder.py:174-177
        score = self.reference_vntr.scaled_score
        if score is None or score == 0:
            return None
        return score * read_length

    # -- scoring -------------------------------------------------------------

    def prepare_rows(self, mapped_reads, unmapped_reads):
        """Host-side batch prep: N-filter, DNN pre-screen, both orientations
        of unmapped reads.  Returns (reads, rows, row_info)."""
        rows: list[np.ndarray] = []
        row_info = []  # (read_index, orientation)
        reads = []
        for name, seq in mapped_reads:
            seq = seq.upper()
            if dna.has_n(seq):
                continue
            reads.append((name, seq, True))
        for name, seq in unmapped_reads:
            seq = seq.upper()
            if dna.has_n(seq):
                continue
            reads.append((name, seq, False))

        # optional DNN pre-screen of unmapped-read orientations
        # (reference: process_unmapped_read_with_dnn, vntr_finder.py:192-233)
        dnn_pass = None
        dnn_params = self._load_dnn_model()
        if dnn_params is not None and reads:
            from advntr_tpu.engine import deep_recruitment as dr
            emb_rows = []
            emb_info = []
            for ri, (name, seq, is_mapped) in enumerate(reads):
                if is_mapped:
                    continue
                codes = dna.encode(seq)
                emb_rows.append(codes)
                emb_info.append((ri, 0))
                emb_rows.append(dna.revcomp_codes(codes))
                emb_info.append((ri, 1))
            if emb_rows:
                eb, el = dna.pad_batch(emb_rows, multiple=8)
                emb = dr.embed_batch(eb, el)
                probs = np.asarray(dr.predict(dnn_params, emb))
                dnn_pass = {info: bool(probs[k, 0] > probs[k, 1])
                            for k, info in enumerate(emb_info)}

        for ri, (name, seq, is_mapped) in enumerate(reads):
            codes = dna.encode(seq)
            if is_mapped:
                rows.append(codes)
                row_info.append((ri, 0))
                continue
            fwd_ok = dnn_pass is None or dnn_pass.get((ri, 0), False)
            rev_ok = dnn_pass is None or dnn_pass.get((ri, 1), False)
            if fwd_ok:
                rows.append(codes)
                row_info.append((ri, 0))
            if rev_ok:
                rows.append(dna.revcomp_codes(codes))
                row_info.append((ri, 1))
        return reads, rows, row_info

    @staticmethod
    def pad_rows(rows, length_bucket: int = 32, pad_to: int | None = None,
                 b_pad: int | None = None):
        """Pad rows into a (B, L) batch with bucketed dimensions.

        Without an explicit pad_to, the length bucket coarsens with read
        length (<=256: 32-multiples; <=1024: 128; beyond: 512) so a panel
        of varied PacBio window lengths lands in a handful of executables
        instead of one Mosaic compile per locus; Illumina-length reads are
        unaffected."""
        if pad_to is None and rows:
            maxlen = max(len(r) for r in rows)
            if maxlen > 1024:
                length_bucket = max(length_bucket, 512)
            elif maxlen > 256:
                length_bucket = max(length_bucket, 128)
        batch, lengths = dna.pad_batch(rows, pad_to=pad_to,
                                       multiple=length_bucket)
        if b_pad is None:
            b_pad = 1 << (len(rows) - 1).bit_length()
        if b_pad != len(rows):
            batch = np.concatenate(
                [batch, np.zeros((b_pad - len(rows), batch.shape[1]),
                                 dtype=batch.dtype)])
            lengths = np.concatenate(
                [lengths, np.ones(b_pad - len(rows), dtype=lengths.dtype)])
        return batch, lengths

    def collect_scored(self, reads, row_info, stats) -> list[ScoredRead]:
        """Host-side post-processing: orientation resolution + ScoredReads."""
        rates = da.flank_rates(stats, accuracy_filter=False)
        best_row: dict[int, int] = {}
        for row, (ri, orient) in enumerate(row_info):
            cur = best_row.get(ri)
            if cur is None or stats["logp"][row] > stats["logp"][cur]:
                best_row[ri] = row
        scored = []
        for ri, (name, seq, is_mapped) in enumerate(reads):
            if ri not in best_row:
                continue  # DNN-screened out in both orientations
            row = best_row[ri]
            orient = row_info[row][1]
            seq_used = seq if orient == 0 else dna.revcomp(seq)
            scored.append(ScoredRead(
                sequence=seq_used,
                logp=float(stats["logp"][row]),
                repeats=int(stats["repeats"][row]),
                repeat_bp=int(stats["repeat_bp"][row]),
                left_flank_bp=int(stats["left_flank_bp"][row]),
                right_flank_bp=int(stats["right_flank_bp"][row]),
                flank_rate=float(rates[row]),
                flank_rate_strict=float(rates[row]),
                n_matches=int(stats["n_matches"][row]),
                is_mapped=is_mapped,
                query_name=name,
                row=row,
            ))
        return scored

    def counts_from_stats(self, reads, row_info, stats,
                          read_length: int, accuracy_filter: bool = False):
        """Vectorized recruit gates + RU-count extraction (numpy, no
        per-read Python objects) — the grouped panel path's fast lane.
        Produces exactly what genotype_from_counts consumes; equivalence
        with the ScoredRead path is covered by tests."""
        R = len(row_info)
        if R == 0:
            return [], [], 0, 0
        read_idx = np.fromiter((ri for ri, _ in row_info), dtype=np.int64,
                               count=R)
        logp = np.asarray(stats["logp"][:R], dtype=np.float64)
        n_reads = len(reads)
        # best orientation per read (first row wins ties, matching the
        # sequential strict-> comparison in collect_scored)
        best_val = np.full(n_reads, -np.inf)
        np.maximum.at(best_val, read_idx, logp)
        is_best = logp == best_val[read_idx]
        rows_rev = np.arange(R)[is_best][::-1]
        first_best = np.full(n_reads, -1, dtype=np.int64)
        first_best[read_idx[is_best][::-1]] = rows_rev
        sel = first_best[first_best >= 0]
        if sel.size == 0:
            return [], [], 0, 0

        rates = da.flank_rates(stats)[sel]
        seq_lens = np.fromiter(
            (len(reads[i][1]) for i in np.nonzero(first_best >= 0)[0]),
            dtype=np.int64, count=sel.size)
        lp = logp[sel]
        n_matches = np.asarray(stats["n_matches"])[sel]
        repeat_bp = np.asarray(stats["repeat_bp"])[sel]
        left_bp = np.asarray(stats["left_flank_bp"])[sel]
        right_bp = np.asarray(stats["right_flank_bp"])[sel]
        repeats = np.asarray(stats["repeats"])[sel]

        min_score = self.recruitment_score_threshold(read_length)
        finite = np.isfinite(lp)
        gate_rate = rates >= 0.90
        if min_score is not None:
            recruited = gate_rate & (lp > min_score)
        else:
            recruited = gate_rate & (n_matches >= 0.9 * seq_lens) & \
                (lp > -seq_lens)
        selected = finite & recruited & \
            (repeat_bp > self.min_repeat_bp_to_add_read)

        spanning = selected & (rates >= 0.95) & \
            (left_bp > self.minimum_left_flanking_size) & \
            (right_bp > self.minimum_right_flanking_size)
        covered_repeats = repeats[spanning].tolist()
        if accuracy_filter:
            # the reference does not collect flanking reads in this mode
            # (vntr_finder.py:838-845)
            flanking_repeats = []
        else:
            flanking_repeats = repeats[selected & ~spanning].tolist()
        return (covered_repeats, flanking_repeats, int(selected.sum()),
                int(repeat_bp[selected].sum()))

    def genotype_from_counts(self, covered_repeats, flanking_repeats,
                             n_selected: int,
                             accuracy_filter: bool = False,
                             average_coverage=None) -> GenotypeResult:
        """Count-combination + ML genotype (shared tail of
        genotype_from_selected, reference vntr_finder.py:848-887)."""
        flanking_repeats = sorted(flanking_repeats)
        min_valid_flanked = max(covered_repeats) if covered_repeats else 0
        max_flanking_repeat = [r for r in flanking_repeats
                               if r == max(flanking_repeats)
                               and r >= min_valid_flanked] \
            if flanking_repeats else []
        if len(max_flanking_repeat) < 5:
            max_flanking_repeat = []
        if accuracy_filter:
            covered_repeats = _filter_by_support(
                covered_repeats, self.config.accuracy_filter_sr_min_support)
            max_flanking_repeat = []
        genotype, max_prob = find_genotype(
            covered_repeats + max_flanking_repeat, self.is_haploid,
            self.config.genotype_error_rate)
        if average_coverage:
            pattern_occurrences = sum(flanking_repeats) + sum(covered_repeats)
            if self.coverage_corrector is not None:
                # GC-bias correction: rescale the observed occurrence mass
                # to the GC-neutral coverage scale before dividing by the
                # genome-wide average (engine/coverage_bias.py; reference
                # model advntr/coverage_bias.py:109-117)
                pattern_occurrences = \
                    self.coverage_corrector.get_scaled_coverage(
                        self.reference_vntr, pattern_occurrences)
            haplotypes = 1 if self.is_haploid else 2
            estimate = int(pattern_occurrences /
                           (float(average_coverage) * haplotypes))
            return GenotypeResult([estimate, estimate], n_selected,
                                  len(covered_repeats),
                                  len(flanking_repeats), 0)
        return GenotypeResult(genotype, n_selected, len(covered_repeats),
                              len(flanking_repeats), max_prob)

    def run_device(self, lm, batch, lengths, return_paths: bool = False):
        """Decode one padded (B, L) batch: the struct kernel, or its
        checkpointed twin for reads past CKPT_TRACEBACK_L columns (same
        per-column math, O(segment) plane memory); loci without a struct
        model use the dense kernel."""
        batch, lengths = jnp.asarray(batch), jnp.asarray(lengths)
        if lm.struct is None:
            stats = da.read_stats(lm.dense.flat(), batch, lengths,
                                  return_path=return_paths)
        elif batch.shape[1] > CKPT_TRACEBACK_L:
            stats = da.read_stats_struct_ckpt(
                lm.struct.flat(), lm.meta, batch, lengths, lm.suffix_last,
                return_path=return_paths, segment=CKPT_SEGMENT)
        else:
            stats = da.read_stats_struct(
                lm.struct.flat(), lm.meta, batch, lengths, lm.suffix_last,
                return_path=return_paths)
        return {k: np.asarray(v) for k, v in stats.items()}

    @time_usage
    def score_reads(self, mapped_reads, unmapped_reads, read_length: int,
                    model=None, length_bucket: int = 32,
                    return_paths: bool = False):
        """Batch-score candidate reads.

        mapped_reads / unmapped_reads: lists of (name, sequence) tuples;
        unmapped reads are scored in both orientations and the better one
        wins (reference: vntr_finder.py:235-246).

        Returns a list of ScoredRead (one per input read, skipping reads
        containing N), plus the raw device stats when return_paths.
        """
        lm = model if model is not None else self.get_model(read_length)
        reads, rows, row_info = self.prepare_rows(mapped_reads,
                                                  unmapped_reads)
        if not rows:
            return [], None
        batch, lengths = self.pad_rows(rows, length_bucket)
        stats = self.run_device(lm, batch, lengths, return_paths)
        return self.collect_scored(reads, row_info, stats), stats

    # -- recruitment gate (reference: vntr_finder.py:179-190) ----------------

    def recruit_read(self, read: ScoredRead, min_score) -> bool:
        if read.flank_rate < 0.90:
            return False
        read_length = len(read.sequence)
        if min_score is not None and read.logp > min_score:
            return True
        if min_score is None and read.n_matches >= 0.9 * read_length \
                and read.logp > -read_length:
            return True
        return False

    def spans_with_confidence(self, read: ScoredRead) -> bool:
        # reference: vntr_finder.py:311-322
        if read.flank_rate < 0.95:
            return False
        return (read.left_flank_bp > self.minimum_left_flanking_size and
                read.right_flank_bp > self.minimum_right_flanking_size)

    # -- top-level Illumina genotyping ---------------------------------------

    def select_reads(self, mapped_reads, unmapped_reads, read_length: int,
                     return_paths: bool = False, model=None):
        scored, stats = self.score_reads(mapped_reads, unmapped_reads,
                                         read_length, model=model,
                                         return_paths=return_paths)
        return self.select_from_scored(scored, read_length), stats

    # -- model updating (reference: iteratively_update_model,
    #    vntr_finder.py:668-698) ---------------------------------------------

    def rebuild_model_from_vpaths(self, seq_vpaths, read_length: int):
        """Re-estimate the repeat profile from the MSA of decoded unit paths
        and rebuild the read-matcher model (the --update path; the reference
        builds it via get_read_matcher_model(..., vpaths),
        hmm_utils.py:553-555 + profile_hmm.py:13)."""
        from advntr_tpu.engine import analytics as an
        from advntr_tpu.models.msa import msa_from_viterbi_paths
        from advntr_tpu.models.profile import profile_from_alignment

        repeats_sequences: list[str] = []
        repeats_states: list[list[str]] = []
        for seq, visited in seq_vpaths:
            reps, vps = an.extract_repeating_segments(seq, visited)
            repeats_sequences += reps
            repeats_states += vps
        if not repeats_sequences:
            return None
        alignment = msa_from_viterbi_paths(repeats_sequences, repeats_states)
        trans, emis = profile_from_alignment(self.config.max_error_rate,
                                             alignment)
        flank_size = read_length
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        copies = self.get_copies_for_hmm(read_length)
        g = build_read_matcher(left, right, trans, emis, copies,
                               self.config.max_error_rate)
        art = compile_graph(g)
        return self.cache._build(g, art)

    def update_and_reselect(self, mapped_reads, unmapped_reads,
                            read_length: int):
        """One model-update iteration: decode selected reads + reference
        repeat units, re-estimate, re-select (the reference's loop
        effectively runs a single iteration: its fitness is computed from
        the pre-update read set and never changes, vntr_finder.py:692-695)."""
        art = self.get_model(read_length).art
        selected, stats = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, return_paths=True)
        seq_vpaths = []
        for read in selected:
            path = stats["path"][read.row][: len(read.sequence)]
            seq_vpaths.append((read.sequence, expand_path(art, path)))
        # the reference repeat segments join the update set
        # (vntr_finder.py:673-677)
        ref_repeats = [(f"ref{i}", s.upper()) for i, s in
                       enumerate(self.reference_vntr.get_repeat_segments())]
        ref_scored, ref_stats = self.score_reads(
            ref_repeats, [], read_length, return_paths=True)
        for read in ref_scored:
            if not np.isfinite(read.logp):
                continue
            path = ref_stats["path"][read.row][: len(read.sequence)]
            seq_vpaths.append((read.sequence, expand_path(art, path)))
        updated = self.rebuild_model_from_vpaths(seq_vpaths, read_length)
        if updated is None:
            return selected
        new_selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, model=updated)
        return new_selected

    def em_update_and_reselect(self, mapped_reads, unmapped_reads,
                               read_length: int, max_iters: int = 5):
        """EM-based model update (``--update --em``): select reads, run
        batched Baum-Welch over their sequences (ops/baum_welch.py), fold
        the EM-updated repeat-unit emissions back into the profile
        (averaged across unit copies), rebuild the model, and re-select.

        Emission-only by design: EM runs on the silent-eliminated
        first-order model, whose transitions close delete chains away, so
        only the emission rows map bijectively back onto profile states
        (M{i}/I{i}); transitions keep the reference profile estimation.
        Reference capability: pomegranate hmm.pyx:2369 ``fit`` (the
        reference runtime's own EM calls are commented out,
        hmm_utils.py:676-678)."""
        import re
        selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                        read_length)
        if not selected:
            return selected
        out = self.em_update([r.sequence for r in selected], read_length,
                             max_iters=max_iters)
        E = np.exp(np.asarray(out["log_E"], dtype=np.float64))
        # aggregate repeat-region states M{i}_{copy}/I{i}_{copy} (copy is a
        # bare integer; flank states carry _suffix/_prefix) per unit position
        agg: dict[str, list[np.ndarray]] = {}
        for row, name in zip(E, out["names"]):
            m = re.fullmatch(r"([MI])(\d+)_(\d+)", name)
            if m:
                agg.setdefault(f"{m.group(1)}{m.group(2)}", []).append(row)
        if not agg:
            return selected
        trans, emis = profile_for_repeats(
            list(self.reference_vntr.get_repeat_segments()),
            self.config.max_error_rate)
        for key, rows_ in agg.items():
            if key in emis:
                mean = np.mean(rows_, axis=0)
                mean = mean / mean.sum()
                emis[key] = {b: float(mean[dna.encode(b)[0]])
                             for b in "ACGT"}
        left = self.reference_vntr.left_flanking_region[-read_length:]
        right = self.reference_vntr.right_flanking_region[:read_length]
        g = build_read_matcher(left, right, trans, emis,
                               self.get_copies_for_hmm(read_length),
                               self.config.max_error_rate)
        updated = self.cache._build(g, compile_graph(g))
        new_selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, model=updated)
        return new_selected

    @time_usage
    def find_repeat_count(self, mapped_reads, unmapped_reads,
                          read_length: int | None = None,
                          accuracy_filter: bool = False,
                          average_coverage=None,
                          update: bool = False,
                          em: bool = False) -> GenotypeResult:
        """Genotype from candidate reads
        (reference: find_repeat_count_from_alignment_file,
        vntr_finder.py:789-887)."""
        if read_length is None:
            lens = sorted(len(s) for _, s in (mapped_reads + unmapped_reads)[:5])
            read_length = lens[len(lens) // 2] if lens else 150
        if update and em:
            selected = self.em_update_and_reselect(mapped_reads,
                                                   unmapped_reads,
                                                   read_length)
        elif update:
            selected = self.update_and_reselect(mapped_reads, unmapped_reads,
                                                read_length)
        else:
            selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length)
        return self.genotype_from_selected(selected, accuracy_filter,
                                           average_coverage)

    def select_from_scored(self, scored, read_length: int):
        """Recruitment gates over already-scored reads."""
        min_score = self.recruitment_score_threshold(read_length)
        selected = []
        for read in scored:
            if not np.isfinite(read.logp):
                continue
            if not self.recruit_read(read, min_score):
                continue
            if read.repeat_bp > self.min_repeat_bp_to_add_read:
                selected.append(read)
        return selected

    def genotype_from_selected(self, selected, accuracy_filter: bool = False,
                               average_coverage=None) -> GenotypeResult:
        """RU counting + diploid ML genotype from selected reads
        (reference: vntr_finder.py:806-887)."""
        covered_repeats = []
        flanking_repeats = []
        total_counted_vntr_bp = 0
        for read in selected:
            total_counted_vntr_bp += read.repeat_bp
            if self.spans_with_confidence(read):
                covered_repeats.append(read.repeats)
            elif not accuracy_filter:
                flanking_repeats.append(read.repeats)
        flanking_repeats = sorted(flanking_repeats)
        logging.info("covered repeats: %s", covered_repeats)
        logging.info("flanking repeats: %s", flanking_repeats)

        min_valid_flanked = max(covered_repeats) if covered_repeats else 0
        max_flanking_repeat = [r for r in flanking_repeats
                               if r == max(flanking_repeats)
                               and r >= min_valid_flanked] \
            if flanking_repeats else []
        if len(max_flanking_repeat) < 5:
            max_flanking_repeat = []

        if accuracy_filter:
            covered_repeats = _filter_by_support(
                covered_repeats, self.config.accuracy_filter_sr_min_support)
            max_flanking_repeat = []

        genotype, max_prob = find_genotype(
            covered_repeats + max_flanking_repeat, self.is_haploid,
            self.config.genotype_error_rate)

        if average_coverage:
            pattern_occurrences = sum(flanking_repeats) + sum(covered_repeats)
            if self.coverage_corrector is not None:
                pattern_occurrences = \
                    self.coverage_corrector.get_scaled_coverage(
                        self.reference_vntr, pattern_occurrences)
            haplotypes = 1 if self.is_haploid else 2
            estimate = int(pattern_occurrences /
                           (float(average_coverage) * haplotypes))
            return GenotypeResult([estimate, estimate], len(selected),
                                  len(covered_repeats), len(flanking_repeats),
                                  0)
        return GenotypeResult(genotype, len(selected), len(covered_repeats),
                              len(flanking_repeats), max_prob)

    # -- frameshift mode (reference: vntr_finder.py:256-309) -----------------

    def _sum_closure_tensors(self, read_length: int):
        """Sum-semiring model tensors for the posterior kernels, split into
        the full closure and its repeat-delete-routed part (cached per read
        length).  See ops/posterior.py for the decomposition."""
        cached = getattr(self, "_sum_cache", {})
        if read_length in cached:
            return cached[read_length]
        from advntr_tpu.models.compiler import compile_graph_sum
        from advntr_tpu.models.graph import K_DELETE, K_INSERT, R_REPEAT
        from advntr_tpu.ops.posterior import clean_neg, log_sub
        copies = self.get_copies_for_hmm(read_length)
        flank_size = read_length
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        trans, emis = profile_for_repeats(
            list(self.reference_vntr.get_repeat_segments()),
            self.config.max_error_rate)
        g = build_read_matcher(left, right, trans, emis, copies,
                               self.config.max_error_rate)
        full = compile_graph_sum(g)
        nodel = compile_graph_sum(
            g, drop_silent=lambda s: s.kind == K_DELETE
            and s.region == R_REPEAT)
        emitting = [s for i, s in enumerate(g.states)
                    if not s.is_silent and i not in (g.start, g.end)]
        occ_mask = np.array(
            [s.kind == K_INSERT and s.region == R_REPEAT for s in emitting],
            dtype=np.float32)
        tensors = (clean_neg(full[0]), clean_neg(full[1]),
                   clean_neg(full[2]), clean_neg(full[3]),
                   clean_neg(log_sub(full[0], nodel[0])),
                   clean_neg(log_sub(full[2], nodel[2])),
                   clean_neg(log_sub(full[3], nodel[3])),
                   jnp.asarray(occ_mask))
        cached[read_length] = tensors
        self._sum_cache = cached
        return tensors

    def frameshift_posterior(self, sequences: list[str], read_length: int,
                             max_reads: int = 128) -> dict:
        """Posterior indel support over recruited reads: expected repeat
        insert-state emissions and expected repeat-delete-routed transitions
        per read under the forward-backward posterior (the SURVEY §7-step-7
        posterior upgrade to the Viterbi-path indel count; reference
        capability class pomegranate/hmm.pyx:1541-1777)."""
        from advntr_tpu.ops.posterior import posterior_indel_batch
        tensors = self._sum_closure_tensors(read_length)
        seqs = sequences[:max_reads]
        rows = [dna.encode(s) for s in seqs]
        batch, lengths = dna.pad_batch(rows, multiple=32)
        out = posterior_indel_batch(
            *tensors, jnp.asarray(batch), jnp.asarray(lengths))
        occ = np.asarray(out["ins_occupancy"], dtype=np.float64)
        dm = np.asarray(out["del_mass"], dtype=np.float64)
        return {
            "reads": len(seqs),
            "insert_occupancy": occ,
            "delete_mass": dm,
            "mean_insert_occupancy": float(occ.mean()) if len(seqs) else 0.0,
            "mean_delete_mass": float(dm.mean()) if len(seqs) else 0.0,
            "indel_support": float(occ.sum() + dm.sum()),
        }

    def em_update(self, sequences: list[str], read_length: int,
                  max_iters: int = 5, inertia: float = 0.0,
                  max_reads: int = 256) -> dict:
        """Baum-Welch re-estimation over recruited reads (the posterior
        twin of the Viterbi-path ``--update``; reference capability class
        pomegranate/hmm.pyx:2369 ``fit`` — disabled in the reference
        runtime itself, hmm_utils.py:676-678).

        Runs EM on the sum-closed model (ops/baum_welch.py) and returns
        {"history": total loglik per iteration, "log_E": (n, 4) updated
        emissions, "log_T": updated transitions, "names": emitting-state
        names} so callers can inspect per-state parameter shifts (the
        conformance test cross-checks the emission direction against the
        Viterbi-path update)."""
        from advntr_tpu.models.compiler import compile_graph_sum
        from advntr_tpu.ops.baum_welch import baum_welch_fit
        copies = self.get_copies_for_hmm(read_length)
        left = self.reference_vntr.left_flanking_region[-read_length:]
        right = self.reference_vntr.right_flanking_region[:read_length]
        trans, emis = profile_for_repeats(
            list(self.reference_vntr.get_repeat_segments()),
            self.config.max_error_rate)
        g = build_read_matcher(left, right, trans, emis, copies,
                               self.config.max_error_rate)
        log_T, log_E, log_start, log_end = compile_graph_sum(g)
        names = [s.name for i, s in enumerate(g.states)
                 if not s.is_silent and i not in (g.start, g.end)]
        rows = [dna.encode(s) for s in sequences[:max_reads]]
        batch, lengths = dna.pad_batch(rows, multiple=32)
        params, history = baum_welch_fit(
            log_T, log_E, log_start, log_end, jnp.asarray(batch),
            jnp.asarray(lengths), max_iters=max_iters, inertia=inertia)
        return {"history": history, "log_T": params[0], "log_E": params[1],
                "log_start": params[2], "log_end": params[3],
                "names": names}

    def find_frameshift(self, mapped_reads, unmapped_reads,
                        read_length: int | None = None,
                        posterior: bool | None = None):
        if read_length is None:
            lens = sorted(len(s) for _, s in (mapped_reads + unmapped_reads)[:5])
            read_length = lens[len(lens) // 2] if lens else 150
        art = self.get_model(read_length).art
        selected, stats = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, return_paths=True)
        if not selected:
            return None
        from advntr_tpu.engine import analytics as an

        mutations: dict[str, int] = {}
        repeating_bps_in_data = 0
        pattern_len = len(self.reference_vntr.pattern)
        for read in selected:
            length = len(read.sequence)
            path = stats["path"][read.row][:length]
            visited = expand_path(art, path)
            lengths_per_unit = an.repeating_pattern_lengths(visited)
            repeating_bps_in_data += read.repeat_bp
            current_repeat = None
            for i, vs in enumerate(visited):
                if vs.endswith("fix") or vs.startswith("M"):
                    continue
                if vs.startswith("unit_start"):
                    current_repeat = 0 if current_repeat is None \
                        else current_repeat + 1
                if current_repeat is None or \
                        current_repeat >= len(lengths_per_unit):
                    continue
                if not vs.startswith("I") and not vs.startswith("D"):
                    continue
                if lengths_per_unit[current_repeat] == pattern_len:
                    continue
                state = vs.split("_")[0]
                if state.startswith("I"):
                    emitted = an.emitted_base_for_state(vs, visited,
                                                       read.sequence)
                    state += emitted or ""
                if abs(lengths_per_unit[current_repeat] - pattern_len) <= 2:
                    mutations[state] = mutations.get(state, 0) + 1

        sorted_mutations = sorted(mutations.items(), key=lambda x: x[1])
        candidate = sorted_mutations[-1] if sorted_mutations else (None, 0)
        avg_bp_coverage = (repeating_bps_in_data /
                           self.reference_vntr.get_length() / 2)
        if avg_bp_coverage == 0:
            return None
        expected_indels = 1 / avg_bp_coverage
        if not identify_frameshift(avg_bp_coverage, candidate[1],
                                   expected_indels):
            return None
        if candidate[0] is None:
            # no concrete mutation to report even though the LR fires
            # (e.g. observed=0 at integer coverage); the reference returns
            # None here (vntr_finder.py find_frameshift_from_selected_reads)
            return None
        if posterior is None:
            posterior = self.config.frameshift_posterior
        post = None
        if posterior and candidate[0] is not None:
            try:
                post = self.frameshift_posterior(
                    [r.sequence for r in selected], read_length)
                logging.info(
                    "frameshift posterior %s: candidate %s (LR support %d); "
                    "mean insert occupancy %.3f, mean delete mass %.3f "
                    "per read over %d reads",
                    self.reference_vntr.id, candidate[0], candidate[1],
                    post["mean_insert_occupancy"],
                    post["mean_delete_mass"], post["reads"])
            except Exception as error:  # posterior is reporting-only
                logging.warning("frameshift posterior failed for %s: %s",
                                self.reference_vntr.id, error)
        call = FrameshiftCall(candidate[0])
        call.lr_support = candidate[1]
        call.posterior = post
        return call


    # -- PacBio path (reference: vntr_finder.py:324-471, 534-665) ------------

    def _check_flanks_align(self, read_str: str, name: str,
                            spanning: list, length_dist: list,
                            flank_size: int = 100) -> None:
        """Anchor both 100bp flanks inside a long read by local alignment;
        on success, record the trimmed VNTR+-flank window
        (reference semantics: check_if_flanking_regions_align_to_str,
        vntr_finder.py:324-365)."""
        from advntr_tpu.ops.align import local_align
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        min_score_l = len(left) * (1 - self.config.max_error_rate)
        score_l, start_l, _ = local_align(read_str, left)
        if score_l < min_score_l:
            return
        min_score_r = len(right) * (1 - self.config.max_error_rate)
        score_r, start_r, _ = local_align(read_str, right)
        if score_r < min_score_r:
            return
        if start_r < start_l:
            return
        spanning.append((name, read_str[start_l:start_r + flank_size]))
        length_dist.append(start_r - (start_l + flank_size))

    def get_spanning_reads_of_unaligned_pacbio_reads(self, unmapped_reads):
        """Batched flank anchoring: both orientations of every long read are
        aligned against both 100bp flank probes in four device passes
        (the reference forks one process per read and runs Bio.pairwise2,
        vntr_finder.py:423-439)."""
        from advntr_tpu.ops.align import anchor_probe_batch
        flank_size = 100
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        min_l = len(left) * (1 - self.config.max_error_rate)
        min_r = len(right) * (1 - self.config.max_error_rate)

        names, seqs, codes = [], [], []
        for name, seq in unmapped_reads:
            seq = seq.upper()
            rev = dna.revcomp(seq)
            for s in (seq, rev):
                names.append(name)
                seqs.append(s)
                codes.append(dna.encode(s))
        spanning: list = []
        length_dist: list = []
        if not codes:
            return spanning, length_dist
        res_l = anchor_probe_batch(codes, dna.encode(left))
        res_r = anchor_probe_batch(codes, dna.encode(right))
        for name, s, (score_l, start_l, _), (score_r, start_r, _) in zip(
                names, seqs, res_l, res_r):
            if score_l < min_l or score_r < min_r:
                continue
            if start_r < start_l:
                continue
            spanning.append((name, s[start_l:start_r + flank_size]))
            length_dist.append(start_r - (start_l + flank_size))
        logging.info("length_distribution of unmapped spanning reads: %s",
                     length_dist)
        return spanning, length_dist

    def get_spanning_reads_of_aligned_pacbio_reads(self, bam):
        """Extract VNTR-spanning windows from aligned long reads by walking
        aligned reference positions (reference semantics:
        check_if_pacbio_mapped_read_spans_vntr, vntr_finder.py:373-420)."""
        from advntr_tpu.io.bam import get_reference_genome_style
        hmm_flank = 100
        min_flanking_bp = 10
        vntr_start, vntr_end = self.vntr_start, self.vntr_end
        region_start = vntr_start - hmm_flank
        style = get_reference_genome_style(bam.references)
        chromosome = (self.reference_vntr.chromosome if style == "HG19"
                      else self.reference_vntr.chromosome[3:])
        spanning = []
        for read in bam.fetch(chromosome, vntr_start, vntr_end):
            positions = read.get_reference_positions()
            if not positions:
                continue
            if not (positions[0] <= vntr_start - min_flanking_bp
                    and vntr_end + min_flanking_bp < positions[-1]):
                continue
            read_region_start = read_region_end = None
            left_bp = right_bp = 0
            for read_pos, ref_pos in enumerate(
                    read.get_reference_positions(full_length=True)):
                if ref_pos is None:
                    continue
                if ref_pos > vntr_end + hmm_flank:
                    break
                if region_start <= ref_pos < vntr_end + hmm_flank:
                    if region_start <= ref_pos < vntr_start:
                        if read_region_start is None:
                            read_region_start = read_pos
                        left_bp += 1
                    elif vntr_start <= ref_pos < vntr_end:
                        pass
                    else:
                        if read_region_end is None:
                            read_region_end = read_pos
                        right_bp += 1
            if left_bp < min_flanking_bp or right_bp < min_flanking_bp:
                continue
            if read_region_start is not None and read_region_end is not None \
                    and read.seq:
                seq = read.seq[read_region_start:read_region_end + right_bp]
                spanning.append((read.query_name, seq))
        return spanning

    def get_dominant_copy_numbers_from_spanning_reads(
            self, spanning_reads, accuracy_filter: bool = False):
        """Viterbi-decode each spanning window against a max-copies model and
        genotype the observed RU counts (reference semantics:
        vntr_finder.py:534-585)."""
        if len(spanning_reads) < 1:
            logging.info("There is no spanning read")
            return None, 0
        max_length = 0
        for _, seq in spanning_reads:
            if len(seq) - 100 > max_length:
                max_length = len(seq) - 100
        max_copies = int(round(max_length /
                               float(len(self.reference_vntr.pattern))))
        max_copies = max(max_copies, 1)
        if accuracy_filter:
            self.minimum_left_flanking_size = \
                self.config.accuracy_filter_min_left_flanking_size
            self.minimum_right_flanking_size = \
                self.config.accuracy_filter_min_right_flanking_size
        model = self.get_model(read_length=0, copies=max_copies,
                               flank_size=100)
        scored, _ = self.score_reads(spanning_reads, [], read_length=0,
                                     model=model)
        observed = [r.repeats for r in scored if np.isfinite(r.logp)]
        logging.info("observed repeats: %s", observed)
        if accuracy_filter:
            observed = _filter_by_support(
                observed, self.config.accuracy_filter_sr_min_support)
        return find_genotype(observed, self.is_haploid,
                             self.config.genotype_error_rate)

    def get_haplotype_copy_numbers_from_spanning_reads(self, spanning_reads):
        """Cluster spanning reads into haplotypes, decode the consensus of
        each (reference semantics: vntr_finder.py:588-609)."""
        from advntr_tpu.engine.haplotyper import PacBioHaplotyper
        if len(spanning_reads) < 1:
            return None
        max_length = 0
        for _, seq in spanning_reads:
            if len(seq) - 100 > max_length:
                max_length = len(seq) - 100
        max_copies = int(round(max_length /
                               float(len(self.reference_vntr.pattern))))
        max_copies = min(max(max_copies, 1),
                         2 * len(self.reference_vntr.get_repeat_segments()))
        model = self.get_model(read_length=0, copies=max_copies,
                               flank_size=100)
        haplotyper = PacBioHaplotyper([seq for _, seq in spanning_reads])
        haplotypes = haplotyper.get_error_corrected_haplotypes()
        if not haplotypes:
            return None
        scored, _ = self.score_reads(
            [], [(f"hap{i}", h) for i, h in enumerate(haplotypes)],
            read_length=0, model=model)
        return [r.repeats for r in scored]

    def find_ru_counts_with_naive_approach(self, spanning_reads):
        """RU count from the flank-to-flank distance of the error-corrected
        consensus (reference semantics: vntr_finder.py:611-624)."""
        from advntr_tpu.engine.haplotyper import PacBioHaplotyper
        haplotyper = PacBioHaplotyper([seq for _, seq in spanning_reads])
        haplotypes = haplotyper.get_error_corrected_haplotypes(1)
        if len(haplotypes) == 0:
            return None
        flanking_lengths: list = []
        dummy: list = []
        self._check_flanks_align(haplotypes[0].upper(), "consensus",
                                 dummy, flanking_lengths)
        self._check_flanks_align(dna.revcomp(haplotypes[0]).upper(),
                                 "consensus", dummy, flanking_lengths)
        if flanking_lengths:
            ru = round(flanking_lengths[0] / len(self.reference_vntr.pattern))
            return (ru, ru)
        return None

    def find_repeat_count_pacbio(self, bam, unmapped_reads,
                                 accuracy_filter: bool = False,
                                 naive: bool = False) -> GenotypeResult:
        """PacBio genotyping from an optional alignment plus recruited
        unmapped reads (reference: vntr_finder.py:639-665)."""
        spanning, length_dist = \
            self.get_spanning_reads_of_unaligned_pacbio_reads(unmapped_reads)
        if bam is not None:
            spanning = self.get_spanning_reads_of_aligned_pacbio_reads(bam) \
                + spanning
        max_prob = 0
        if naive:
            copy_numbers = self.find_ru_counts_with_naive_approach(spanning) \
                if spanning else None
        else:
            copy_numbers, max_prob = \
                self.get_dominant_copy_numbers_from_spanning_reads(
                    spanning, accuracy_filter)
        return GenotypeResult(copy_numbers, len(spanning), len(spanning), 0,
                              max_prob)


def _filter_by_support(counts: list[int], min_support: int) -> list[int]:
    from collections import Counter
    out = []
    for key, cnt in Counter(counts).most_common():
        if cnt >= min_support:
            out.extend([key] * cnt)
    return out
