"""Vectorized k-mer read-recruitment filter.

Capability-equivalent to the reference's Aho-Corasick C++ filter
(filtering/main.cc): count exact keyword occurrences per (read, locus),
report reads with >= min_matches hits, cap per locus, rank by hit count.

Device formulation: keywords of length k <= 15 are 2-bit packed into
int32 codes; each read produces a rolling code per position; membership is a
binary search into the sorted keyword table; per-locus hit counts accumulate
with a scatter-add.  Longer keywords (the PacBio 80bp flank probes,
vntr_finder.py:151-152) are matched by their leading 15-mer on device and
verified exactly on host (hits are rare, so verification is cheap).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from advntr_tpu import dna


# widest recruitment chunk (reads per device call); the async chunk queue
# amortizes the extra dispatches of narrower chunks
RECRUIT_CHUNK = 1024


@dataclasses.dataclass
class KeywordTable:
    k: int                     # device-matched prefix length
    codes: np.ndarray          # (K,) int32 sorted (with duplicates)
    locus_ids: np.ndarray      # (K,) int32 locus index per entry
    max_dup: int               # max entries sharing one code
    loci: list                 # locus index -> external locus id
    full_keywords: list        # entry index -> full keyword string (host verify)
    needs_verify: bool         # any keyword longer than k


def encode_kmer(kmer: str) -> int:
    code = 0
    for ch in kmer:
        v = "ACGT".find(ch)
        if v < 0:
            return -1
        code = code * 4 + v
    return code


def build_keyword_table(keywords_per_locus: dict, k: int = 15) -> KeywordTable:
    """keywords_per_locus: {locus_id: iterable of keyword strings}."""
    loci = sorted(keywords_per_locus)
    entries = []  # (code, locus_index, full_keyword)
    needs_verify = False
    for li, locus in enumerate(loci):
        for kw in sorted(set(keywords_per_locus[locus])):
            kw = kw.upper()
            probe = kw[:k]
            if len(kw) > k:
                needs_verify = True
            if len(probe) < k:
                continue
            code = encode_kmer(probe)
            if code < 0:
                continue
            entries.append((code, li, kw))
    entries.sort(key=lambda e: (e[0], e[1]))
    codes = np.array([e[0] for e in entries], dtype=np.int32)
    locus_ids = np.array([e[1] for e in entries], dtype=np.int32)
    max_dup = 1
    if len(codes):
        _, counts = np.unique(codes, return_counts=True)
        max_dup = int(counts.max())
    return KeywordTable(k, codes, locus_ids, max_dup, loci,
                        [e[2] for e in entries], needs_verify)


@functools.partial(jax.jit, static_argnames=("k", "n_loci", "max_dup"))
def _count_hits(codes_table, locus_ids, seqs, lengths, k: int, n_loci: int,
                max_dup: int):
    """Per-(read, locus) keyword hit counts.

    seqs: (B, L) int8 with 0..3 bases, 4 for N/padding.
    Returns (B, n_loci) int32.
    """
    B, L = seqs.shape
    n_pos = L - k + 1
    seqs32 = seqs.astype(jnp.int32)
    # rolling codes: code[p] = sum_j seq[p+j] * 4^(k-1-j)
    code = jnp.zeros((B, n_pos), dtype=jnp.int32)
    ok = jnp.ones((B, n_pos), dtype=bool)
    for j in range(k):
        win = jax.lax.dynamic_slice_in_dim(seqs32, j, n_pos, axis=1)
        code = code * 4 + jnp.where(win < 4, win, 0)
        ok &= win < 4
    pos = jnp.arange(n_pos, dtype=jnp.int32)[None, :]
    ok &= pos <= (lengths[:, None] - k)

    lo = jnp.searchsorted(codes_table, code, side="left")  # (B, n_pos)
    counts = jnp.zeros((B, n_loci), dtype=jnp.int32)
    K = codes_table.shape[0]
    b_idx = jnp.broadcast_to(jnp.arange(B)[:, None], (B, n_pos))
    for d in range(max_dup):
        idx = jnp.minimum(lo + d, K - 1)
        hit = ok & (lo + d < K) & (jnp.take(codes_table, idx) == code)
        locus = jnp.take(locus_ids, idx)
        counts = counts.at[b_idx, locus].add(hit.astype(jnp.int32))
    return counts


@functools.partial(jax.jit,
                   static_argnames=("k", "n_loci", "max_dup", "top_m"))
def _count_topk(codes_table, locus_ids, seqs, lengths, k: int, n_loci: int,
                max_dup: int, top_m: int):
    """Count hits and compact ON DEVICE to each read's top-``top_m`` loci.

    The dense (B, n_loci) counts plane never leaves the device: at
    genome-wide bank sizes (158,522 loci) it is ~650 KB *per read*, which
    would saturate any host link; a recruited read matches a handful of
    loci at most (max 3 loci share a 15-mer in the genome-wide bank;
    ``git show de509b1:PERF_NOTES.md``, round 4), so (B, top_m)
    values+indices lose nothing and
    shrink the transfer by ~4 orders of magnitude."""
    counts = _count_hits(codes_table, locus_ids, seqs, lengths,
                         k=k, n_loci=n_loci, max_dup=max_dup)
    vals, idx = jax.lax.top_k(counts, top_m)
    return vals.astype(jnp.int32), idx.astype(jnp.int32)


class RecruitmentFilter:
    """Multi-locus read recruitment with per-locus caps and ranking
    (behavioral contract of filtering/main.cc:229-331)."""

    def __init__(self, keywords_per_locus: dict, k: int = 15,
                 min_matches: int = 5, max_reads_per_locus: int = 2000,
                 top_m: int = 16):
        self.table = build_keyword_table(keywords_per_locus, k)
        self.min_matches = min_matches
        self.max_reads_per_locus = max_reads_per_locus
        # device-side top-M compaction (short-keyword banks only; the
        # long-probe PacBio path needs any-hit pairs for host verification
        # and its dense plane is small)
        self.top_m = top_m
        self._codes_dev = jnp.asarray(self.table.codes)
        self._locus_dev = jnp.asarray(self.table.locus_ids)
        # accumulated results: locus -> {read_name: count}
        self._hits: dict = {locus: {} for locus in self.table.loci}
        self._sequences: dict = {}
        # queued device work: (names, seqs, vals_dev, idx_dev) — collected
        # in dispatch order so the device pipelines chunks back-to-back
        # without a host sync per chunk
        self._inflight: list = []
        self._full_by_locus: dict[int, list[str]] | None = None
        if self.table.needs_verify:
            self._full_by_locus = {}
            for li, kw in zip(self.table.locus_ids, self.table.full_keywords):
                self._full_by_locus.setdefault(int(li), []).append(kw)

    def process_batch(self, names: list[str], seqs: list[str]) -> None:
        if not names or len(self.table.codes) == 0:
            return
        # the per-(read, locus) counts plane is B x n_loci int32: at
        # genome-wide panel sizes (158,522 loci, reference README.md:34-35)
        # a 1024-read batch would be ~650 MB of device memory — split the
        # batch so the plane stays under ~256 MB while small panels keep
        # one bucket
        n_loci = max(1, len(self.table.loci))
        b_cap = max(32, (64 << 20) // n_loci)
        b_cap = 1 << (b_cap.bit_length() - 1)
        # and cap the chunk width at RECRUIT_CHUNK reads: compile time of
        # the count+top_k executable grows with B at panel-scale n_loci
        b_cap = min(b_cap, RECRUIT_CHUNK)
        if len(names) > b_cap:
            for s in range(0, len(names), b_cap):
                self._process_chunk(names[s:s + b_cap], seqs[s:s + b_cap])
        else:
            self._process_chunk(names, seqs)

    def _process_chunk(self, names: list[str], seqs: list[str]) -> None:
        rows = [dna.encode(s.upper()) for s in seqs]
        batch, lengths = dna.pad_batch(rows, multiple=128)
        if batch.shape[1] < self.table.k:
            return
        # pad B to a bucket
        b_pad = 1 << (len(rows) - 1).bit_length()
        if b_pad != len(rows):
            pad = np.full((b_pad - len(rows), batch.shape[1]), 4,
                          dtype=batch.dtype)
            batch = np.concatenate([batch, pad])
            lengths = np.concatenate(
                [lengths, np.zeros(b_pad - len(rows), dtype=lengths.dtype)])
        n_loci = len(self.table.loci)
        if self._full_by_locus is None and n_loci > self.top_m:
            # short-keyword path: device-side top-M compaction, queued
            # asynchronously (no per-chunk host sync — the (B, n_loci)
            # plane transfer would dominate at genome scale, see
            # _count_topk)
            vals, idx = _count_topk(
                self._codes_dev, self._locus_dev, jnp.asarray(batch),
                jnp.asarray(lengths), self.table.k, n_loci,
                self.table.max_dup, self.top_m)
            self._inflight.append((names, seqs, vals, idx))
            return
        counts = np.asarray(_count_hits(
            self._codes_dev, self._locus_dev, jnp.asarray(batch),
            jnp.asarray(lengths), self.table.k, len(self.table.loci),
            self.table.max_dup))[: len(rows)]

        if self._full_by_locus is not None:
            # long keywords: recount exactly on host for device-hit pairs
            rb, rl = np.nonzero(counts)
            counts = np.zeros_like(counts)
            for b, li in zip(rb, rl):
                seq = seqs[b].upper()
                c = 0
                for kw in self._full_by_locus.get(int(li), ()):
                    start = 0
                    while True:
                        p = seq.find(kw, start)
                        if p < 0:
                            break
                        c += 1
                        start = p + 1
                counts[b, li] = c

        hit_reads, hit_loci = np.nonzero(counts >= self.min_matches)
        for b, li in zip(hit_reads, hit_loci):
            locus = self.table.loci[li]
            bucket = self._hits[locus]
            # overscan cap as in the reference (main.cc:280)
            if len(bucket) > self.max_reads_per_locus * 3:
                continue
            bucket[names[b]] = int(counts[b, li])
            self._sequences[names[b]] = seqs[b]

    def _drain(self) -> None:
        """Collect queued top-M results in dispatch order (one host sync
        per chunk output of ~KBs, overlapped with later chunks' device
        compute)."""
        for names, seqs, vals, idx in self._inflight:
            vals = np.asarray(vals)[: len(names)]
            idx = np.asarray(idx)[: len(names)]
            rb, rm = np.nonzero(vals >= self.min_matches)
            for b, m in zip(rb, rm):
                locus = self.table.loci[int(idx[b, m])]
                bucket = self._hits[locus]
                if len(bucket) > self.max_reads_per_locus * 3:
                    continue
                bucket[names[b]] = int(vals[b, m])
                self._sequences[names[b]] = seqs[b]
        self._inflight = []

    def results(self):
        """{locus: [(read_name, count), ...] ranked by count desc, capped},
        plus {read_name: sequence} for every reported read."""
        self._drain()
        out = {}
        reported = {}
        for locus, bucket in self._hits.items():
            # rank by count desc, name desc — the C++ filter sorts
            # (occurrence, name) pairs in reverse order (main.cc:314)
            ranked = sorted(bucket.items(), key=lambda kv: (kv[1], kv[0]),
                            reverse=True)
            ranked = ranked[: self.max_reads_per_locus]
            out[locus] = ranked
            for name, _ in ranked:
                reported[name] = self._sequences[name]
        return out, reported
