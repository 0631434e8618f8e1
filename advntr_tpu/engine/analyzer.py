"""Genome-level orchestration: recruitment fan-out, per-locus genotyping
with error isolation, and text/BED/VCF output.

Capability-equivalent to the reference GenomeAnalyzer
(advntr/genome_analyzer.py:12-318), restructured around the native IO stack
and the batched device engine:

1. stream unmapped reads once through the k-mer recruitment filter for all
   target loci (the reference shells out to the C++ Aho-Corasick binary,
   genome_analyzer.py:185)
2. per locus: indexed BAM fetch for mapped candidates + the recruited
   unmapped reads -> batched Viterbi scoring -> genotype
3. per-locus try/except isolation so one bad locus yields an Error row, not
   an aborted run (genome_analyzer.py:290-297)
"""

from __future__ import annotations

import logging
import os
import sys

from advntr_tpu import __version__
from advntr_tpu.config import Config, DEFAULT_CONFIG
from advntr_tpu.engine.finder import VNTRFinder, GenotypeResult
from advntr_tpu.engine.recruitment import build_recruitment_filter, filter_reads
from advntr_tpu.io.bam import BamReader, get_reference_genome_style
from advntr_tpu.io.sam import open_alignment
from advntr_tpu.utils.profiler import time_usage
from advntr_tpu.utils.quality import is_low_quality_read


class GenomeAnalyzer:
    def __init__(self, ref_vntrs, target_vntr_ids, working_dir: str = "./",
                 outfmt: str = "text", is_haploid: bool = False,
                 ref_filename=None, input_file=None,
                 config: Config = DEFAULT_CONFIG, out=None):
        self.reference_vntrs = ref_vntrs
        self.target_vntr_ids = target_vntr_ids
        self.working_dir = working_dir
        self.outfmt = outfmt
        self.is_haploid = is_haploid
        self.ref_filename = ref_filename
        self.input_file = input_file
        self.config = config
        self.out = out or sys.stdout
        from advntr_tpu.engine.finder import LocusModelCache
        bank_dir = os.path.join(working_dir, "model_bank") if working_dir \
            else None
        self.model_cache = LocusModelCache(
            workers=max(0, config.io_threads - 1), bank_dir=bank_dir)
        # loci that lost the grouped fast path this run (dispatch or collect
        # failure -> per-locus fallback).  A fallback is ~10x slower and a
        # silent one once masked a kernel regression (commit f4e4ee3); panel
        # harnesses fail loudly when this is non-empty.
        self.grouped_fallback_vids: list = []
        self.checkpoint_suffix = ""
        self.vntr_finder = {}
        for ref_vntr in ref_vntrs:
            if ref_vntr.id in target_vntr_ids:
                self.vntr_finder[ref_vntr.id] = VNTRFinder(
                    ref_vntr, config, is_haploid,
                    model_cache=self.model_cache)

    # ---- output formatting (genome_analyzer.py:28-170) --------------------

    def _print(self, text: str) -> None:
        self.out.write(text + "\n")

    def print_genotype(self, vntr_id, result: GenotypeResult,
                       encountered_error: bool = False) -> None:
        if self.outfmt == "bed":
            self.print_genotype_in_bed(vntr_id, result.copy_numbers,
                                       encountered_error)
        elif self.outfmt == "vcf":
            self.print_genotype_in_vcf(vntr_id, result, encountered_error)
        else:
            self.print_genotype_in_text(vntr_id, result.copy_numbers,
                                        encountered_error)

    def print_genotype_in_text(self, vntr_id, copy_numbers,
                               encountered_error) -> None:
        self._print(str(vntr_id))
        if encountered_error:
            self._print("Error")
        elif copy_numbers is not None:
            if self.is_haploid:
                self._print(str(copy_numbers[0]))
            else:
                self._print("/".join(str(cn) for cn in sorted(copy_numbers)))
        else:
            self._print("None")

    def print_bed_header(self) -> None:
        repeats = "R" if self.is_haploid else "R1\tR2"
        self._print("#CHROM\tStart\tEnd\tVNTR_ID\tGene\tMotif\tRefCopy\t%s"
                    % repeats)

    def print_genotype_in_bed(self, vntr_id, copy_numbers,
                              encountered_error) -> None:
        ref = self.vntr_finder[vntr_id].reference_vntr
        end = ref.start_point + ref.get_length()
        ref_copy = len(ref.get_repeat_segments())
        if encountered_error:
            repeats = "Error"
        elif copy_numbers is None:
            repeats = "None" if self.is_haploid else "None\tNone"
        else:
            repeats = (str(copy_numbers[0]) if self.is_haploid else
                       "\t".join(str(cn) for cn in sorted(copy_numbers)))
        self._print("%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s" % (
            ref.chromosome, ref.start_point, end, vntr_id, ref.gene_name,
            ref.pattern, ref_copy, repeats))

    def print_vcf_header(self) -> None:
        p = self._print
        p("##fileformat=VCFv4.2")
        p("##source=adVNTR-TPU ver. {}".format(__version__))
        p('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of variant">')
        p('##INFO=<ID=VID,Number=1,Type=Integer,Description="VNTR ID">')
        p('##INFO=<ID=RU,Number=1,Type=String,Description="Repeat motif">')
        p('##INFO=<ID=RC,Number=1,Type=Integer,Description="Reference repeat unit count">')
        p('##FILTER=<ID=ERR,Description="Error occurred while genotyping">')
        p('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        p('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">')
        p('##FORMAT=<ID=SR,Number=1,Type=Integer,Description="Spanning read count">')
        p('##FORMAT=<ID=FR,Number=1,Type=Integer,Description="Flanking read count">')
        p('##FORMAT=<ID=ML,Number=1,Type=Float,Description="Maximum likelihood">')
        contigs = set()
        for vid in self.target_vntr_ids:
            chromosome = self.vntr_finder[vid].reference_vntr.chromosome[3:]
            contigs.add(chromosome)
        for contig in sorted(contigs):
            p("##contig=<ID={}>".format(contig))
        sample = (self.input_file or "sample").strip().split("/")[-1].split(".")[0]
        p("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample)

    def print_genotype_in_vcf(self, vntr_id, result: GenotypeResult,
                              encountered_error) -> None:
        vntr = self.vntr_finder[vntr_id].reference_vntr
        end = vntr.start_point + vntr.get_length()
        ref = "".join(vntr.get_repeat_segments())
        consensus = vntr.pattern
        GT = []
        diff_count = 0
        diff_index = -1
        if result.copy_numbers is None:
            GT = [".", "."]
        else:
            for index, copy_number in enumerate(result.copy_numbers):
                if copy_number != vntr.estimated_repeats:
                    diff_index = index
                    diff_count += 1
                    GT.append(diff_count)
                    if len(set(result.copy_numbers)) == 1:
                        GT.append(diff_count)
                        break
                else:
                    GT.append(0)
        if diff_count == 2:
            alt = (consensus * result.copy_numbers[0] + "," +
                   consensus * result.copy_numbers[1])
        elif diff_count == 1:
            alt = consensus * result.copy_numbers[diff_index]
        else:
            alt = "."
        filt = "ERR" if encountered_error else "."
        info = "END={};VID={};RU={};RC={}".format(
            end, vntr_id, vntr.pattern, vntr.estimated_repeats)
        fmt = "{}/{}:{}:{}:{}:{:.4f}".format(
            GT[0], GT[1], result.recruited_reads_count,
            result.spanning_reads_count, result.flanking_reads_count,
            result.maximum_likelihood)
        self._print("{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
            vntr.chromosome, vntr.start_point, ".", ref, alt, ".", filt,
            info, "GT:DP:SR:FR:ML", fmt))

    # ---- recruitment ------------------------------------------------------

    @time_usage
    def recruit_unmapped_reads(self, alignment_file: str,
                               illumina: bool = True):
        """One pass over the unmapped reads for all target loci.

        Returns {vid: [(name, seq), ...]}.
        """
        filt = build_recruitment_filter(
            self.reference_vntrs, self.target_vntr_ids, short_reads=illumina,
            keyword_size=self.config.keyword_size,
            min_matches=self.config.min_keyword_matches,
            max_reads_per_locus=self.config.max_reads_per_locus)

        def unmapped_iter():
            with open_alignment(alignment_file, self.ref_filename) as bam:
                for rec in bam.fetch_unmapped():
                    yield rec.query_name, rec.seq

        results, sequences = filter_reads(filt, unmapped_iter(),
                                          batch_size=1024)
        out = {}
        for vid in self.target_vntr_ids:
            out[vid] = [(name, sequences[name])
                        for name, _ in results.get(vid, [])]
        return out

    @time_usage
    def mapped_candidates(self, bam: BamReader, finder: VNTRFinder,
                          read_length: int):
        """Indexed fetch of mapped candidate reads for one locus
        (reference semantics: vntr_finder.py:727-750)."""
        ref = finder.reference_vntr
        style = get_reference_genome_style(bam.references)
        chromosome = ref.chromosome if style == "HG19" else ref.chromosome[3:]
        vntr_start, vntr_end = finder.vntr_start, finder.vntr_end
        min_len = int(read_length * 0.9)
        if self.config.min_read_length is not None:
            min_len = self.config.min_read_length
        out = []
        fetched = None
        if isinstance(bam, BamReader):
            try:
                bam._load_index()
            except FileNotFoundError:
                try:
                    from advntr_tpu.io.bam import build_bai
                    logging.info("building BAI index for %s", bam.path)
                    build_bai(bam.path)
                except Exception as error:
                    logging.warning("cannot index %s (%s); scanning "
                                    "sequentially", bam.path, error)
                    fetched = (r for r in bam
                               if r.reference_name == chromosome
                               and not r.is_unmapped)
        if fetched is None:
            fetched = bam.fetch(chromosome, max(0, vntr_start - 500),
                                vntr_end)
        for read in fetched:
            if read.is_unmapped or read.is_duplicate:
                continue
            if len(read.seq) < min_len:
                continue
            read_end = read.reference_end or read.reference_start + len(read.seq)
            if not (vntr_start - read_length < read.reference_start < vntr_end
                    or vntr_start < read_end < vntr_end):
                continue
            if is_low_quality_read(read.mapq, read.qual,
                                   self.config.mapq_cutoff,
                                   self.config.quality_score_cutoff,
                                   self.config.low_quality_bp_to_discard_read):
                continue
            out.append((read.query_name, read.seq))
        return out

    # ---- workloads --------------------------------------------------------

    def _emit_header(self):
        if self.outfmt == "bed":
            self.print_bed_header()
        elif self.outfmt == "vcf":
            self.print_vcf_header()

    # ---- result checkpoint/resume -----------------------------------------
    # Per-locus genotypes append to a JSONL checkpoint so an interrupted
    # panel run resumes where it stopped (the reference's only recovery is
    # its cached unmapped-FASTA/filter files, sam_utils.py:15-16).

    def _checkpoint_path(self, alignment_file: str):
        if not self.working_dir:
            return None
        base = os.path.basename(alignment_file)
        return os.path.join(
            self.working_dir,
            f"results_checkpoint_{base}{self.checkpoint_suffix}.jsonl")

    def _load_checkpoint(self, path):
        import json
        done = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                        done[rec["vid"]] = rec
                    except (ValueError, KeyError):
                        continue
        return done

    @staticmethod
    def _checkpoint_record(vid, result: GenotypeResult, err: bool) -> dict:
        return {"vid": vid, "error": err,
                "copy_numbers": list(result.copy_numbers)
                if result.copy_numbers is not None else None,
                "recruited": result.recruited_reads_count,
                "spanning": result.spanning_reads_count,
                "flanking": result.flanking_reads_count,
                "ml": result.maximum_likelihood}

    def _attach_coverage_corrector(self, alignment_file: str) -> None:
        """GC coverage-bias model for the expansion workload: histogram the
        alignment's per-window coverage by GC bin over the reference FASTA
        and hand every finder a corrector (reference model:
        advntr/coverage_bias.py:12-125; estimate at vntr_finder.py:783-786).
        Silently skipped without a reference FASTA."""
        if not self.ref_filename:
            return
        try:
            from advntr_tpu.engine.coverage_bias import (
                CoverageBiasDetector, CoverageCorrector)
            from advntr_tpu.io import fasta
            chromosomes = {f.reference_vntr.chromosome
                           for f in self.vntr_finder.values()}
            refs = {name: seq
                    for name, seq in fasta.read_fasta(self.ref_filename)
                    if name in chromosomes
                    or ("chr" + name) in chromosomes}
            refs = {(n if n.startswith("chr") else "chr" + n): s
                    for n, s in refs.items()}
            detector = CoverageBiasDetector(
                alignment_file, reference_sequences=refs)
            gc_map = detector.get_gc_content_coverage_map()
            if not gc_map:
                logging.warning("coverage-bias: no covered windows found; "
                                "skipping GC correction")
                return
            corrector = CoverageCorrector(gc_map)
            for finder in self.vntr_finder.values():
                finder.coverage_corrector = corrector
            logging.info("coverage-bias: GC correction active "
                         "(%d GC bins, mean %.2fx)", len(gc_map),
                         corrector.get_sequencing_mean_coverage())
        except Exception as error:
            logging.warning("coverage-bias model unavailable (%s); using "
                            "uncorrected coverage", error)

    def find_repeat_counts_from_alignment_file(self, alignment_file: str,
                                               accuracy_filter: bool = False,
                                               average_coverage=None,
                                               update: bool = False,
                                               em: bool = False) -> dict:
        if average_coverage:
            self._attach_coverage_corrector(alignment_file)
        # per-run state: an analyzer reused for a second alignment file
        # must not carry the previous run's fallback vids (a stale list
        # re-triggers the FAST-PATH DEGRADATION alarm on a clean run)
        self.grouped_fallback_vids = []
        ckpt_path = self._checkpoint_path(alignment_file)
        done = self._load_checkpoint(ckpt_path)
        pending = [vid for vid in self.target_vntr_ids if vid not in done]

        results = {}
        if pending:
            unmapped_by_vid = self.recruit_unmapped_reads(alignment_file,
                                                          illumina=True)
            # loci process in WAVES: each wave schedules its model builds,
            # runs the grouped dispatch, then evicts its host-side model
            # cache entries.  Per-locus decode tables are ~14 MB of host
            # RAM — an unbounded cache fits a 6,719-locus panel (~97 GB)
            # but OOMs at genome scale (158,522 loci), so the wave size
            # caps the live set (~15 GB at the 1024 default).
            wave_size = int(os.environ.get("ADVNTR_TPU_LOCI_WAVE", "1024"))
            with open_alignment(alignment_file, self.ref_filename) as bam:
                read_length = self._median_read_length(bam)
                saved_targets = self.target_vntr_ids
                try:
                    for w0 in range(0, len(pending), wave_size):
                        wave = pending[w0:w0 + wave_size]
                        for vid in wave:
                            finder = self.vntr_finder[vid]
                            self.model_cache.schedule(
                                finder.reference_vntr,
                                finder.get_copies_for_hmm(read_length),
                                read_length, self.config.max_error_rate)
                        self.target_vntr_ids = wave
                        results.update(self._genotype_loci_grouped(
                            bam, unmapped_by_vid, read_length,
                            accuracy_filter, average_coverage, update,
                            em=em, ckpt_path=ckpt_path))
                        for vid in wave:
                            finder = self.vntr_finder[vid]
                            self.model_cache.evict(
                                finder.reference_vntr,
                                finder.get_copies_for_hmm(read_length),
                                read_length, self.config.max_error_rate)
                finally:
                    self.target_vntr_ids = saved_targets
            if ckpt_path:
                # flush any loci the incremental appends missed (sequential
                # paths: --update, struct-less fallbacks)
                flushed = self._load_checkpoint(ckpt_path)
                self._append_checkpoint(
                    ckpt_path,
                    [vid for vid in pending if vid not in flushed], results)
            if self.grouped_fallback_vids:
                logging.warning(
                    "FAST-PATH DEGRADATION: %d loci fell back from grouped "
                    "device dispatch to the per-locus path: %s",
                    len(self.grouped_fallback_vids),
                    self.grouped_fallback_vids[:20])

        from advntr_tpu.utils.profiler import stage_summary
        logging.info(stage_summary())
        self._emit_header()
        records = {}
        for vid in self.target_vntr_ids:
            if vid in results:
                result, err = results[vid]
            else:
                rec = done[vid]
                result = GenotypeResult(
                    tuple(rec["copy_numbers"])
                    if rec["copy_numbers"] is not None else None,
                    rec["recruited"], rec["spanning"], rec["flanking"],
                    rec["ml"])
                err = rec["error"]
            records[vid] = self._checkpoint_record(vid, result, err)
            self.print_genotype(vid, result, encountered_error=err)
        # structured per-locus records: the distributed gather merges these
        # (never the rendered text/BED/VCF stream, which is display-only)
        return records

    def _append_checkpoint(self, ckpt_path, vids, results) -> None:
        """Append finished loci to the JSONL checkpoint as soon as their
        chunk collects, so an interrupted panel run resumes from the last
        completed chunk instead of losing the whole pass (genome-scale
        runs hold thousands of loci in flight)."""
        if not ckpt_path:
            return
        import json
        lines = []
        for vid in vids:
            if vid in results:
                result, err = results[vid]
                lines.append(json.dumps(
                    self._checkpoint_record(vid, result, err)) + "\n")
        if not lines:
            return
        # one os.write of the whole chunk: O_APPEND writes to a regular
        # file are offset-atomic, so concurrent shard processes sharing a
        # working_dir cannot tear each other's records mid-line
        data = "".join(lines).encode()
        fd = os.open(ckpt_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            written = os.write(fd, data)
            # POSIX allows short writes on regular files (e.g. disk full);
            # a torn record would be skipped by _load_checkpoint, but loop
            # to completion so a transient short write loses nothing
            while written < len(data):
                logging.warning("short checkpoint write (%d/%d bytes); "
                                "continuing", written, len(data))
                written += os.write(fd, data[written:])
        finally:
            os.close(fd)

    def _genotype_loci_grouped(self, bam, unmapped_by_vid, read_length,
                               accuracy_filter, average_coverage, update,
                               em: bool = False, group_size: int = 8,
                               ckpt_path=None):
        """Per-locus prep on host, then same-bucket loci scored as grouped
        device calls (one executable per bucket, G loci per dispatch)."""
        from collections import defaultdict
        import numpy as np
        import jax.numpy as jnp
        from advntr_tpu.engine import device_analytics as da
        from advntr_tpu.engine.finder import GenotypeResult

        error_result = (GenotypeResult(None, 0, 0, 0, 0), True)
        results: dict = {}
        prepped = {}
        groups = defaultdict(list)
        for vid in self.target_vntr_ids:
            finder = self.vntr_finder[vid]
            try:
                mapped = self.mapped_candidates(bam, finder, read_length)
                if update:
                    # model updating re-estimates per locus; keep the
                    # sequential path for it
                    results[vid] = (finder.find_repeat_count(
                        mapped, unmapped_by_vid[vid],
                        read_length=read_length,
                        accuracy_filter=accuracy_filter,
                        average_coverage=average_coverage, update=True,
                        em=em),
                        False)
                    continue
                lm = finder.get_model(read_length)
                reads, rows, row_info = finder.prepare_rows(
                    mapped, unmapped_by_vid[vid])
                if not rows or lm.struct is None:
                    results[vid] = (finder.find_repeat_count(
                        mapped, unmapped_by_vid[vid],
                        read_length=read_length,
                        accuracy_filter=accuracy_filter,
                        average_coverage=average_coverage), False)
                    continue
                key = (lm.struct.blk_idx.shape[0],
                       lm.struct.unit_last.shape[0],
                       lm.struct.log_T_struct_t.shape[0],
                       lm.meta[0].shape[0])
                prepped[vid] = (finder, lm, reads, rows, row_info)
                groups[key].append(vid)
            except Exception as error:
                logging.error("Error preparing VNTR %s: %s.", vid, error)
                results[vid] = error_result

        # async pipeline: queue every chunk's device work first (JAX
        # dispatch is asynchronous, so dispatch latency and the host
        # post-processing of earlier chunks overlap device compute), then
        # collect.  Stats per chunk are O(G·B) scalars — negligible memory.
        inflight = []
        for key, vids in groups.items():
            for chunk_start in range(0, len(vids), group_size):
                chunk = vids[chunk_start:chunk_start + group_size]
                try:
                    stats = self._dispatch_group(chunk, prepped,
                                                 group_size=group_size)
                    inflight.append((chunk, stats))
                except Exception as error:
                    logging.error("Grouped dispatch failed (%s); falling "
                                  "back per locus: %s", chunk, error)
                    self.grouped_fallback_vids.extend(chunk)
                    inflight.append((chunk, None))
        for chunk, stats in inflight:
            if stats is not None:
                try:
                    self._collect_group(chunk, prepped, stats, read_length,
                                        results, accuracy_filter,
                                        average_coverage)
                    self._append_checkpoint(ckpt_path, chunk, results)
                    continue
                except Exception as error:
                    logging.error("Grouped collect failed (%s); falling "
                                  "back per locus: %s", chunk, error)
                    self.grouped_fallback_vids.extend(chunk)
            for vid in chunk:
                finder, lm, reads, rows, row_info = prepped[vid]
                try:
                    batch, lengths = finder.pad_rows(rows)
                    per = finder.run_device(lm, batch, lengths)
                    scored = finder.collect_scored(reads, row_info, per)
                    selected = finder.select_from_scored(scored,
                                                         read_length)
                    results[vid] = (finder.genotype_from_selected(
                        selected, accuracy_filter, average_coverage),
                        False)
                except Exception as err2:
                    logging.error("Error genotyping VNTR %s: %s.",
                                  vid, err2)
                    results[vid] = error_result
            self._append_checkpoint(ckpt_path, chunk, results)
        return results

    def _dispatch_group(self, chunk, prepped, group_size: int = 8):
        """Build the grouped batch + model stacks and queue the device call;
        returns the (not yet materialized) device stats dict."""
        import numpy as np
        import jax.numpy as jnp
        from advntr_tpu.engine import device_analytics as da

        # shape discipline: one executable per (group_size, B, L) bucket —
        # short chunks repeat their last locus (results discarded) and the
        # batch axis floors at 512 rows
        pad_chunk = chunk + [chunk[-1]] * (group_size - len(chunk))
        max_len = max(max(len(r) for r in prepped[vid][3]) for vid in chunk)
        L_pad = ((max_len + 31) // 32) * 32
        max_rows = max(len(prepped[vid][3]) for vid in chunk)
        # large panels floor the batch bucket to bound executable count;
        # small runs keep natural sizes (cheap compiles, fast tests)
        b_floor = 512 if len(self.target_vntr_ids) > 16 else 8
        B_pad = max(b_floor, 1 << (max_rows - 1).bit_length())
        batches, lens = [], []
        for vid in pad_chunk:
            finder, lm, reads, rows, row_info = prepped[vid]
            b, ln = finder.pad_rows(rows, length_bucket=1, pad_to=L_pad,
                                    b_pad=B_pad)
            batches.append(b)
            lens.append(ln)
        seqs = np.stack(batches)
        lengths = np.stack(lens)
        stacked_meta = tuple(
            jnp.stack([prepped[vid][1].meta[i] for vid in pad_chunk])
            for i in range(len(prepped[chunk[0]][1].meta)))
        # multi-chip: shard the SAME grouped production executables over a
        # loci x reads mesh (parallel/mesh.py); single chip runs them direct
        mesh = self._get_panel_mesh(group_size, B_pad)
        suffix_lasts = np.array(
            [prepped[vid][1].suffix_last for vid in pad_chunk],
            dtype=np.int32)
        stacked_struct = tuple(
            jnp.stack([prepped[vid][1].struct.flat()[i] for vid in pad_chunk])
            for i in range(len(prepped[chunk[0]][1].struct.flat())))
        if mesh is not None:
            from advntr_tpu.parallel.mesh import sharded_grouped_read_stats
            return sharded_grouped_read_stats(
                mesh, stacked_struct, stacked_meta, jnp.asarray(seqs),
                jnp.asarray(lengths), suffix_lasts=suffix_lasts)
        return da.read_stats_struct_grouped(
            stacked_struct, stacked_meta, jnp.asarray(seqs),
            jnp.asarray(lengths), jnp.asarray(suffix_lasts))

    def _get_panel_mesh(self, group_size: int, batch: int):
        """(loci, reads) device mesh for grouped dispatch, or None when a
        single device is visible (cached per shape)."""
        key = (group_size, batch)
        cache = getattr(self, "_panel_mesh_cache", None)
        if cache is None:
            cache = self._panel_mesh_cache = {}
        if key not in cache:
            from advntr_tpu.parallel.mesh import panel_mesh
            cache[key] = panel_mesh(group_size, batch)
        return cache[key]

    def _collect_group(self, chunk, prepped, stats, read_length, results,
                       accuracy_filter, average_coverage):
        import numpy as np
        stats = {k: np.asarray(v) for k, v in stats.items()}
        for g, vid in enumerate(chunk):
            finder, lm, reads, rows, row_info = prepped[vid]
            try:
                per = {k: v[g] for k, v in stats.items()}
                covered, flanking, n_sel, _ = finder.counts_from_stats(
                    reads, row_info, per, read_length, accuracy_filter)
                results[vid] = (finder.genotype_from_counts(
                    covered, flanking, n_sel, accuracy_filter,
                    average_coverage), False)
            except Exception as error:
                logging.error("Error genotyping VNTR %s: %s.", vid, error)
                results[vid] = (GenotypeResult(None, 0, 0, 0, 0), True)

    def find_frameshift_from_alignment_file(self, alignment_file: str) -> None:
        unmapped_by_vid = self.recruit_unmapped_reads(alignment_file,
                                                      illumina=True)
        with open_alignment(alignment_file, self.ref_filename) as bam:
            read_length = self._median_read_length(bam)
            for vid in self.target_vntr_ids:
                finder = self.vntr_finder[vid]
                try:
                    mapped = self.mapped_candidates(bam, finder, read_length)
                    result = finder.find_frameshift(
                        mapped, unmapped_by_vid[vid], read_length)
                    self._print(str(vid))
                    self._print(str(result))
                except Exception as error:
                    logging.error(
                        "Error in frameshift for VNTR %s: %s.", vid, error)

    def find_repeat_counts_from_pacbio_alignment_file(
            self, alignment_file: str, log_pacbio_reads: bool = False,
            accuracy_filter: bool = False) -> None:
        unmapped_by_vid = self.recruit_unmapped_reads(alignment_file,
                                                      illumina=False)
        self._emit_header()
        with open_alignment(alignment_file, self.ref_filename) as bam:
            for vid in self.target_vntr_ids:
                finder = self.vntr_finder[vid]
                try:
                    result = finder.find_repeat_count_pacbio(
                        bam, unmapped_by_vid[vid],
                        accuracy_filter=accuracy_filter)
                    self.print_genotype(vid, result)
                except Exception as error:
                    logging.error(
                        "Error genotyping VNTR %s: %s. Skipping.", vid, error)
                    self.print_genotype(
                        vid, GenotypeResult(None, 0, 0, 0, 0),
                        encountered_error=True)

    def find_repeat_counts_from_pacbio_reads(self, read_file: str,
                                             log_pacbio_reads: bool = False,
                                             accuracy_filter: bool = False,
                                             naive: bool = False) -> None:
        from advntr_tpu.io import fasta
        filt = build_recruitment_filter(
            self.reference_vntrs, self.target_vntr_ids, short_reads=False,
            keyword_size=self.config.keyword_size,
            min_matches=self.config.min_keyword_matches,
            max_reads_per_locus=self.config.max_reads_per_locus)
        results, sequences = filter_reads(filt, fasta.read_any(read_file))
        self._emit_header()
        for vid in self.target_vntr_ids:
            finder = self.vntr_finder[vid]
            reads = [(name, sequences[name])
                     for name, _ in results.get(vid, [])]
            try:
                result = finder.find_repeat_count_pacbio(
                    None, reads, accuracy_filter=accuracy_filter, naive=naive)
                self.print_genotype(vid, result)
            except Exception as error:
                logging.error("Error genotyping VNTR %s: %s. Skipping.",
                              vid, error)
                self.print_genotype(vid, GenotypeResult(None, 0, 0, 0, 0),
                                    encountered_error=True)

    @staticmethod
    def _median_read_length(bam: BamReader, default: int = 150) -> int:
        lengths = sorted(len(r.seq) for r in bam.head(5))
        return lengths[len(lengths) // 2] if lengths else default
