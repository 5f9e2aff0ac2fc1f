"""Genome-alignment projection mode (`--genome-alignments --annotation`).

Equivalent of `run_genome_alignments` (`main.rs:182-235`) +
`quantify_genome_alignments_from_bam` (`bulk.rs:268-323`) +
`parse_genome_alignments` (`alignment_parser.rs:580-700`): a name-collated
spliced genome BAM is streamed, each read's alignments are projected onto
the transcripts of the annotation, filtered (`filter_projected`), and
quantified with the same device EM + output tail as alignment mode.

Soft-clip rescue against neighboring exon sequence (bramble's
default-on feature, disabled by `--no-rescue`) IS implemented: when a
genome FASTA is supplied (`--genome`), a `RescueDb` is built from it and
soft-clipped tails are re-aligned against the flanking exon sequence
during projection (see `genome/rescue.py`; measured effect in
`scripts/rescue_eval.py` — rescue roughly halves MARD on a simulated
skipped-exon world). Without a FASTA the mode degrades to `--no-rescue`
behavior, since there is no sequence to rescue against.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np

from ..config import Args, FilterOpts
from ..constants import EMPTY_READ_NAME
from ..genome.annotation import load_transcripts
from ..genome.g2t import G2TIndex
from ..genome.project import (
    GenomicAlignment,
    ProjectedAlnRecord,
    filter_projected,
    project_group,
)
from ..host.store import StoreBuilder, TranscriptCoverage
from ..io.bam import BamReader, verify_header
from ..utils.digest import LazyDigest, digest_from_header
from .bulk import perform_inference_and_write_output

log = logging.getLogger("oarfish_tpu")


def _record_to_genomic_alignment(rec) -> GenomicAlignment:
    """`record_buf_to_genomic_alignment` (`alignment_parser.rs:484-524`),
    restricted to the fields the projection consumes."""
    # query length from CIGAR read-consuming ops when SEQ is absent
    read_len = rec.seq_len
    if read_len == 0 and rec.cigar:
        read_len = sum(
            l for l, op in rec.cigar if op in (0, 1, 4, 7, 8)
        )
    return GenomicAlignment(
        ref_id=rec.ref_id,
        ref_start=rec.pos + 1,
        is_reverse=rec.is_reverse,
        cigar=rec.cigar or [],
        read_len=read_len,
        score=rec.score if rec.score is not None else 0,
        sequence=rec.seq,
    )


def quantify_genome_alignments_from_bam(args: Args, opts: FilterOpts):
    annotation = args.annotation
    bam_path = args.genome_alignments
    log.info("operating in genome-alignment (projection) mode")

    reader = BamReader(bam_path, threads=max(args.threads - 1, 1))
    # genome mode does not restrict the aligner (`alignment_parser.rs:106-137`)
    verify_header(reader.header, bam_path, require_known_mapper=False)
    refnames = reader.header.ref_names

    log.info("loading annotation from %s", annotation)
    transcripts = load_transcripts(annotation)
    log.info("loaded %d transcripts from annotation", len(transcripts))
    g2t = G2TIndex(transcripts, refnames)

    # soft-clip rescue (on by default when a genome FASTA is available;
    # genome-BAM mode sources it from --genome-fasta only, `main.rs:211-215`)
    rescue_db = None
    if not args.no_rescue and args.genome_fasta is not None:
        from ..genome.rescue import RescueDb

        log.info(
            "loading genome FASTA for soft-clip rescue from %s",
            args.genome_fasta,
        )
        rescue_db = RescueDb.from_fasta(args.genome_fasta, refnames)
    txps_name = list(g2t.names)
    txps_len = g2t.transcript_lengths()
    log.info("built g2t index over %d transcripts", g2t.num_transcripts)

    digest = {
        "transcriptome_digest": LazyDigest(
            digest_from_header, txps_name, txps_len
        )
    }

    coverage = TranscriptCoverage(
        txps_len, args.bin_width if opts.model_coverage else 0
    )
    builder = StoreBuilder(coverage, keep_names=opts.write_assignment_probs)

    # native projection engine over batches of read groups (the same
    # engine as genome-reads mode; OARFISH_PROJECT_NATIVE=0 falls back
    # to the per-record Python oracle)
    import os as _os

    from ..genome import project_native as pn
    from ..genome.project import _walk_cigar

    use_native = (
        _os.environ.get("OARFISH_PROJECT_NATIVE", "1") != "0"
        and pn.available()
    )
    flat_g2t = None
    if use_native:
        flat_g2t = pn.FlatG2T(g2t, rescue_db=rescue_db)

    t0 = time.time()
    num_unmapped = 0
    prev_name = None
    group: List = []
    seen = set()
    rg_num = 0

    BATCH_GROUPS = 20_000
    batch: List = []  # (name, alns, n_records)

    def flush_batch():
        """Project a batch of groups through the native engine (one
        record = one 'hit'; CIGAR-walked blocks, N-op introns, tol 0 —
        matching project_alignment/project_group exactly)."""
        if not batch:
            return
        n_reads = len(batch)
        bs: List[int] = []
        be: List[int] = []
        is_l: List[int] = []
        ie_l: List[int] = []
        chroms: List[int] = []
        rcs: List[int] = []
        scores: List[int] = []
        qas: List[int] = []
        block_off = [0]
        intron_off = [0]
        read_off = [0]
        clL = bytearray()
        clR = bytearray()
        clL_off = [0]
        clR_off = [0]
        for _name, alns, _nrec in batch:
            for a in alns:
                blocks, introns, q_aligned = _walk_cigar(a)
                for s, e in blocks:
                    bs.append(s)
                    be.append(e)
                for s, e in introns:
                    is_l.append(s)
                    ie_l.append(e)
                block_off.append(len(bs))
                intron_off.append(len(is_l))
                chroms.append(a.ref_id)
                rcs.append(1 if a.is_reverse else 0)
                scores.append(a.score)
                qas.append(q_aligned)
                # clip gating mirrors project_alignment: clips ship
                # when EITHER end is soft-clipped at all (>=1 base)
                if rescue_db is not None and a.sequence:
                    c5 = (a.cigar[0][0]
                          if a.cigar and a.cigar[0][1] == 4 else 0)
                    c3 = (a.cigar[-1][0]
                          if a.cigar and a.cigar[-1][1] == 4 else 0)
                    if c5 or c3:
                        seq = a.sequence.upper()
                        if c5:
                            clL.extend(seq[:c5])
                        if c3:
                            clR.extend(seq[len(seq) - c3:])
                clL_off.append(len(clL))
                clR_off.append(len(clR))
            read_off.append(len(chroms))

        hit_off, tid, pstart, pend, matched, sim, is_rev = (
            pn.project_batch_native(
                flat_g2t,
                hit_chrom=np.asarray(chroms, np.int32),
                block_off=np.asarray(block_off, np.int64),
                block_s=np.asarray(bs, np.int64),
                block_e=np.asarray(be, np.int64),
                intron_off=np.asarray(intron_off, np.int64),
                intron_s=np.asarray(is_l, np.int64),
                intron_e=np.asarray(ie_l, np.int64),
                hit_is_rc=np.asarray(rcs, np.uint8),
                q_aligned=np.asarray(qas, np.int64),
                clips=(
                    (bytes(clL), np.asarray(clL_off, np.int64),
                     bytes(clR), np.asarray(clR_off, np.int64))
                    if rescue_db is not None else None
                ),
                junc_miss_discount=args.junc_miss_discount,
                tol=0,
                threads=max(args.threads, 1),
            )
        )
        read_off_a = np.asarray(read_off, np.int64)
        ccount = np.diff(hit_off)
        hit_read = np.repeat(
            np.arange(n_reads), np.diff(read_off_a)
        )
        cand_read = np.repeat(hit_read, ccount)
        cand_score = np.repeat(np.asarray(scores, np.int64), ccount)
        sel, roff = pn.dedup_best(
            cand_read, tid, sim, n_reads, g2t.num_transcripts
        )
        if os.environ.get("OARFISH_BATCH_FILTER", "1") != "0":
            # vectorized filter (same batch machinery as genome_reads;
            # the per-read loop below stays as the differential oracle)
            from ..genome.project import filter_projected_batch

            cand_per_read = np.diff(roff)
            read_lens = np.asarray(
                [next((a.read_len for a in alns if a.read_len > 0), 0)
                 for _n, alns, _c in batch], np.int64)
            tid_d = tid[sel]
            ps_d = pstart[sel]
            pe_d = pend[sel]
            kept, prob, read_ok = filter_projected_batch(
                opts, builder.discard, txps_len, roff,
                tid_d, ps_d, pe_d, matched[sel], sim[sel],
                cand_score[sel], np.asarray(is_rev[sel], bool),
                read_lens, args.projected_prob_beta,
                args.projected_prob_source,
            )
            if read_ok.any():
                rid_d = np.repeat(np.arange(n_reads), cand_per_read)
                tlk = txps_len[tid_d[kept]]
                s_c = np.minimum(np.maximum(ps_d[kept], 1), tlk)
                e_c = np.minimum(np.maximum(pe_d[kept], s_c), tlk)
                sizes = np.bincount(
                    rid_d[kept], minlength=n_reads
                )[read_ok]
                batch_names = None
                if builder.read_names is not None:
                    batch_names = [
                        batch[r][0] or EMPTY_READ_NAME
                        for r in np.nonzero(read_ok)[0]
                    ]
                builder.add_filtered_batch(
                    tid_d[kept], s_c, e_c, prob[kept], sizes,
                    names=batch_names,
                )
                nrecs = np.asarray([b[2] for b in batch])
                builder.num_unique_alignments += int(
                    ((nrecs == 1) & read_ok).sum()
                )
            batch.clear()
            return

        for r, (name, alns, nrec) in enumerate(batch):
            a0, b0 = int(roff[r]), int(roff[r + 1])
            if a0 == b0:
                continue
            read_len = next(
                (a.read_len for a in alns if a.read_len > 0), 0
            )
            projected = [
                ProjectedAlnRecord(
                    ref_id=int(tid[j]), start=int(pstart[j]),
                    end=int(pend[j]),
                    aligned_len=int(pend[j] - pstart[j] + 1),
                    query_aligned_len=int(matched[j]),
                    is_reverse=bool(is_rev[j]),
                    similarity=float(sim[j]),
                    aln_score=int(cand_score[j]),
                )
                for j in sel[a0:b0]
            ]
            fg = filter_projected(
                opts, builder.discard, txps_len, projected, read_len,
                args.projected_prob_beta, args.projected_prob_source,
            )
            if fg is not None and builder.add_filtered_group(
                fg, name if name else EMPTY_READ_NAME
            ):
                if nrec == 1:
                    builder.num_unique_alignments += 1
        batch.clear()

    def flush(name, group):
        if not group:
            return
        alns = [_record_to_genomic_alignment(r) for r in group]
        if use_native:
            batch.append((name, alns, len(group)))
            if len(batch) >= BATCH_GROUPS:
                flush_batch()
            return
        read_len = next((a.read_len for a in alns if a.read_len > 0), 0)
        projected = project_group(
            alns, g2t, args.junc_miss_discount, rescue_db
        )
        if not projected:
            return
        fg = filter_projected(
            opts,
            builder.discard,
            txps_len,
            projected,
            read_len,
            args.projected_prob_beta,
            args.projected_prob_source,
        )
        if fg is not None and builder.add_filtered_group(
            fg, name if name else EMPTY_READ_NAME
        ):
            # uniqueness judged on the genomic record-group size
            # (`alignment_parser.rs:655,688`)
            if len(group) == 1:
                builder.num_unique_alignments += 1

    for rec in reader.records(keep_cigar=True, keep_seq=rescue_db is not None):
        if rec.is_unmapped:
            num_unmapped += 1
            continue
        if rec.name != prev_name:
            flush(prev_name, group)
            group = []
            prev_name = rec.name
            if rg_num < args.sort_check_num:
                if rec.name in seen:
                    raise ValueError(
                        "the input genome BAM appears not to be "
                        f"name-collated: read {rec.name!r} was observed "
                        "twice in a non-contiguous block. Try `samtools "
                        "collate`."
                    )
                seen.add(rec.name)
                rg_num += 1
        if rec.ref_id >= 0:
            group.append(rec)
    flush(prev_name, group)
    if use_native:
        flush_batch()

    store = builder.finalize()
    aln_time_s = time.time() - t0
    log.info(
        "the genome alignment file contained %d unmapped read records.",
        num_unmapped,
    )

    return perform_inference_and_write_output(
        store,
        coverage,
        txps_name,
        txps_len,
        opts,
        args,
        digest,
        aln_time_s,
    )
