"""SAM and MHAP output (printer_body, software/printer.cpp:7-180): the
port's own copy of ``darwin_tpu/pipeline/printer.py``'s ``sam_header``,
``sam_lines`` and ``mhap_lines``.

``sam_lines`` builds a batch's CIGARs in one call to the native host
library (``native.sam_cigars_native``), and raises without it.  Both
printers mark two sub-stages of a batch's ``print``: ``print_select``
(the sort and the suppression loops) and ``print_format`` (decoding,
match counting and the records' text)."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from darwin_tpu_torch import native
from darwin_tpu_torch.genome import GenomeStore
from darwin_tpu_torch.pipeline.extend import ExtendAlignment
from darwin_tpu_torch.utils.stages import mark


def sam_header(store: GenomeStore) -> str:
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    for c in store.chromosomes:
        lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length_unpadded}")
    return "\n".join(lines) + "\n"


def sam_lines(alignments: List[ExtendAlignment], reads,
              store: GenomeStore, stage_seconds=None) -> List[str]:
    """software/printer.cpp:7-98, minus the header (emitted once)."""
    t0 = time.perf_counter()
    als = sorted(alignments, key=lambda e: (e.read_num, -e.score))
    # suppress secondaries overlapping > 50% of a better one (:23-48)
    for i, e1 in enumerate(als):
        if not e1.do_print:
            continue
        s1, e_1 = e1.query_start_offset, e1.query_end_offset
        for j in range(i + 1, len(als)):
            e2 = als[j]
            if not e2.do_print:
                continue
            if e2.read_num != e1.read_num:
                break
            s2, e_2 = e2.query_start_offset, e2.query_end_offset
            s, e = max(s1, s2), min(e_1, e_2)
            overlap = e - s if e > s else 0
            if 2 * overlap > (e_2 - s2):
                e2.do_print = False
    t0 = mark(stage_seconds, "print_select", t0)

    printed = [e for e in als if e.do_print]
    cigars = native.sam_cigars_native(
        [e.aligned_reference for e in printed],
        [e.aligned_query for e in printed],
        [e.query_start_offset for e in printed],
        [e.query_length - e.query_end_offset - 1 for e in printed])
    if cigars is None:
        raise RuntimeError("SAM CIGARs: " + native.unavailable_reason())
    out = []
    for e, cigar in zip(printed, cigars):
        read = reads[e.read_num]
        flag = (16 if e.strand == "-" else 0) + 64
        seq = (read.rc_seq if e.strand == "-" else read.seq).tobytes().decode()
        out.append("\t".join([
            read.name, str(flag), store.chromosomes[e.chr_id].name,
            str(1 + e.reference_start_offset), "60", cigar, "*", "0",
            "0", seq, "*", f"AS:i:{e.score}", f"ZS:i:{e.score}",
        ]) + "\n")
    mark(stage_seconds, "print_format", t0)
    return out


def mhap_lines(alignments: List[ExtendAlignment], reads,
               store: GenomeStore, cfg, counters: dict,
               stage_seconds=None) -> List[str]:
    """software/printer.cpp:100-180: per read and target, the best
    alignment that reaches the last tenth of either sequence, as two MHAP
    records (target-query and query-target), each followed by its two
    aligned strings.

    counters: the batch's counter dict, given the alignments' fates: each
    is printed (``num_mhap_printed``), or dropped as not selected
    (``num_mhap_unselected``), as a read's alignment to itself
    (``num_mhap_self``) or as shorter than ``min_overlap``
    (``num_mhap_short``), in that order of precedence; and the aligned
    columns of those printed and of those dropped
    (``mhap_columns_printed``, ``mhap_columns_dropped``)."""
    t0 = time.perf_counter()
    als = sorted(alignments, key=lambda e: (e.read_num, e.chr_id, -e.score))
    for i, e1 in enumerate(als):
        ref_end = 1 + e1.reference_end_offset
        query_end = 1 + e1.query_end_offset
        if (ref_end < (9 * e1.reference_length) // 10
                and query_end < (9 * e1.query_length) // 10):
            e1.do_print = False
        if not e1.do_print:
            continue
        for j in range(i + 1, len(als)):
            e2 = als[j]
            if not e2.do_print:
                continue
            if e2.read_num != e1.read_num:
                break
            if e1.chr_id != e2.chr_id:
                break
            e2.do_print = False
    t0 = mark(stage_seconds, "print_select", t0)

    out = []
    for e in als:
        read = reads[e.read_num]
        r1 = store.chromosomes[e.chr_id].name
        r2 = read.name
        ral = e.reference_end_offset + 1 - e.reference_start_offset
        qal = e.query_end_offset + 1 - e.query_start_offset
        ovl = (ral + qal) // 2
        if not e.do_print:
            why = "num_mhap_unselected"
        elif r1 == r2:
            why = "num_mhap_self"
        elif ovl < cfg.min_overlap:
            why = "num_mhap_short"
        else:
            why = "num_mhap_printed"
        printed = why == "num_mhap_printed"
        counters[why] += 1
        counters["mhap_columns_printed" if printed
                 else "mhap_columns_dropped"] += len(e.aligned_reference)
        if not printed:
            continue
        strand = 1 if e.strand == "-" else 0
        ar = e.aligned_reference.decode()
        aq = e.aligned_query.decode()
        matches = int(np.count_nonzero(
            np.frombuffer(e.aligned_reference.upper(), np.uint8)
            == np.frombuffer(e.aligned_query.upper(), np.uint8)))
        # the reference narrows to float32 before printf re-promotes
        # (printer.cpp:166 `float error = ...`); the narrowing moves
        # half-ulp cases across the %.3f rounding boundary (e.g.
        # 147/1200: double 0.12249999... -> "0.122", float32
        # 0.12250000238 -> "0.123")
        error = float(np.float32((1.0 * (ovl - matches)) / ovl))
        rs, re = 1 + e.reference_start_offset, 1 + e.reference_end_offset
        qs, qe = 1 + e.query_start_offset, 1 + e.query_end_offset
        rlen = store.chromosomes[e.chr_id].length_unpadded
        qlen = read.length
        out.append(f"{r1} {r2} {error:.3f} {matches} 0 {rs} {re} {rlen} "
                   f"{strand} {qs} {qe} {qlen}\n")
        out.append(ar + "\n")
        out.append(aq + "\n")
        out.append(f"{r2} {r1} {error:.3f} {matches} {strand} {qs} {qe} "
                   f"{qlen} 0 {rs} {re} {rlen}\n")
        out.append(aq + "\n")
        out.append(ar + "\n")
    mark(stage_seconds, "print_format", t0)
    return out
