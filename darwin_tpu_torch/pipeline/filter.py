"""Filter stage: batched first-tile scoring + slope filter.

Replaces filter_body (software/filter.cpp:8-288).  All first tiles of a read
batch (both strands) go to the device in large batches (the reference caps
at first_tile_batch_size=64 per call purely as a CPU artifact; scores are
per-tile independent so batch size does not affect results).

Per anchor (hit, offset):
  ref_tile_start  = hit if hit+T < chr_end else max(chr_end-T, 0)   (:56)
  query_tile_start= offset if offset+T < read_len else max(read_len-T, 0)
  ref_tile_size   = min(T, chr_len);  query_tile_size = min(T, read_len)
  mode: max-cell, no traceback (:40,71)
Keep if score >= first_tile_score_threshold (:89) and
offset + (chr_end - hit) > min_overlap/2 (:105-107); the extension seed is
the tile-max position (:112-113).  Then the slope filter (:230-288) drops
locations whose (ref,query) position lies on a ~diagonal through a
higher-scoring kept location of the same read.

The port's own copy of ``darwin_tpu/pipeline/filter.py`` (host code; the
first tiles themselves are scored by ``ops/dispatch.first_tile_scores``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from darwin_tpu_torch.genome import GenomeStore


@dataclasses.dataclass
class ExtendLocation:
    read_num: int
    chr_id: int
    score: int
    reference_pos: int       # absolute coordinate of tile max
    query_pos: int           # strand-local query coordinate of tile max
    left_hits: np.ndarray    # uint64 chained hits (ascending)
    right_hits: np.ndarray   # uint64 (descending)


@dataclasses.dataclass
class FilterTileBatch:
    """Flat descriptors for one device dispatch of first tiles."""
    r_start: np.ndarray
    r_size: np.ndarray
    q_start: np.ndarray      # offset into the strand-local query sequence
    q_size: np.ndarray
    meta: list               # per tile: (read_num, chr_id, anchor,
                              #           ref_tile_start, query_tile_start)


def build_first_tiles(reads, anchors_per_read,
                      store: GenomeStore, cfg) -> FilterTileBatch:
    """anchors_per_read: list (per read) of chain.Anchor for one strand."""
    T = cfg.first_tile_size
    starts = store.chr_starts
    r_start, r_size, q_start, q_size, meta = [], [], [], [], []
    for read_num, anchors in enumerate(anchors_per_read):
        read_len = reads[read_num].length
        for a in anchors:
            hit, offset = a.hit, a.offset
            chr_id = int(np.searchsorted(starts, hit, side="right")) - 1
            chrom = store.chromosomes[chr_id]
            chr_end = chrom.start + chrom.length
            rts = hit if hit + T < chr_end else (chr_end - T if chr_end > T else 0)
            qts = (offset if offset + T < read_len
                   else (read_len - T if read_len > T else 0))
            r_start.append(rts)
            r_size.append(min(T, chrom.length))
            q_start.append(qts)
            q_size.append(min(T, read_len))
            meta.append((read_num, chr_id, a, rts, qts))
    return FilterTileBatch(
        np.array(r_start, np.int64), np.array(r_size, np.int32),
        np.array(q_start, np.int64), np.array(q_size, np.int32), meta)


def collect_locations(batch: FilterTileBatch, scores, r_max, q_max,
                      store: GenomeStore, cfg) -> List[ExtendLocation]:
    """Threshold + overlap test + ExtendLocations (software/filter.cpp:85-120)."""
    out = []
    for i, (read_num, chr_id, a, rts, qts) in enumerate(batch.meta):
        score = int(scores[i])
        if score < cfg.first_tile_score_threshold:
            continue
        chrom = store.chromosomes[chr_id]
        chr_end = chrom.start + chrom.length
        ovl = a.offset + (chr_end - a.hit)
        if ovl > cfg.min_overlap // 2:
            out.append(ExtendLocation(
                read_num=read_num, chr_id=chr_id, score=score,
                reference_pos=rts + int(r_max[i]),
                query_pos=qts + int(q_max[i]),
                left_hits=a.left_chained, right_hits=a.right_chained))
    return out


def slope_filter(locations: List[ExtendLocation], cfg,
                 counters=None) -> List[ExtendLocation]:
    """software/filter.cpp:230-288.

    Sort by (read asc, score desc, ref_pos asc, query_pos asc); for each kept
    location, drop later same-read locations whose slope
    |(r1-r2)/(q1-q2) - 1| <= slope_threshold.  Division by zero follows IEEE
    like the C float math: q1==q2 gives inf (r1!=r2, not dropped) or nan
    (r1==r2, comparison false, not dropped).
    """
    if not locations:
        return []
    locs = sorted(locations, key=lambda l: (
        l.read_num, -l.score, l.reference_pos, l.query_pos))
    dropped = [False] * len(locs)
    out = []
    for i, l1 in enumerate(locs):
        if dropped[i]:
            continue
        out.append(l1)
        for j in range(i + 1, len(locs)):
            if dropped[j]:
                continue
            l2 = locs[j]
            if l2.read_num != l1.read_num:
                break
            r1, q1 = float(l1.reference_pos), float(l1.query_pos)
            r2, q2 = float(l2.reference_pos), float(l2.query_pos)
            with np.errstate(divide="ignore", invalid="ignore"):
                slope = abs(np.float32(
                    (np.float32(r1) - np.float32(r2))
                    / (np.float32(q1) - np.float32(q2)) - np.float32(1.0)))
            if slope <= np.float32(cfg.slope_threshold):
                dropped[j] = True
                if counters is not None:
                    counters["num_slope_filtered"] += 1
    return out
