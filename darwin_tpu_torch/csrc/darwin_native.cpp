// Native host-runtime components of darwin_tpu_torch: the port's own copy
// of native/darwin_native.cpp (the one darwin_tpu builds), same entry points.
//
// The reference implements its host runtime in C++ (TBB pipeline, AVX2
// kernels); here the device does the heavy compute and the host runtime's
// remaining hot loops live in this small C-ABI library, loaded via ctypes
// (plain C ABI, no binding generator needed).  The bindings are in
// darwin_tpu_torch/native.py.
//
// Components:
//   encode_seq    - ASCII -> 5-letter and 2-bit codes (ntcoding.cpp:11-23,79-92)
//   revcomp       - reverse complement with reference-identical validation
//                   (RevComp, main.cpp:59-121)
//   fasta_scan    - index FASTA records in a memory buffer (kseq equivalent)
//   chain_anchors - D-SOFT per-anchor collinear chaining
//                   (seed_pos_table.cpp:391-498)
//   decode_ops    - GACT traceback-op application with the early-cutoff
//                   word quirk (extender.cpp:280-331)
//   expand_records - the walker's per-column records -> op arrays
//   score_alignment - two-piece rescore of an emitted alignment
//                   (AlignmentScore, extender.cpp:1161-1200)
//   ext_table_*   - a read batch's extensions and their tile state machine
//                   (extender.cpp:34-533): requests, the decode of a chain
//                   level with its acceptance, the emitted alignments
//   sam_cigars    - every printed SAM record's CIGAR of a batch
//                   (printer.cpp:219-292)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// sequence encoding
// ---------------------------------------------------------------------------

// The lookup tables are function-local statics built by their initialiser,
// which C++11 runs exactly once even when threads make the first call
// together (two read batches in flight do).
struct CodeTables {
    uint8_t tbl5[256];
    uint8_t tbl2[256];
    CodeTables() {
        memset(tbl5, 4, sizeof(tbl5));
        memset(tbl2, 0, sizeof(tbl2));
        const char* b = "ACGT";
        for (int i = 0; i < 4; i++) {
            tbl5[(uint8_t)b[i]] = i;
            tbl5[(uint8_t)(b[i] + 32)] = i;
            tbl2[(uint8_t)b[i]] = i;
            tbl2[(uint8_t)(b[i] + 32)] = i;
        }
    }
};

struct CompTable {
    uint8_t comp[256];
    CompTable() {
        memset(comp, 0, sizeof(comp));
        const char* a = "acgtACGTnN";
        const char* b = "tgcaTGCAnN";
        for (int i = 0; i < 10; i++) comp[(uint8_t)a[i]] = (uint8_t)b[i];
    }
};

void encode_seq(const uint8_t* ascii, int64_t n, uint8_t* codes5,
                uint8_t* codes2) {
    static const CodeTables t;
    for (int64_t i = 0; i < n; i++) {
        codes5[i] = t.tbl5[ascii[i]];
        codes2[i] = t.tbl2[ascii[i]];
    }
}

// Returns -1 on success, else the index of the first invalid character.
int64_t revcomp(const uint8_t* in, int64_t n, uint8_t* out) {
    static const CompTable t;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = t.comp[in[i]];
        if (c == 0) return i;
        out[n - 1 - i] = c;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// FASTA scanning: find records in a text buffer.  Writes per-record
// (name_start, name_end, seq_len) and compacts sequence bytes (newlines
// stripped) into seq_out at seq_offsets.  Two-phase: call with
// seq_out == nullptr to get counts.  Returns the number of records,
// or -1 if the buffer is not FASTA.
// ---------------------------------------------------------------------------

int64_t fasta_scan(const uint8_t* data, int64_t n,
                   int64_t* name_start, int64_t* name_end,
                   int64_t* seq_offsets, int64_t max_records,
                   uint8_t* seq_out) {
    int64_t rec = 0;
    int64_t i = 0;
    int64_t out_pos = 0;
    while (i < n && (data[i] == '\n' || data[i] == '\r')) i++;
    if (i >= n || data[i] != '>') return -1;
    while (i < n) {
        if (data[i] != '>') return -1;
        i++;
        int64_t ns = i;
        while (i < n && data[i] != '\n' && data[i] != '\r' &&
               data[i] != ' ' && data[i] != '\t') i++;
        int64_t ne = i;
        while (i < n && data[i] != '\n') i++;  // rest of header line
        if (i < n) i++;
        if (rec < max_records) {
            name_start[rec] = ns;
            name_end[rec] = ne;
            seq_offsets[rec] = out_pos;
        }
        while (i < n && data[i] != '>') {
            uint8_t c = data[i];
            if (c != '\n' && c != '\r') {
                if (seq_out) seq_out[out_pos] = c;
                out_pos++;
            }
            i++;
        }
        rec++;
    }
    if (rec < max_records + 1) seq_offsets[rec] = out_pos;
    return rec;
}

// total sequence bytes (for buffer sizing)
int64_t fasta_seq_bytes(const uint8_t* data, int64_t n) {
    int64_t total = 0;
    int64_t i = 0;
    while (i < n) {
        if (data[i] == '>') {
            while (i < n && data[i] != '\n') i++;
        } else if (data[i] != '\n' && data[i] != '\r') {
            total++;
        }
        i++;
    }
    return total;
}

// ---------------------------------------------------------------------------
// D-SOFT chaining (seed_pos_table.cpp:391-498).
// hits_* are the device-sorted hit arrays (bin ascending, offset ascending
// within bin).  For each anchor: window = bins in [bin-sv, bin+sv), split
// by the packed (hit<<32)|offset key, greedy collinear filter outward from
// the anchor, chain score += min(dh,do) - |dh-do|/10.
//
// Outputs: concatenated left chains (ascending) and right chains
// (descending) as uint64 keys with prefix offsets, plus per-anchor
// num_chained and score.  Returns the required chain capacity; if it
// exceeds `cap`, nothing past cap is written (caller retries bigger).
// ---------------------------------------------------------------------------

int64_t chain_anchors(const int64_t* hits_bin, const int32_t* hits_off,
                      const int32_t* hits_pos, int64_t n_hits,
                      const int32_t* anc_pos, const int32_t* anc_off,
                      const int64_t* anc_bin, int64_t n_anc,
                      int64_t sv,
                      uint64_t* left_out, int64_t* left_offsets,
                      uint64_t* right_out, int64_t* right_offsets,
                      int32_t* num_chained, int64_t* scores,
                      int64_t cap) {
    int64_t lpos = 0, rpos = 0;
    std::vector<uint64_t> wleft, wright, keep;
    int64_t lo = 0;
    for (int64_t a = 0; a < n_anc; a++) {
        int64_t curr_bin = anc_bin[a];
        uint64_t akey = ((uint64_t)(uint32_t)anc_pos[a] << 32)
                        | (uint32_t)anc_off[a];
        // window [curr_bin - sv, curr_bin + sv) via binary search
        int64_t wlo = std::lower_bound(hits_bin, hits_bin + n_hits,
                                       curr_bin - sv)
                      - hits_bin;
        int64_t whi = std::lower_bound(hits_bin, hits_bin + n_hits,
                                       curr_bin + sv)
                      - hits_bin;
        (void)lo;
        wleft.clear();
        wright.clear();
        for (int64_t h = wlo; h < whi; h++) {
            uint64_t key = ((uint64_t)(uint32_t)hits_pos[h] << 32)
                           | (uint32_t)hits_off[h];
            if (key <= akey) wleft.push_back(key);
            if (key >= akey) wright.push_back(key);
        }
        std::sort(wleft.begin(), wleft.end());
        std::sort(wright.begin(), wright.end());

        int64_t score = 0;

        // left collinear: anchor (largest) downward (:440-459)
        keep.clear();
        keep.push_back(wleft.back());
        uint64_t cur = wleft.back();
        for (int64_t h = (int64_t)wleft.size() - 2; h >= 0; h--) {
            uint64_t cand = wleft[h];
            uint32_t h1 = cur >> 32, o1 = (uint32_t)cur;
            uint32_t h2 = cand >> 32, o2 = (uint32_t)cand;
            if (h1 >= h2 && o1 >= o2) {
                int64_t dh = h1 - h2, dof = o1 - o2;
                int64_t m = std::min(dh, dof);
                int64_t g = dh > dof ? dh - dof : dof - dh;
                score += m - g / 10;
                keep.push_back(cand);
                cur = cand;
            }
        }
        std::sort(keep.begin(), keep.end());
        left_offsets[a] = lpos;
        for (uint64_t k : keep)
            if (lpos < cap) left_out[lpos++] = k; else lpos++;
        int64_t nleft = (int64_t)keep.size();

        // right collinear: anchor (smallest) upward, stored DESCENDING
        // (:470-490)
        keep.clear();
        keep.push_back(wright.front());
        cur = wright.front();
        for (size_t h = 1; h < wright.size(); h++) {
            uint64_t cand = wright[h];
            uint32_t h1 = cur >> 32, o1 = (uint32_t)cur;
            uint32_t h2 = cand >> 32, o2 = (uint32_t)cand;
            if (h1 <= h2 && o1 <= o2) {
                int64_t dh = h2 - h1, dof = o2 - o1;
                int64_t m = std::min(dh, dof);
                int64_t g = dh > dof ? dh - dof : dof - dh;
                score += m - g / 10;
                keep.push_back(cand);
                cur = cand;
            }
        }
        right_offsets[a] = rpos;
        for (auto it = keep.rbegin(); it != keep.rend(); ++it)
            if (rpos < cap) right_out[rpos++] = *it; else rpos++;

        num_chained[a] = (int32_t)(nleft + keep.size());
        scores[a] = score;
    }
    left_offsets[n_anc] = lpos;
    right_offsets[n_anc] = rpos;
    return std::max(lpos, rpos);
}

// ---------------------------------------------------------------------------
// GACT traceback-op application (one tile), replicating the reference's
// early-cutoff-per-32-op-word quirk (extender.cpp:280-331) and boundary
// clamps.  direction: 0 = left (walk backward), 1 = right (walk forward).
//
// Inputs: ops[n] (2-bit codes in traceback order), current offsets, the
// base buffers.  Outputs: ref/query aligned chars (in ALIGNMENT order for
// the chunk), counts, updated offsets, boundary markers.
// Returns the number of alignment columns written.
// ---------------------------------------------------------------------------

static int64_t decode_ops(const uint8_t* ops, int64_t n_ops,
                          int64_t stop_thr, int32_t direction,
                          const uint8_t* bases, int64_t ref_start_addr,
                          const uint8_t* qbytes,
                          int64_t curr_ref_in, int64_t curr_q_in,
                          int64_t ref_len, int64_t q_len,
                          uint8_t* out_ref, uint8_t* out_q,
                          int64_t* curr_ref_out, int64_t* curr_q_out,
                          int32_t* hit_ref_bound, int32_t* hit_q_bound) {
    int64_t curr_ref = curr_ref_in;
    int64_t curr_q = curr_q_in;
    int64_t cols = 0;
    int64_t steps = 0;
    int32_t rb = 0, qb = 0;
    for (int64_t t = 0; t < n_ops; t += 32) {
        int64_t num_p = std::min<int64_t>(n_ops - t, 32);
        for (int64_t p = 0; p < num_p; p++) {
            uint8_t op = ops[t + p];
            uint8_t rc, qc;
            if (direction == 0) {  // left, backward
                rc = (op != 1) ? bases[ref_start_addr + curr_ref] : '-';
                qc = (op != 2) ? qbytes[curr_q] : '-';
                if (op != 1) {  // consumes ref
                    if (curr_ref > 0) curr_ref--; else rb = 1;
                }
                if (op != 2) {  // consumes query
                    if (curr_q > 0) curr_q--; else qb = 1;
                }
            } else {  // right, forward
                rc = (op != 1) ? bases[ref_start_addr + curr_ref] : '-';
                qc = (op != 2) ? qbytes[curr_q] : '-';
                if (op != 1 && curr_ref < ref_len) curr_ref++;
                if (op != 2 && curr_q < q_len) curr_q++;
            }
            out_ref[cols] = rc;
            out_q[cols] = qc;
            cols++;
            steps++;
            if (steps >= stop_thr && op == 3) break;  // inner loop only
        }
    }
    *curr_ref_out = curr_ref;
    *curr_q_out = curr_q;
    *hit_ref_bound = rb;
    *hit_q_bound = qb;
    return cols;
}


// ---------------------------------------------------------------------------
// expand_records - the traceback walker's per-column records -> the serial
// walker's op arrays (darwin_tpu/ops/gact_pallas.py:945-975).  rec is an
// (RT, n) int32 matrix addressed by element strides (s_row, s_lane), so a
// slice of a fetched record matrix is read in place.  A record's low 16
// bits hold the column's insert-run length (bits 0-13) and its closing op
// (bits 14-15, 0 = none).  Each lane's walk runs from column RT-1 down to 0
// and writes nI copies of OP_I, then the closing op when it is non-zero; a
// zero record (a column the walk did not visit) writes nothing.  ops is
// (n, L) and must hold zeros; ops past L are dropped, n_ops is the true
// count.
// ---------------------------------------------------------------------------

void expand_records(const int32_t* rec, int64_t RT, int64_t n,
                    int64_t s_row, int64_t s_lane, int64_t L,
                    uint8_t* ops, int32_t* n_ops) {
    const uint8_t OP_I = 1;
    for (int64_t b = 0; b < n; b++) {
        const int32_t* col = rec + b * s_lane;
        uint8_t* out = ops + b * L;
        int64_t p = 0;
        for (int64_t r = RT - 1; r >= 0; r--) {
            uint32_t w = (uint32_t)col[r * s_row] & 0xFFFF;
            if (w == 0) continue;
            int64_t n_ins = w & 0x3FFF;
            uint8_t closing = (uint8_t)(w >> 14);
            if (n_ins != 0) {
                if (p < L) memset(out + p, OP_I, std::min(n_ins, L - p));
                p += n_ins;
            }
            if (closing != 0) {
                if (p < L) out[p] = closing;
                p++;
            }
        }
        n_ops[b] = (int32_t)p;
    }
}

// ---------------------------------------------------------------------------
// score_alignment - two-piece rescore of an aligned pair (AlignmentScore,
// extender.cpp:1161-1200; darwin_tpu/pipeline/extend.py:60-90).  A column
// is a gap when either side is '-', so a reference-gap run that abuts a
// query-gap run is one run.  Each run adds max(short, long) when it closes
// at a non-gap column; a run at the very end is never added.  A non-gap
// column adds sub5[code(q) * 5 + code(ref)], with A/C/G/T in either case
// coded 0-3 and every other byte 4.
// ---------------------------------------------------------------------------

int64_t score_alignment(const uint8_t* ref, const uint8_t* q, int64_t n,
                        const int64_t* sub5, int64_t gap_open,
                        int64_t gap_extend, int64_t long_gap_open,
                        int64_t long_gap_extend) {
    static const CodeTables t;
    int64_t score = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < n; i++) {
        if (ref[i] == '-' || q[i] == '-') {
            run++;
            continue;
        }
        if (run != 0) {
            score += std::max(gap_open + (run - 1) * gap_extend,
                              long_gap_open + (run - 1) * long_gap_extend);
            run = 0;
        }
        score += sub5[t.tbl5[q[i]] * 5 + t.tbl5[ref[i]]];
    }
    return score;
}

// ---------------------------------------------------------------------------
// The extension table: every extension of one read batch with its tile
// state machine (ExtendAlignments, graph.h:97-121; extender.cpp:34-533;
// darwin_tpu/pipeline/extend.py:115-370, whose _Ext it holds field for
// field).  One table per ExtensionManager.run(); two batches in flight use
// two tables from two threads, and nothing here is shared between tables.
//
// Per extension: the strand, its chromosome's start and length, the read's
// length and offset in the query buffer, the current position, the four
// start / end offsets, the left / right / large-tile flags, the chained
// hits as [begin, end) ranges of two shared uint64 arrays (popping moves
// end down), the tile count and the aligned columns of each side.  The
// left side's columns are kept in decode order (walking backward) and
// reversed once at emit, which is the reference's prepend of each chunk.
//
// Entry points return a negative code on a fault the caller raises for:
// EXT_BAD_INDEX (an extension or row out of range), EXT_BAD_OPS (a tile's
// op count outside its row), EXT_NO_HIT (a large tile asked for with no
// chained hit left, where darwin_tpu's hits[-1] raises).
// ---------------------------------------------------------------------------

enum { EXT_BAD_INDEX = -1, EXT_BAD_OPS = -2, EXT_NO_HIT = -3 };

// request fields, in the order ext_requests writes them
enum { RQ_R_START, RQ_R_SIZE, RQ_Q_START, RQ_Q_SIZE, RQ_REV, RQ_RT, RQ_QT,
       RQ_N };

struct Ext {
    int64_t ref_start_addr, ref_len, q_len, q_code_start;
    int64_t curr_ref, curr_q;
    int64_t ref_start_off, q_start_off, ref_end_off, q_end_off;
    int64_t lbeg, lend, rbeg, rend;
    int64_t tiles;
    int64_t req[RQ_N];      // the request of a lane refused at a level
    bool rc, left_done, right_done, used_large, finished, emitted, has_req;
    std::vector<uint8_t> left_ref, left_q, right_ref, right_q;
};

struct ExtTable {
    std::vector<Ext> ext;
    std::vector<uint64_t> left_hits, right_hits;
    const uint8_t* bases;     // the genome with its margin (caller-owned)
    const uint8_t* qascii;    // the read batch's query buffer (caller-owned)
    int64_t tile, overlap, large_long, large_short;
    bool do_overlap;
    int64_t sub5[25];
    int64_t gap_open, gap_extend, long_gap_open, long_gap_extend;
};

// _large_sizes: (rt, qt) of a large tile toward the side's last hit
static bool large_sizes(const ExtTable& t, const Ext& e, bool left,
                        int64_t* rt, int64_t* qt) {
    int64_t beg = left ? e.lbeg : e.rbeg, end = left ? e.lend : e.rend;
    if (end == beg) return false;
    uint64_t hit = (left ? t.left_hits : t.right_hits)[end - 1];
    int64_t h1 = e.ref_start_addr + e.curr_ref, o1 = e.curr_q;
    int64_t h2 = (int64_t)(hit >> 32), o2 = (int64_t)(hit & 0xFFFFFFFF);
    bool big_ref = left ? (h1 - h2) > (o1 - o2) : (h2 - h1) > (o2 - o1);
    *rt = big_ref ? t.large_long : t.large_short;
    *qt = big_ref ? t.large_short : t.large_long;
    return true;
}

// _Ext.request, q_start in the query buffer; counts large tiles
static bool make_request(const ExtTable& t, const Ext& e, int64_t* r,
                         int64_t* n_large) {
    int64_t rt = t.tile, qt = t.tile;
    bool left = !e.left_done;
    if (e.used_large) {
        if (!large_sizes(t, e, left, &rt, &qt)) return false;
        ++*n_large;
    }
    if (left) {
        r[RQ_R_START] = e.ref_start_addr
                        + (e.curr_ref >= rt ? e.curr_ref - rt + 1 : 0);
        r[RQ_R_SIZE] = std::min(e.curr_ref + 1, rt);
        r[RQ_Q_START] = e.q_code_start
                        + (e.curr_q >= qt ? e.curr_q - qt + 1 : 0);
        r[RQ_Q_SIZE] = std::min(e.curr_q + 1, qt);
    } else {
        r[RQ_R_START] = e.ref_start_addr + e.curr_ref;
        r[RQ_R_SIZE] = std::min(e.ref_len - e.curr_ref, rt);
        r[RQ_Q_START] = e.q_code_start + e.curr_q;
        r[RQ_Q_SIZE] = std::min(e.q_len - e.curr_q, qt);
    }
    r[RQ_REV] = left ? 0 : 1;
    r[RQ_RT] = rt;
    r[RQ_QT] = qt;
    return true;
}

// hit popping: keep hits up to the last one still ahead of the position
// (extender.cpp:336-351 / :472-486)
static void pop_hits(const std::vector<uint64_t>& hits, int64_t beg,
                     int64_t* end, int64_t x, int64_t q, bool left) {
    int64_t i = *end;
    for (; i > beg; i--) {
        int64_t h = (int64_t)(hits[i - 1] >> 32);
        int64_t o = (int64_t)(hits[i - 1] & 0xFFFFFFFF);
        if (left ? (h < x && o < q) : (h > x && o > q)) break;
    }
    *end = i;
}

// _post_decode, left side (extender.cpp:336-394); true when finished
static bool finish_left(const ExtTable& t, Ext& e, int64_t n_ops) {
    pop_hits(t.left_hits, e.lbeg, &e.lend, e.ref_start_addr + e.curr_ref,
             e.curr_q, true);
    bool at_bound = e.ref_start_off == 0 || e.q_start_off == 0;
    bool no_hits = e.lend == e.lbeg;
    // the fw-only empty-hit stop (extender.cpp:353)
    bool outer = n_ops == 0 || at_bound || (!e.rc && no_hits);
    if (!outer) {
        e.used_large = false;
        return false;
    }
    if (!(e.used_large || no_hits || at_bound)) {
        e.used_large = true;
        return false;
    }
    e.left_done = true;
    if (e.ref_start_off > 0) e.ref_start_off = e.curr_ref + 1;
    if (e.q_start_off > 0) e.q_start_off = e.curr_q + 1;
    if (e.curr_ref + 1 < e.ref_len && e.curr_q + 1 < e.q_len
            && !e.right_done) {
        e.curr_ref = e.ref_end_off + 1;
        e.curr_q = e.q_end_off + 1;
        return false;
    }
    // the right side cannot start: the rc path emits (extender.cpp:
    // 886-888), the fw path drops the alignment (:363-382)
    e.right_done = true;
    e.emitted = e.rc;
    return true;
}

// _post_decode, right side (extender.cpp:472-524)
static bool finish_right(const ExtTable& t, Ext& e, int64_t n_ops) {
    pop_hits(t.right_hits, e.rbeg, &e.rend, e.ref_start_addr + e.curr_ref,
             e.curr_q, false);
    bool at_end = e.curr_ref == e.ref_len || e.curr_q == e.q_len;
    if (!(n_ops == 0 || at_end)) {
        e.used_large = false;
        return false;
    }
    if (!(e.used_large || e.rend == e.rbeg || at_end)) {
        e.used_large = true;
        return false;
    }
    e.ref_end_off = e.curr_ref - 1;
    e.q_end_off = e.curr_q - 1;
    e.emitted = true;
    e.right_done = true;
    return true;
}

// one tile: tile_stop, decode_ops into the side's columns, apply_native
// and _post_decode; 0, 1 when the extension finished, or a fault code
static int64_t decode_tile(ExtTable& t, Ext& e, const uint8_t* ops,
                           int64_t n_ops) {
    bool left = !e.left_done;
    // decode-side tile sizes are gated by do_overlap (extender.cpp:261,408)
    int64_t rt = t.tile, qt = t.tile;
    if (e.used_large && !t.do_overlap && !large_sizes(t, e, left, &rt, &qt))
        return EXT_NO_HIT;
    std::vector<uint8_t>& vr = left ? e.left_ref : e.right_ref;
    std::vector<uint8_t>& vq = left ? e.left_q : e.right_q;
    size_t at = vr.size();
    vr.resize(at + n_ops);
    vq.resize(at + n_ops);
    int64_t new_ref, new_q;
    int32_t rb, qb;
    int64_t cols = decode_ops(
        ops, n_ops, std::min(rt, qt) - t.overlap, left ? 0 : 1, t.bases,
        e.ref_start_addr, t.qascii + e.q_code_start, e.curr_ref, e.curr_q,
        e.ref_len, e.q_len, vr.data() + at, vq.data() + at, &new_ref,
        &new_q, &rb, &qb);
    vr.resize(at + cols);
    vq.resize(at + cols);
    e.tiles++;
    if (left) {
        if (rb) e.ref_start_off = 0;
        if (qb) e.q_start_off = 0;
    }
    e.curr_ref = new_ref;
    e.curr_q = new_q;
    e.finished = left ? finish_left(t, e, n_ops) : finish_right(t, e, n_ops);
    if (e.finished && !e.emitted) {     // dropped: its columns are not read
        std::vector<uint8_t>().swap(e.left_ref);
        std::vector<uint8_t>().swap(e.left_q);
        std::vector<uint8_t>().swap(e.right_ref);
        std::vector<uint8_t>().swap(e.right_q);
    }
    return e.finished ? 1 : 0;
}

// fields: (7, n) int64 rows strand_rc, ref_start_addr, ref_len, q_len,
// q_code_start, curr_ref, curr_q.  left_off / right_off: (n + 1) prefix
// offsets into left_hits (each list ascending) / right_hits (descending).
// params: tile_size, tile_overlap, large_tile_long, large_tile_short,
// do_overlap, gap_open, gap_extend, long_gap_open, long_gap_extend; sub5
// the (5, 5) substitution matrix.  bases and qascii stay the caller's and
// must outlive the table.  Returns nullptr when memory runs out.
void* ext_table_new(int64_t n, const int64_t* fields,
                    const uint64_t* left_hits, const int64_t* left_off,
                    const uint64_t* right_hits, const int64_t* right_off,
                    const uint8_t* bases, const uint8_t* qascii,
                    const int64_t* params, const int64_t* sub5) {
    ExtTable* t = nullptr;
    try {
        t = new ExtTable();
        t->ext.resize(n);
        t->left_hits.assign(left_hits, left_hits + left_off[n]);
        t->right_hits.assign(right_hits, right_hits + right_off[n]);
    } catch (const std::bad_alloc&) {
        delete t;
        return nullptr;
    }
    t->bases = bases;
    t->qascii = qascii;
    t->tile = params[0];
    t->overlap = params[1];
    t->large_long = params[2];
    t->large_short = params[3];
    t->do_overlap = params[4] != 0;
    t->gap_open = params[5];
    t->gap_extend = params[6];
    t->long_gap_open = params[7];
    t->long_gap_extend = params[8];
    memcpy(t->sub5, sub5, sizeof(t->sub5));
    for (int64_t i = 0; i < n; i++) {
        Ext& e = t->ext[i];
        e.rc = fields[i] != 0;
        e.ref_start_addr = fields[n + i];
        e.ref_len = fields[2 * n + i];
        e.q_len = fields[3 * n + i];
        e.q_code_start = fields[4 * n + i];
        e.curr_ref = e.ref_start_off = e.ref_end_off = fields[5 * n + i];
        e.curr_q = e.q_start_off = e.q_end_off = fields[6 * n + i];
        e.lbeg = left_off[i];
        e.lend = left_off[i + 1];
        e.rbeg = right_off[i];
        e.rend = right_off[i + 1];
        e.tiles = 0;
        e.left_done = e.right_done = e.used_large = false;
        e.finished = e.emitted = e.has_req = false;
    }
    return t;
}

void ext_table_free(void* h) { delete static_cast<ExtTable*>(h); }

// The next tile's request of each of the n extensions exts[] into out
// (RQ_N, n): a lane refused at a chain level gets the request it was
// refused with, which is then dropped; the others compute theirs.
// Returns the large tiles counted (num_large_tiles), or a fault code.
int64_t ext_requests(void* h, const int64_t* exts, int64_t n,
                     int64_t* out) {
    ExtTable& t = *static_cast<ExtTable*>(h);
    int64_t n_large = 0;
    for (int64_t i = 0; i < n; i++) {
        if (exts[i] < 0 || exts[i] >= (int64_t)t.ext.size())
            return EXT_BAD_INDEX;
        Ext& e = t.ext[exts[i]];
        int64_t r[RQ_N];
        if (e.has_req) {
            memcpy(r, e.req, sizeof(r));
            e.has_req = false;
        } else if (!make_request(t, e, r, &n_large)) {
            return EXT_NO_HIT;
        }
        for (int f = 0; f < RQ_N; f++) out[f * n + i] = r[f];
    }
    return n_large;
}

// Decode one chain level: extension exts[i] takes row i of the (n, L) op
// matrix ops, n_ops[i] ops long.  status[i]: 1 when the extension
// finished, else 0.  With nxt, the (4, B) request rows (r_start, r_size,
// q_start, q_size) the device computed the next level under, each
// extension still going computes its next request and compares it with
// column rows[i] of nxt and rev[rows[i]] (the level's direction), and a
// square tile_size tile: equal in every field, status 2 and a hit; else a
// miss, and the request is kept for ext_requests.  counts += (hits,
// misses, large tiles).  Returns 0 or a fault code.
int64_t ext_decode_level(void* h, const int64_t* exts, int64_t n,
                         const uint8_t* ops, int64_t L,
                         const int32_t* n_ops, const int64_t* nxt,
                         int64_t B, const int64_t* rows, const int64_t* rev,
                         int8_t* status, int64_t* counts) {
    ExtTable& t = *static_cast<ExtTable*>(h);
    for (int64_t i = 0; i < n; i++) {
        if (exts[i] < 0 || exts[i] >= (int64_t)t.ext.size()
                || (nxt && (rows[i] < 0 || rows[i] >= B)))
            return EXT_BAD_INDEX;
        if (n_ops[i] < 0 || n_ops[i] > L) return EXT_BAD_OPS;
        Ext& e = t.ext[exts[i]];
        int64_t done = decode_tile(t, e, ops + i * L, n_ops[i]);
        if (done < 0) return done;
        status[i] = (int8_t)done;
        if (done || !nxt) continue;
        int64_t r[RQ_N];
        if (!make_request(t, e, r, &counts[2])) return EXT_NO_HIT;
        int64_t b = rows[i];
        if (r[RQ_RT] == t.tile && r[RQ_QT] == t.tile && r[RQ_REV] == rev[b]
                && r[RQ_R_START] == nxt[b] && r[RQ_R_SIZE] == nxt[B + b]
                && r[RQ_Q_START] == nxt[2 * B + b]
                && r[RQ_Q_SIZE] == nxt[3 * B + b]) {
            status[i] = 2;
            counts[0]++;
        } else {
            counts[1]++;
            memcpy(e.req, r, sizeof(r));
            e.has_req = true;
        }
    }
    return 0;
}

// Every extension's state into out (EXT_NF, n), rows in this order
// (native.ExtensionTable.STATE): the position, the four offsets, the
// three flags, the tiles, the hits left on each side, finished, emitted
// and the aligned columns held.
enum { EXT_NF = 15 };

void ext_state(void* h, int64_t* out) {
    const ExtTable& t = *static_cast<ExtTable*>(h);
    int64_t n = (int64_t)t.ext.size();
    for (int64_t i = 0; i < n; i++) {
        const Ext& e = t.ext[i];
        const int64_t v[EXT_NF] = {
            e.curr_ref, e.curr_q, e.ref_start_off, e.q_start_off,
            e.ref_end_off, e.q_end_off, e.left_done, e.right_done,
            e.used_large, e.tiles, e.lend - e.lbeg, e.rend - e.rbeg,
            e.finished, e.emitted,
            (int64_t)(e.left_ref.size() + e.right_ref.size())};
        for (int f = 0; f < EXT_NF; f++) out[f * n + i] = v[f];
    }
}

// The aligned rows of extensions exts[] (_emit): extension i's columns go
// to [offsets[i], offsets[i + 1]) of ref_out and q_out, its left side
// reversed then its right side, and scores[i] is their score_alignment.
// offsets come from ext_state's columns row.  Returns 0 or a fault code.
int64_t ext_emit(void* h, const int64_t* exts, int64_t n,
                 const int64_t* offsets, uint8_t* ref_out, uint8_t* q_out,
                 int64_t* scores) {
    const ExtTable& t = *static_cast<ExtTable*>(h);
    for (int64_t i = 0; i < n; i++) {
        if (exts[i] < 0 || exts[i] >= (int64_t)t.ext.size())
            return EXT_BAD_INDEX;
        const Ext& e = t.ext[exts[i]];
        int64_t nl = (int64_t)e.left_ref.size();
        int64_t cols = nl + (int64_t)e.right_ref.size();
        if (offsets[i + 1] - offsets[i] != cols) return EXT_BAD_INDEX;
        uint8_t* r = ref_out + offsets[i];
        uint8_t* q = q_out + offsets[i];
        std::reverse_copy(e.left_ref.begin(), e.left_ref.end(), r);
        std::reverse_copy(e.left_q.begin(), e.left_q.end(), q);
        std::copy(e.right_ref.begin(), e.right_ref.end(), r + nl);
        std::copy(e.right_q.begin(), e.right_q.end(), q + nl);
        scores[i] = score_alignment(r, q, cols, t.sub5, t.gap_open,
                                    t.gap_extend, t.long_gap_open,
                                    t.long_gap_extend);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// sam_cigars - the CIGARs of n SAM records (printer.cpp:219-292;
// darwin_tpu/pipeline/printer.py:27-51).  Record i's aligned strings are
// [ref_off[i], ref_off[i + 1]) of ref and [q_off[i], q_off[i + 1]) of q.
// A column is I when the reference has '-', else D when the query has '-',
// else M; equal adjacent ops make one run, printed as its length and op.
// head[i] / tail[i] are the soft clips, printed as {n}S first / last when
// n > 0; a record with no columns and no clips prints '*'.  Record i's
// CIGAR goes to [out_off[i], out_off[i + 1]) of out, which holds cap bytes:
// 2 a column (a run of n columns prints at most 2n), 21 a clip and 1 a
// record suffice.  Returns the bytes written, SAM_BAD_LENGTH when a
// record's two strings differ in length, SAM_FULL when out is too small.
// ---------------------------------------------------------------------------

enum { SAM_BAD_LENGTH = -1, SAM_FULL = -2 };

// v >= 0 in decimal at p, then op; returns the bytes written
static int64_t put_run(uint8_t* p, int64_t v, uint8_t op) {
    uint8_t digits[20];
    int k = 0;
    do {
        digits[k++] = (uint8_t)('0' + v % 10);
        v /= 10;
    } while (v != 0);
    for (int j = 0; j < k; j++) p[j] = digits[k - 1 - j];
    p[k] = op;
    return k + 1;
}

int64_t sam_cigars(const uint8_t* ref, const uint8_t* q,
                   const int64_t* ref_off, const int64_t* q_off, int64_t n,
                   const int64_t* head, const int64_t* tail, uint8_t* out,
                   int64_t cap, int64_t* out_off) {
    int64_t w = 0;
    out_off[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t cols = ref_off[i + 1] - ref_off[i];
        if (q_off[i + 1] - q_off[i] != cols) return SAM_BAD_LENGTH;
        if (cap - w < 2 * cols + 43) return SAM_FULL;
        const uint8_t* r = ref + ref_off[i];
        const uint8_t* s = q + q_off[i];
        int64_t start = w;
        if (head[i] > 0) w += put_run(out + w, head[i], 'S');
        uint8_t run_op = 0;
        int64_t run = 0;
        for (int64_t c = 0; c < cols; c++) {
            uint8_t op = r[c] == '-' ? 'I' : s[c] == '-' ? 'D' : 'M';
            if (op != run_op && run != 0) {
                w += put_run(out + w, run, run_op);
                run = 0;
            }
            run_op = op;
            run++;
        }
        if (run != 0) w += put_run(out + w, run, run_op);
        if (tail[i] > 0) w += put_run(out + w, tail[i], 'S');
        if (w == start) out[w++] = '*';
        out_off[i + 1] = w;
    }
    return w;
}

}  // extern "C"
