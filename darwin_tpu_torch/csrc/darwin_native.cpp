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

#include <algorithm>
#include <cstdint>
#include <cstring>
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

int64_t decode_ops(const uint8_t* ops, int64_t n_ops, int64_t stop_thr,
                   int32_t direction,
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
// decode_ops_batch - one call applies a whole dispatch round's tracebacks.
// sel[i] picks row b of the (B, L) op matrix; outputs are compact (nsel, L).
// Per-tile semantics identical to decode_ops above.
// ---------------------------------------------------------------------------

void decode_ops_batch(const uint8_t* ops, int64_t L,
                      const int64_t* sel, int64_t nsel,
                      const int64_t* n_ops, const int64_t* stop_thr,
                      const int32_t* direction,
                      const uint8_t* bases, const int64_t* ref_start_addr,
                      const uint8_t* qconcat, const int64_t* q_off,
                      const int64_t* curr_ref_in, const int64_t* curr_q_in,
                      const int64_t* ref_len, const int64_t* q_len,
                      uint8_t* out_ref, uint8_t* out_q,
                      int64_t* cols_out,
                      int64_t* curr_ref_out, int64_t* curr_q_out,
                      int32_t* rb_out, int32_t* qb_out) {
    for (int64_t i = 0; i < nsel; i++) {
        int64_t b = sel[i];
        cols_out[i] = decode_ops(
            ops + b * L, n_ops[i], stop_thr[i], direction[i],
            bases, ref_start_addr[i], qconcat + q_off[i],
            curr_ref_in[i], curr_q_in[i], ref_len[i], q_len[i],
            out_ref + i * L, out_q + i * L,
            curr_ref_out + i, curr_q_out + i, rb_out + i, qb_out + i);
    }
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

}  // extern "C"
