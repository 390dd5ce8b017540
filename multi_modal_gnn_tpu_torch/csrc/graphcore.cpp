// graphcore — the host-side graph-assembly core of multi_modal_gnn_tpu_torch.
//
// The ETL that feeds the card (entity-ID factorization, edge sorting, the
// window and span plans, the LABEVENTS scan) runs on the host.  This core
// replaces the numpy plan builders' O(E log E) comparison sorts with
// O(E + N) counting sorts plus an open-addressing factorizer, and the
// Python CSV scan with one pass in C++.  Every entry point gives the same
// arrays, bit for bit, as its plain numpy version in ``native.py``.
//
// A plain C ABI bound by ctypes (``multi_modal_gnn_tpu_torch/native.py``),
// built with g++ and linked with zlib (``-lz``) at first use by
// ``ops/_build.py build_graphcore`` into ``multi_modal_gnn_tpu_torch/_build/``.
// The scan reads plain and gzip files alike through zlib's ``gzopen``.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Counting sort of edges by destination (stable).  dst values in [0, num_dst).
// Emits the permutation so callers can reorder any number of parallel arrays.
// Also emits per-destination counts and CSR row pointers in the same pass.
// ---------------------------------------------------------------------------
int sort_edges_by_dst(
    const int32_t* dst,     // [e]
    int64_t e,
    int32_t num_dst,
    int32_t* perm_out,      // [e]    stable permutation: sorted[i] = orig[perm[i]]
    int32_t* counts_out,    // [num_dst]
    int32_t* row_ptr_out    // [num_dst + 1]
) {
    if (e < 0 || num_dst < 0) return -1;
    std::vector<int64_t> offsets(static_cast<size_t>(num_dst) + 1, 0);
    for (int64_t i = 0; i < e; ++i) {
        int32_t d = dst[i];
        if (d < 0 || d >= num_dst) return -2;
        offsets[static_cast<size_t>(d) + 1]++;
    }
    for (int32_t d = 0; d < num_dst; ++d) {
        counts_out[d] = static_cast<int32_t>(offsets[static_cast<size_t>(d) + 1]);
        offsets[static_cast<size_t>(d) + 1] += offsets[d];
    }
    row_ptr_out[0] = 0;
    for (int32_t d = 0; d < num_dst; ++d)
        row_ptr_out[d + 1] = static_cast<int32_t>(offsets[static_cast<size_t>(d) + 1]);
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
        perm_out[cursor[dst[i]]++] = static_cast<int32_t>(i);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Factorize int64 entity IDs into dense first-seen-order codes.
// Open-addressing hash table (linear probing, power-of-two capacity).
// Returns the number of unique IDs, or a negative error.
// ---------------------------------------------------------------------------
static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

int64_t factorize_i64(
    const int64_t* ids,   // [n]
    int64_t n,
    int32_t* codes_out,   // [n]   dense code per row (first-seen order)
    int64_t* uniques_out, // [n]   unique IDs in first-seen order (<= n used)
    int64_t max_uniques
) {
    if (n <= 0) return 0;
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    const int64_t EMPTY = INT64_MIN;
    std::vector<int64_t> keys(cap, EMPTY);
    std::vector<int32_t> vals(cap, -1);
    int64_t next_code = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t id = ids[i];
        uint64_t slot = mix64(static_cast<uint64_t>(id)) & (cap - 1);
        while (true) {
            if (keys[slot] == EMPTY) {
                if (next_code >= max_uniques) return -1;
                keys[slot] = id;
                vals[slot] = static_cast<int32_t>(next_code);
                uniques_out[next_code] = id;
                ++next_code;
                break;
            }
            if (keys[slot] == id) break;
            slot = (slot + 1) & (cap - 1);
        }
        codes_out[i] = vals[slot];
    }
    return next_code;
}

// ---------------------------------------------------------------------------
// Windowed layout for the Pallas segment kernel (graph/hetero.py contract):
// given DST-SORTED edges, lay windows of `window` destination rows out so
// every window owns a whole number of `tile_e`-edge tiles (>= 1), padding
// slots carrying win_local == window.
//
// Call window_plan_sizes first to get the output length, then window_plan.
// ---------------------------------------------------------------------------
int64_t window_plan_sizes(
    const int32_t* row_ptr,  // [num_dst + 1]
    int32_t num_dst,
    int32_t window,
    int32_t tile_e
) {
    int32_t num_windows = num_dst > 0 ? (num_dst + window - 1) / window : 1;
    int64_t total = 0;
    for (int32_t w = 0; w < num_windows; ++w) {
        int32_t lo_dst = w * window;
        int32_t hi_dst = (w + 1) * window; if (hi_dst > num_dst) hi_dst = num_dst;
        int64_t n = row_ptr[hi_dst] - row_ptr[lo_dst];
        int64_t padded = ((n + tile_e - 1) / tile_e) * tile_e;
        if (padded < tile_e) padded = tile_e;
        total += padded;
    }
    return total;
}

int window_plan(
    const int32_t* src_sorted,  // [e] dst-sorted source indices
    const int32_t* dst_sorted,  // [e]
    const int32_t* row_ptr,     // [num_dst + 1]
    int64_t e,
    int32_t num_dst,
    int32_t window,
    int32_t tile_e,
    int32_t* win_src_out,       // [window_plan_sizes(...)]
    int32_t* win_local_out,     // [window_plan_sizes(...)]
    int32_t* tile_map_out       // [window_plan_sizes(...) / tile_e]
) {
    (void)e;
    int32_t num_windows = num_dst > 0 ? (num_dst + window - 1) / window : 1;
    int64_t out = 0, tile = 0;
    for (int32_t w = 0; w < num_windows; ++w) {
        int32_t lo_dst = w * window;
        int32_t hi_dst = (w + 1) * window; if (hi_dst > num_dst) hi_dst = num_dst;
        int64_t lo = row_ptr[lo_dst], hi = row_ptr[hi_dst];
        int64_t n = hi - lo;
        int64_t padded = ((n + tile_e - 1) / tile_e) * tile_e;
        if (padded < tile_e) padded = tile_e;
        for (int64_t i = 0; i < n; ++i) {
            win_src_out[out + i] = src_sorted[lo + i];
            win_local_out[out + i] = dst_sorted[lo + i] - lo_dst;
        }
        for (int64_t i = n; i < padded; ++i) {
            win_src_out[out + i] = 0;
            win_local_out[out + i] = window;  // kernel-ignored padding marker
        }
        for (int64_t t = 0; t < padded / tile_e; ++t) tile_map_out[tile++] = w;
        out += padded;
    }
    return static_cast<int>(tile);
}

// ---------------------------------------------------------------------------
// Span-bounded tile packer (graph/hetero.py regroup_slots_by_lab_span
// contract, bit-identical to the numpy implementation — the plans are
// derived at load time, so both code paths must agree exactly).
//
// Re-lays a windowed slot layout so every `tile_e`-slot tile's REAL slots
// address table rows inside ONE `block_rows`-row span starting at an
// `align`-aligned base.  Within each window, real slots sort by (row id,
// original slot) — two stable counting-sort passes — then tiles pack
// greedily: a tile closes when full or when the next row falls outside
// [base, base + block_rows).  Windows that end up with no real slots get
// one all-padding tile so the window sequence stays monotone for the
// kernels' first-tile-of-window zeroing.
//
// Call span_plan_sizes first for the output slot count, then span_plan.
// ---------------------------------------------------------------------------

}  // extern "C" — the packer helpers below need C++ linkage (templates)

namespace {

struct SpanSortResult {
    std::vector<int64_t> order;   // real slots, sorted by (window, row, slot)
    std::vector<int64_t> w_start; // per window 0..max_w: run start in `order`
    std::vector<int64_t> w_end;
    int32_t max_w = -1;
};

static int span_sort(
    const int32_t* win_local, const int32_t* win_tile_map,
    const int32_t* row_idx, int64_t e_win, int32_t num_rows,
    int32_t window, int32_t tile_e, SpanSortResult& out
) {
    if (e_win % tile_e) return -1;
    const int64_t ntiles = e_win / tile_e;
    out.max_w = -1;
    for (int64_t t = 0; t < ntiles; ++t)
        if (win_tile_map[t] > out.max_w) out.max_w = win_tile_map[t];

    std::vector<int64_t> real;
    real.reserve(e_win);
    for (int64_t i = 0; i < e_win; ++i) {
        if (win_local[i] < window) {
            if (row_idx[i] < 0 || row_idx[i] >= num_rows) return -2;
            real.push_back(i);
        }
    }
    const int64_t n = static_cast<int64_t>(real.size());

    // stable counting sort by row id
    std::vector<int64_t> cnt(static_cast<size_t>(num_rows) + 1, 0);
    for (int64_t k = 0; k < n; ++k) cnt[row_idx[real[k]] + 1]++;
    for (int32_t r = 0; r < num_rows; ++r) cnt[r + 1] += cnt[r];
    std::vector<int64_t> by_row(n);
    {
        std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
        for (int64_t k = 0; k < n; ++k) by_row[cur[row_idx[real[k]]]++] = real[k];
    }
    // stable counting sort by window (slot's window = tile_map[slot / tile_e])
    std::vector<int64_t> wcnt(static_cast<size_t>(out.max_w) + 2, 0);
    for (int64_t k = 0; k < n; ++k) wcnt[win_tile_map[by_row[k] / tile_e] + 1]++;
    for (int32_t w = 0; w <= out.max_w; ++w) wcnt[w + 1] += wcnt[w];
    out.w_start.assign(wcnt.begin(), wcnt.end() - 1);
    out.w_end.assign(wcnt.begin() + 1, wcnt.end());
    out.order.resize(n);
    {
        std::vector<int64_t> cur(wcnt.begin(), wcnt.end() - 1);
        for (int64_t k = 0; k < n; ++k)
            out.order[cur[win_tile_map[by_row[k] / tile_e]]++] = by_row[k];
    }
    return 0;
}

// greedy packing of one window run; emits per-tile (base, slot count)
template <typename EmitTile>
static void span_pack_window(
    const int32_t* row_idx, const std::vector<int64_t>& order,
    int64_t s, int64_t e, int32_t block_rows, int32_t align,
    int32_t max_base, int32_t tile_e, EmitTile emit
) {
    int64_t i = s;
    while (i < e) {
        int32_t base = (row_idx[order[i]] / align) * align;
        if (base > max_base) base = max_base;
        const int32_t limit_row = base + block_rows;
        int64_t j = i;
        while (j < e && j < i + tile_e && row_idx[order[j]] < limit_row) ++j;
        emit(base, i, j);
        i = j;
    }
}

static int32_t span_labs_pad(int32_t num_rows, int32_t block_rows) {
    int32_t base = num_rows > 1 ? num_rows : 1;
    int32_t pad = ((base + 127) / 128) * 128;
    return pad < block_rows ? block_rows : pad;
}

}  // namespace

extern "C" {

int64_t span_plan_sizes(
    const int32_t* win_local,    // [e_win]
    const int32_t* win_tile_map, // [e_win / tile_e]
    const int32_t* row_idx,      // [e_win] table row per slot (lab or src id)
    int64_t e_win,
    int32_t num_rows,
    int32_t block_rows,
    int32_t window,
    int32_t tile_e,
    int32_t align
) {
    if (block_rows % align) return -3;
    SpanSortResult sr;
    int rc = span_sort(win_local, win_tile_map, row_idx, e_win, num_rows,
                       window, tile_e, sr);
    if (rc) return rc;
    const int32_t max_base = span_labs_pad(num_rows, block_rows) - block_rows;
    int64_t tiles = 0;
    for (int32_t w = 0; w <= sr.max_w; ++w) {
        int64_t before = tiles;
        span_pack_window(row_idx, sr.order, sr.w_start[w], sr.w_end[w],
                         block_rows, align, max_base, tile_e,
                         [&](int32_t, int64_t, int64_t) { ++tiles; });
        if (tiles == before) ++tiles;  // empty window: one all-padding tile
    }
    return tiles * tile_e;
}

int span_plan(
    const int32_t* win_local,
    const int32_t* win_tile_map,
    const int32_t* row_idx,
    int64_t e_win,
    int32_t num_rows,
    int32_t block_rows,
    int32_t window,
    int32_t tile_e,
    int32_t align,
    int64_t e_span,              // from span_plan_sizes
    int64_t* slot_moves_out,     // [e_win] new slot per real old slot, -1 pad
    int32_t* local2_out,         // [e_span]
    int32_t* tile_map2_out,      // [e_span / tile_e] window of each tile
    int32_t* base_out            // [e_span / tile_e] table row base of tile
) {
    if (block_rows % align) return -3;
    SpanSortResult sr;
    int rc = span_sort(win_local, win_tile_map, row_idx, e_win, num_rows,
                       window, tile_e, sr);
    if (rc) return rc;
    const int32_t max_base = span_labs_pad(num_rows, block_rows) - block_rows;

    for (int64_t i = 0; i < e_win; ++i) slot_moves_out[i] = -1;
    for (int64_t i = 0; i < e_span; ++i) local2_out[i] = window;  // padding

    int64_t tile = 0;
    const int64_t ntiles2 = e_span / tile_e;
    for (int32_t w = 0; w <= sr.max_w; ++w) {
        int64_t before = tile;
        span_pack_window(
            row_idx, sr.order, sr.w_start[w], sr.w_end[w],
            block_rows, align, max_base, tile_e,
            [&](int32_t base, int64_t i, int64_t j) {
                if (tile >= ntiles2) return;  // size mismatch guard
                base_out[tile] = base;
                tile_map2_out[tile] = w;
                const int64_t out0 = tile * tile_e;
                for (int64_t k = i; k < j; ++k) {
                    const int64_t old_slot = sr.order[k];
                    const int64_t new_slot = out0 + (k - i);
                    slot_moves_out[old_slot] = new_slot;
                    local2_out[new_slot] = win_local[old_slot];
                }
                ++tile;
            });
        if (tile == before) {  // empty window: one all-padding tile
            if (tile >= ntiles2) return -4;
            base_out[tile] = 0;
            tile_map2_out[tile] = w;
            ++tile;
        }
    }
    return tile == ntiles2 ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Streaming LABEVENTS CSV scanner (plain or gzip via zlib; gzopen reads both
// transparently).  One pass over a 27M-row table extracting only the columns
// the preprocessing pipeline consumes — SUBJECT_ID, ITEMID, VALUENUM,
// CHARTTIME — filtered to a cohort id set and to numeric VALUENUM, replacing
// the pandas chunk loop (reference behavior: src/io_mimic.py:205-250).
// Quote-aware field splitting; CHARTTIME parsed as epoch seconds (-1 = NaT).
// ---------------------------------------------------------------------------

struct LabScan {
    std::vector<int32_t> subj, item;
    std::vector<double> val;
    std::vector<int64_t> time;
};

static inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

static inline int64_t parse_charttime(const char* s, int64_t len) {
    // fixed "YYYY-MM-DD HH:MM:SS" (MIMIC export format); anything else -> -1
    if (len < 19) return -1;
    int y, mo, d, h, mi, se;
    if (std::sscanf(s, "%4d-%2d-%2d %2d:%2d:%2d", &y, &mo, &d, &h, &mi, &se) != 6)
        return -1;
    return days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + se;
}

static inline bool id_member(const int64_t* ids, int64_t n, int64_t x) {
    if (n == 0) return true;  // empty set = keep all
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (ids[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo < n && ids[lo] == x;
}

void* labevents_scan(
    const char* path,
    int col_subj, int col_item, int col_val, int col_time,  // 0-based; time < 0 ok
    const int64_t* ids_sorted, int64_t n_ids,
    int64_t* n_out
) {
    gzFile f = gzopen(path, "rb");
    if (!f) { *n_out = -1; return nullptr; }
    auto* out = new LabScan();
    std::string line;
    char buf[1 << 16];
    int maxcol = col_subj;
    if (col_item > maxcol) maxcol = col_item;
    if (col_val > maxcol) maxcol = col_val;
    if (col_time > maxcol) maxcol = col_time;
    bool first = true;
    const char* starts[256];
    int64_t lens[256];
    while (gzgets(f, buf, sizeof(buf)) != nullptr) {
        line += buf;
        if (line.empty() || line.back() != '\n') {
            if (!gzeof(f)) continue;  // long line: keep accumulating
        }
        if (first) { first = false; line.clear(); continue; }  // header
        // quote-aware split into fields 0..maxcol
        int col = 0;
        bool inq = false;
        const char* p = line.c_str();
        const char* field = p;
        starts[0] = p;
        for (;; ++p) {
            char c = *p;
            if (c == '"') { inq = !inq; continue; }
            if ((c == ',' && !inq) || c == '\n' || c == '\r' || c == '\0') {
                if (col <= maxcol && col < 256) lens[col] = p - field;
                ++col;
                if (c != ',' || col > maxcol + 1) break;
                field = p + 1;
                if (col < 256) starts[col] = field;
            }
        }
        if (col > maxcol) {
            char tmp[64];
            // field contents may be quoted ("5.0"): the split above tracks
            // quote state but keeps the quote chars in the span — strip them
            auto fieldspan = [&](int c, const char*& s, int64_t& l) {
                s = starts[c];
                l = lens[c];
                if (l >= 2 && s[0] == '"' && s[l - 1] == '"') { ++s; l -= 2; }
            };
            const char* fs; int64_t fl;
            // SUBJECT_ID
            fieldspan(col_subj, fs, fl);
            int64_t sl = fl < 63 ? fl : 63;
            std::memcpy(tmp, fs, sl); tmp[sl] = 0;
            char* end;
            long long sid = std::strtoll(tmp, &end, 10);
            if (end != tmp && id_member(ids_sorted, n_ids, sid)) {
                // VALUENUM: must parse fully as a number (notna filter)
                fieldspan(col_val, fs, fl);
                int64_t vl = fl < 63 ? fl : 63;
                std::memcpy(tmp, fs, vl); tmp[vl] = 0;
                double v = std::strtod(tmp, &end);
                if (vl > 0 && end == tmp + vl) {
                    fieldspan(col_item, fs, fl);
                    int64_t il = fl < 63 ? fl : 63;
                    std::memcpy(tmp, fs, il); tmp[il] = 0;
                    long long iid = std::strtoll(tmp, &end, 10);
                    if (end != tmp) {
                        out->subj.push_back(static_cast<int32_t>(sid));
                        out->item.push_back(static_cast<int32_t>(iid));
                        out->val.push_back(v);
                        int64_t ts = -1;
                        if (col_time >= 0) {
                            fieldspan(col_time, fs, fl);
                            ts = parse_charttime(fs, fl);
                        }
                        out->time.push_back(ts);
                    }
                }
            }
        }
        line.clear();
    }
    gzclose(f);
    *n_out = static_cast<int64_t>(out->subj.size());
    return out;
}

void labevents_fetch(
    void* handle, int32_t* subj, int32_t* item, double* val, int64_t* time_out
) {
    auto* s = static_cast<LabScan*>(handle);
    std::memcpy(subj, s->subj.data(), s->subj.size() * sizeof(int32_t));
    std::memcpy(item, s->item.data(), s->item.size() * sizeof(int32_t));
    std::memcpy(val, s->val.data(), s->val.size() * sizeof(double));
    std::memcpy(time_out, s->time.data(), s->time.size() * sizeof(int64_t));
}

void labevents_free(void* handle) { delete static_cast<LabScan*>(handle); }

}  // extern "C"
