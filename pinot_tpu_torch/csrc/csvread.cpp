// Native CSV ingest: parse a delimiter-separated body straight into
// columnar arrays, one pass, no per-row Python objects.
//
// The reference reads ingest files row-at-a-time through Java record
// readers (pinot-core data/readers/CSVRecordReader.java) feeding the
// two-pass segment builder. Here the hot path is columnar from the
// start: numeric cells are parsed to int64/double in place, string
// cells are recorded as (offset,length) slices into the file buffer
// and materialized lazily by the Python side.
//
// Scope: the fast path handles unquoted CSV only (no '"' anywhere in
// the buffer — the caller checks and falls back to Python's csv module
// otherwise), LF or CRLF line endings, missing trailing cells filled
// with per-column defaults, blank lines skipped.
//
// Build: g++ -O3 -fPIC -shared -std=c++17, at first use, by
// pinot_tpu_torch/segment/native.py into build/.
#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

// Parse one numeric cell [s, e). Empty -> default. Integer columns fall
// back to double-then-truncate (the int(float(x)) coercion the Python
// DataType.convert applies). Returns false on unparseable garbage.
bool parse_i64(const char* s, const char* e, int64_t def, int64_t* out) {
    if (s == e) { *out = def; return true; }  // truly empty -> default
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    while (e > s && (e[-1] == ' ' || e[-1] == '\t')) --e;
    if (s == e) return false;  // whitespace-only: python raises, so fall back
    auto r = std::from_chars(s, e, *out);
    if (r.ec == std::errc() && r.ptr == e) return true;
    double d;
    auto rd = std::from_chars(s, e, d);
    if (rd.ec == std::errc() && rd.ptr == e && d == d &&
        d >= -9.2e18 && d <= 9.2e18) {
        *out = static_cast<int64_t>(d);
        return true;
    }
    return false;  // NaN / out-of-range -> caller falls back (loud python error)
}

bool parse_f64(const char* s, const char* e, double def, double* out) {
    if (s == e) { *out = def; return true; }  // truly empty -> default
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    while (e > s && (e[-1] == ' ' || e[-1] == '\t')) --e;
    if (s == e) return false;  // whitespace-only: python raises, so fall back
    auto r = std::from_chars(s, e, *out);
    return r.ec == std::errc() && r.ptr == e;
}

}  // namespace

extern "C" {

// types[c]: 0 = int64, 1 = double, 2 = raw slice (strings / MV cells),
// 3 = skip (tokenized but nothing recorded — non-schema columns).
// Parsing starts at buf[start] (the caller points this past the header
// line so the file buffer is never copied). Recorded slice offsets are
// absolute into buf. i64_outs[c] / f64_outs[c]: preallocated [max_rows]
// when types[c] selects them, else may be null. str_offs[c]:
// preallocated [2*max_rows] (offset,length pairs) when types[c]==2.
// Returns rows parsed; -1 = row wider than ncols; -2 = bad numeric cell.
int64_t pinot_csv_parse(const char* buf, int64_t len, int64_t start,
                        char delim, int ncols,
                        const int8_t* types, const int64_t* i64_def,
                        const double* f64_def, int64_t max_rows,
                        int64_t* const* i64_outs, double* const* f64_outs,
                        int64_t* const* str_offs) {
    int64_t row = 0;
    int64_t pos = start;
    while (pos < len && row < max_rows) {
        // locate end of line
        const char* nl = static_cast<const char*>(
            memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
        int64_t line_end = nl ? (nl - buf) : len;
        int64_t next = nl ? line_end + 1 : len;
        if (line_end > pos && buf[line_end - 1] == '\r') --line_end;  // CRLF
        if (line_end == pos) { pos = next; continue; }  // blank line

        int col = 0;
        int64_t cell_start = pos;
        for (int64_t i = pos; i <= line_end; ++i) {
            if (i < line_end && buf[i] != delim) continue;
            if (col >= ncols) return -1;
            const char* cs = buf + cell_start;
            const char* ce = buf + i;
            switch (types[col]) {
                case 0:
                    if (!parse_i64(cs, ce, i64_def[col], &i64_outs[col][row]))
                        return -2;
                    break;
                case 1:
                    if (!parse_f64(cs, ce, f64_def[col], &f64_outs[col][row]))
                        return -2;
                    break;
                case 2:
                    str_offs[col][2 * row] = cell_start;
                    str_offs[col][2 * row + 1] = i - cell_start;
                    break;
                default:  // 3: skip
                    break;
            }
            ++col;
            cell_start = i + 1;
        }
        // missing trailing cells -> defaults / empty slices
        for (; col < ncols; ++col) {
            switch (types[col]) {
                case 0: i64_outs[col][row] = i64_def[col]; break;
                case 1: f64_outs[col][row] = f64_def[col]; break;
                case 2:
                    str_offs[col][2 * row] = line_end;
                    str_offs[col][2 * row + 1] = 0;
                    break;
                default:
                    break;
            }
        }
        ++row;
        pos = next;
    }
    return row;
}

}  // extern "C"
