// Native IO tier of dca_tpu_torch: parallel text-matrix parse/format and
// CSR batch densification, on the host.
//
// A copy of the JAX package's dca_tpu/native/io_native.cpp (the port keeps
// its own).  The reference (theislab/dca) does all IO through pandas/scanpy
// on the Python heap (reference dca/io.py:53-129); at the paper's 1.3M-cell
// scale the TSV parse and the %.6f TSV write dominate end-to-end wall time.
// This file provides the hot loops as a plain C ABI shared library consumed
// via ctypes (dca_tpu_torch/native/__init__.py), OpenMP-parallel over rows:
//
//   * dca_index_lines / dca_count_fields / dca_parse_rows — two-pass
//     TSV/CSV reader (row offsets, then parallel strtof per row)
//   * dca_format_rows / dca_write_file — parallel "%.6f" row formatting
//     (byte-identical to pandas DataFrame.to_csv(float_format='%.6f'))
//   * dca_csr_densify / dca_csr_to_padded / dca_csr_to_flat /
//     dca_gather_rows — batch assembly for the streaming pipeline
//
// Everything is pure C ABI (no Python.h) so the library builds with a bare
// `g++ -O3 -fopenmp -shared -fPIC` and loads through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Number of newline-terminated lines in buf (a trailing line without '\n'
// counts; trailing empty lines do not).
int64_t dca_count_lines(const char* buf, int64_t len) {
    while (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) len--;
    if (len == 0) return 0;
    int64_t n = 1;
#pragma omp parallel for reduction(+ : n) schedule(static)
    for (int64_t i = 0; i < len; i++) {
        if (buf[i] == '\n') n++;
    }
    return n;
}

// Fill row_starts[0..cap) with byte offsets of line starts; returns the
// number of lines written (see dca_count_lines for the count).
int64_t dca_index_lines(const char* buf, int64_t len, int64_t* row_starts,
                        int64_t cap) {
    while (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) len--;
    int64_t n = 0;
    if (len == 0) return 0;
    if (n < cap) row_starts[n++] = 0;
    for (int64_t i = 0; i < len; i++) {
        if (buf[i] == '\n' && i + 1 < len) {
            if (n >= cap) return -1;
            row_starts[n++] = i + 1;
        }
    }
    return n;
}

// Number of sep-delimited fields in the line starting at `start`.
int64_t dca_count_fields(const char* buf, int64_t len, int64_t start, char sep) {
    int64_t n = 1;
    for (int64_t i = start; i < len && buf[i] != '\n'; i++) {
        if (buf[i] == sep) n++;
    }
    return n;
}

// Parse n_rows lines (offsets in row_starts) of `cols` numeric fields each
// (after optionally skipping a leading name field) into out (row-major).
// name_off/name_len (optional, size n_rows) receive the byte span of each
// skipped name field.  Returns 0 on success or (1 + row) of the first
// malformed row.
int64_t dca_parse_rows(const char* buf, int64_t len, const int64_t* row_starts,
                       int64_t n_rows, int64_t cols, int skip_first_field,
                       char sep, float* out, int64_t* name_off,
                       int64_t* name_len) {
    int64_t bad = 0;
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_rows; r++) {
        const char* p = buf + row_starts[r];
        const char* end = buf + len;
        if (skip_first_field) {
            const char* q = p;
            while (q < end && *q != sep && *q != '\n' && *q != '\r') q++;
            if (name_off) {
                name_off[r] = p - buf;
                name_len[r] = q - p;
            }
            p = (q < end && *q == sep) ? q + 1 : q;
        }
        float* row = out + r * cols;
        int64_t c = 0;
        while (c < cols) {
            float v;
            // guard BEFORE strtof: it skips leading whitespace (incl. \t/\n)
            // and would otherwise walk across separators or line ends.
            if (p >= end || *p == sep || *p == '\n' || *p == '\r') {
                v = NAN;  // empty field: pandas yields NaN
            } else {
                // fast path: plain (signed) integer token — the common case
                // for raw count matrices
                const char* q = p;
                bool neg = false;
                if (*q == '-') { neg = true; q++; }
                uint64_t acc = 0;
                int nd = 0;
                while (q < end && *q >= '0' && *q <= '9' && nd < 15) {
                    acc = acc * 10 + (uint64_t)(*q - '0');
                    q++; nd++;
                }
                if (nd > 0 && (q >= end || *q == sep || *q == '\n' || *q == '\r')) {
                    v = neg ? -(float)acc : (float)acc;
                    p = q;
                } else {
                    char* next = nullptr;
                    v = strtof(p, &next);
                    if (next == p) {
#pragma omp atomic write
                        bad = r + 1;
                        break;
                    }
                    p = next;
                }
            }
            row[c++] = v;
            while (p < end && *p == '\r') p++;
            if (p < end && *p == sep) {
                p++;
                // ragged row with EXTRA fields: pandas raises ParserError,
                // so the native path must reject it too instead of silently
                // dropping the surplus values
                if (c == cols) {
#pragma omp atomic write
                    bad = r + 1;
                    break;
                }
            } else if (c < cols) {
                if (p >= end || *p == '\n') {
#pragma omp atomic write
                    bad = r + 1;
                    break;
                }
            }
        }
    }
    return bad;
}

// CSR rows -> dense batch.  out is (n_rows, n_cols) f32, fully overwritten.
void dca_csr_densify(const int64_t* indptr, const int32_t* indices,
                     const float* data, const int64_t* rows, int64_t n_rows,
                     int64_t n_cols, float* out) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t r = 0; r < n_rows; r++) {
        float* dst = out + r * n_cols;
        memset(dst, 0, n_cols * sizeof(float));
        int64_t src = rows[r];
        for (int64_t k = indptr[src]; k < indptr[src + 1]; k++) {
            dst[indices[k]] = data[k];
        }
    }
}

// CSR rows -> padded (n_rows, K) index/value payload for ON-DEVICE
// densification (ops/densify.py): each selected row's column ids and values
// are copied into fixed-width slots; index slots beyond the row's nnz carry
// ASCENDING out-of-range ids pad_index + k (pad_index = n_cols) so the
// device scatter's sorted/unique index hints stay true — every padding slot
// is still out of bounds and dropped, but no two slots in a row collide.
// (A constant pad id would violate unique_indices and is UB in XLA scatter.)
void dca_csr_to_padded(const int64_t* indptr, const int32_t* indices,
                       const float* data, const int64_t* rows, int64_t n_rows,
                       int64_t K, int32_t pad_index, int32_t* out_idx,
                       float* out_dat) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t src = rows[r];
        int64_t s = indptr[src];
        int64_t len = indptr[src + 1] - s;
        if (len > K) len = K;
        int32_t* di = out_idx + r * K;
        float* dv = out_dat + r * K;
        memcpy(di, indices + s, len * sizeof(int32_t));
        memcpy(dv, data + s, len * sizeof(float));
        for (int64_t k = len; k < K; k++) di[k] = pad_index + (int32_t)(k - len);
        memset(dv + len, 0, (K - len) * sizeof(float));
    }
}

// CSR rows -> FLAT padded COO payload (row id, column id, value), length L,
// for on-device densification via a flat scatter (ops/densify.py).  Unlike
// the fixed-width padded scheme (dca_csr_to_padded: 8 bytes per SLOT, K =
// max nnz/row), the flat payload costs 12 bytes per NONZERO — the better
// encoding whenever the row-nnz distribution is heavy-tailed (K much larger
// than the mean), which real single-cell depth distributions are.
// Slots past the total nnz carry row id pad_row (>= n_rows, dropped by the
// device scatter's out-of-bounds mode), col 0, value 0.  Returns the total
// nnz of the selected rows; the caller must ensure it fits L (entries past
// L are not written).
int64_t dca_csr_to_flat(const int64_t* indptr, const int32_t* indices,
                        const float* data, const int64_t* rows,
                        int64_t n_rows, int64_t L, int32_t pad_row,
                        int32_t* out_row, int32_t* out_col, float* out_val) {
    // serial prefix of output offsets (n_rows adds; negligible)
    int64_t total = 0;
    std::vector<int64_t> off((size_t)n_rows + 1);
    for (int64_t r = 0; r < n_rows; r++) {
        off[(size_t)r] = total;
        total += indptr[rows[r] + 1] - indptr[rows[r]];
    }
    off[(size_t)n_rows] = total;
    if (total > L) return total;  // caller retries with a bigger bucket
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t s = indptr[rows[r]];
        int64_t len = indptr[rows[r] + 1] - s;
        int64_t o = off[(size_t)r];
        memcpy(out_col + o, indices + s, len * sizeof(int32_t));
        memcpy(out_val + o, data + s, len * sizeof(float));
        for (int64_t k = 0; k < len; k++) out_row[o + k] = (int32_t)r;
    }
#pragma omp parallel for schedule(static)
    for (int64_t k = total; k < L; k++) {
        out_row[k] = pad_row;
        out_col[k] = 0;
        out_val[k] = 0.0f;
    }
    return total;
}

// Gather dense f32 rows (fancy indexing) — the dense-matrix counterpart of
// dca_csr_densify for the streaming loader.
void dca_gather_rows(const float* src, const int64_t* rows, int64_t n_rows,
                     int64_t n_cols, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        memcpy(out + r * n_cols, src + rows[r] * n_cols, n_cols * sizeof(float));
    }
}

// Format one value as pandas to_csv(float_format='%.6f') does: NaN -> empty
// field, otherwise C printf %.6f.  Returns bytes written.
//
// Fast path: fixed-point integer emission of round(|v|*1e6).  The double
// multiply carries <=2 ulp of error, so whenever the fractional part of
// |v|*1e6 is not within a wide guard band of 0.5 the correctly-rounded 6th
// decimal digit is unambiguous and the fast path is byte-identical to
// printf; near-ties and huge/non-finite values take the snprintf path.
static inline int format_value(double v, char* dst) {
    if (std::isnan(v)) return 0;
    if (!std::isfinite(v)) return snprintf(dst, 64, "%.6f", v);
    double a = std::fabs(v);
    double r = a * 1e6;
    if (r >= 9e15) return snprintf(dst, 64, "%.6f", v);  // fits: f32 max -> 47 chars
    double fr = r - std::floor(r);
    if (fr > 0.4995 && fr < 0.5005) return snprintf(dst, 64, "%.6f", v);
    uint64_t n = (uint64_t)(r + 0.5);
    uint64_t ip = n / 1000000, fp = n % 1000000;
    char* q = dst;
    if (std::signbit(v)) *q++ = '-';
    char tmp[24];
    int ti = 0;
    do {
        tmp[ti++] = '0' + (char)(ip % 10);
        ip /= 10;
    } while (ip);
    while (ti) *q++ = tmp[--ti];
    *q++ = '.';
    q[5] = '0' + (char)(fp % 10); fp /= 10;
    q[4] = '0' + (char)(fp % 10); fp /= 10;
    q[3] = '0' + (char)(fp % 10); fp /= 10;
    q[2] = '0' + (char)(fp % 10); fp /= 10;
    q[1] = '0' + (char)(fp % 10); fp /= 10;
    q[0] = '0' + (char)(fp % 10);
    return (int)(q + 6 - dst);
}

// Format one row into q; returns bytes written.
static inline int64_t format_row(const float* row, int64_t n_cols,
                                 const char* names_blob, const int64_t* name_off,
                                 const int64_t* name_len, int64_t r, char sep,
                                 char* q) {
    char* p = q;
    if (name_len) {
        memcpy(q, names_blob + name_off[r], name_len[r]);
        q += name_len[r];
        *q++ = sep;
    }
    for (int64_t c = 0; c < n_cols; c++) {
        if (c) *q++ = sep;
        q += format_value((double)row[c], q);
    }
    *q++ = '\n';
    return q - p;
}

// Format rows [0, n_rows) of a (n_rows, n_cols) f32 matrix as sep-separated
// text.  Optional row names come as byte spans into names_blob.  Two-phase:
// parallel format into a strided scratch, prefix-sum, parallel compaction.
// Returns total bytes written to out, or -1 if cap is too small.
int64_t dca_format_rows(const float* data, int64_t n_rows, int64_t n_cols,
                        const char* names_blob, const int64_t* name_off,
                        const int64_t* name_len, char sep, char* out,
                        int64_t cap) {
    int64_t max_name = 0;
    if (name_len) {
        for (int64_t r = 0; r < n_rows; r++)
            if (name_len[r] > max_name) max_name = name_len[r];
    }
    // worst case per value: sign + 47 %.6f chars + sep
    const int64_t stride = n_cols * 49 + max_name + 2;
    char* scratch = (char*)malloc((size_t)n_rows * stride);
    int64_t* lens = (int64_t*)malloc(n_rows * sizeof(int64_t));
    if (!scratch || !lens) {
        free(scratch);
        free(lens);
        return -1;
    }

#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_rows; r++) {
        lens[r] = format_row(data + r * n_cols, n_cols, names_blob, name_off,
                             name_len, r, sep, scratch + r * stride);
    }

    int64_t total = 0;
    for (int64_t r = 0; r < n_rows; r++) total += lens[r];
    if (total > cap) {
        free(scratch);
        free(lens);
        return -1;
    }
    // exclusive prefix sum for parallel compaction
    int64_t* offs = (int64_t*)malloc(n_rows * sizeof(int64_t));
    if (!offs) {
        free(scratch);
        free(lens);
        return -1;
    }
    int64_t acc = 0;
    for (int64_t r = 0; r < n_rows; r++) {
        offs[r] = acc;
        acc += lens[r];
    }
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        memcpy(out + offs[r], scratch + r * stride, lens[r]);
    }
    free(offs);
    free(scratch);
    free(lens);
    return total;
}

// Format + write the whole matrix straight to `path` (header bytes first),
// in bounded row blocks: parallel format of a block, then sequential fwrite.
// Avoids materializing the multi-GB text in memory.  Returns total bytes
// written or -1 on error.
int64_t dca_write_file(const char* path, const char* header,
                       int64_t header_len, const float* data, int64_t n_rows,
                       int64_t n_cols, const char* names_blob,
                       const int64_t* name_off, const int64_t* name_len,
                       char sep) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int64_t total = 0;
    if (header_len > 0) {
        if ((int64_t)fwrite(header, 1, header_len, f) != header_len) {
            fclose(f);
            return -1;
        }
        total += header_len;
    }
    int64_t max_name = 0;
    if (name_len) {
        for (int64_t r = 0; r < n_rows; r++)
            if (name_len[r] > max_name) max_name = name_len[r];
    }
    const int64_t stride = n_cols * 49 + max_name + 2;
    const int64_t BLOCK =
        (64LL << 20) / (stride > 0 ? stride : 1) + 1;  // ~64MB scratch
    char* scratch = (char*)malloc((size_t)BLOCK * stride);
    int64_t* lens = (int64_t*)malloc(BLOCK * sizeof(int64_t));
    if (!scratch || !lens) {
        free(scratch);
        free(lens);
        fclose(f);
        return -1;
    }
    for (int64_t r0 = 0; r0 < n_rows; r0 += BLOCK) {
        int64_t nb = (r0 + BLOCK < n_rows) ? BLOCK : n_rows - r0;
#pragma omp parallel for schedule(dynamic, 64)
        for (int64_t i = 0; i < nb; i++) {
            int64_t r = r0 + i;
            lens[i] = format_row(data + r * n_cols, n_cols, names_blob,
                                 name_off, name_len, r, sep,
                                 scratch + i * stride);
        }
        for (int64_t i = 0; i < nb; i++) {
            if ((int64_t)fwrite(scratch + i * stride, 1, lens[i], f) != lens[i]) {
                free(scratch);
                free(lens);
                fclose(f);
                return -1;
            }
            total += lens[i];
        }
    }
    free(scratch);
    free(lens);
    if (fclose(f) != 0) return -1;
    return total;
}

int dca_native_version() { return 1; }

// Cap the OpenMP thread pool used by every hot loop in this tier — the
// behavioral hook behind the CLI/API `threads` option (the reference caps
// TF's intra/inter-op pools the same way, reference dca/train.py:41-48).
void dca_native_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

int dca_native_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
