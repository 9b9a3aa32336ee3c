// Native host loops of the mural_tpu_torch data and output paths
// (counterpart of mural_tpu/native/encoder.cpp).
//
// The data layer keeps genomes as uint8 codes and encodes them with
// vectorised numpy (genome/encode.py, the plain versions the tests hold
// these loops against); at genome scale numpy's temporaries (the index
// matrix of a window gather, eight passes of a track mean) and Python's
// per-cell %-formatting set the pace, so these four run as tight loops.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC encoder.cpp -o libmural_encoder.so
// (done at first use by mural_tpu_torch/native/__init__.py); every entry
// point is extern "C" with raw pointers and explicit sizes.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Gather fixed-width windows from a chromosome code array.
//   starts:   forward-strand window starts (may be out of range)
//   neg:      per-row flag; rows are reverse-complemented via comp_lut
//   n_code:   fill value for out-of-range positions (the 'N' class)
void mural_gather_windows(const uint8_t* codes, int64_t n_codes,
                          const int64_t* starts, int64_t n_sites,
                          int64_t width, const uint8_t* neg,
                          const uint8_t* comp_lut, uint8_t n_code,
                          uint8_t* out) {
    for (int64_t i = 0; i < n_sites; ++i) {
        uint8_t* row = out + i * width;
        const int64_t s = starts[i];
        const int64_t lo = s < 0 ? 0 : s;
        const int64_t hi = (s + width) > n_codes ? n_codes : s + width;
        if (lo >= hi) {
            std::memset(row, n_code, width);
        } else {
            const int64_t pre = lo - s;
            const int64_t body = hi - lo;
            if (pre) std::memset(row, n_code, pre);
            std::memcpy(row + pre, codes + lo, body);
            const int64_t post = width - pre - body;
            if (post) std::memset(row + pre + body, n_code, post);
        }
        if (neg[i]) {
            // reverse-complement in place
            int64_t a = 0, b = width - 1;
            while (a < b) {
                const uint8_t tmp = comp_lut[row[a]];
                row[a] = comp_lut[row[b]];
                row[b] = tmp;
                ++a; --b;
            }
            if (a == b) row[a] = comp_lut[row[a]];
        }
    }
}

// Pack overlapping k-mers of code windows into radix-4 ids.  digit_lut
// maps code -> 0..3 or -1 (ambiguous); a k-mer holding an ambiguous base
// gets pad_id (= 4^k), as genome/encode.py kmer_ids does.
void mural_kmer_pack(const uint8_t* windows, int64_t n, int64_t w,
                     int64_t k, const int8_t* digit_lut, int32_t pad_id,
                     int32_t* out) {
    const int64_t cols = w - k + 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = windows + i * w;
        int32_t* orow = out + i * cols;
        for (int64_t c = 0; c < cols; ++c) {
            int32_t id = 0;
            bool bad = false;
            for (int64_t d = 0; d < k; ++d) {
                const int8_t dig = digit_lut[row[c + d]];
                if (dig < 0) { bad = true; break; }
                id = id * 4 + dig;
            }
            orow[c] = bad ? pad_id : id;
        }
    }
}

// Range means over a two-level prefix-sum track (genome/tracks.py):
//   S(p) = block_prefix[p / K] + inblock[p],  sum(lo,hi) = S(hi) - S(lo)
// One pass over the sites, four reads each, in the float64 arithmetic
// of the numpy path (PrefixTrack._prefix), so the means are bit-equal.
void mural_track_mean(const double* block_prefix, const float* inblock,
                      int64_t n, int64_t k, const int64_t* starts,
                      const int64_t* stops, int64_t n_sites,
                      double* out) {
    const double total = block_prefix[n > 0 ? (n + k - 1) / k : 0];
    for (int64_t i = 0; i < n_sites; ++i) {
        int64_t lo = starts[i] < 0 ? 0 : starts[i];
        int64_t hi = stops[i] > n ? n : stops[i];
        if (hi <= lo) { out[i] = 0.0; continue; }
        const double s_lo = (lo >= n) ? total
            : block_prefix[lo / k] + (double)inblock[lo];
        const double s_hi = (hi >= n) ? total
            : block_prefix[hi / k] + (double)inblock[hi];
        out[i] = (s_hi - s_lo) / (double)(hi - lo);
    }
}

// Format prediction rows as TSV bytes:
//   <chrom>\t<start>\t<end>\t<strand>\t0\t<prob0>...\t<probN>\n
// Probabilities use printf %.4g (the reference's pandas
// float_format='%.4g', MuRaL/scripts/run_predict.py to_csv); mut_type is
// the constant 0, since genome-wide sites carry no observation and the
// prediction schema (chrom start end strand mut_type prob0..N) needs the
// column for `evaluate`.  Integer fields use a hand itoa.  Returns the
// bytes written, or -1 if `cap` would be exceeded.
int64_t mural_format_pred_tsv(const char* chrom, int64_t chrom_len,
                              const int64_t* pos, const uint8_t* neg,
                              const double* probs, int64_t n,
                              int64_t n_class, char* out, int64_t cap) {
    // worst case per row: chrom + 2 20-digit ints + strand + mut_type
    // + floats
    const int64_t worst = chrom_len + 2 * 21 + 2 + 2 + n_class * 14 + 8;
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if ((p - out) + worst > cap) return -1;
        std::memcpy(p, chrom, chrom_len);
        p += chrom_len;
        *p++ = '\t';
        // start and end (= start + 1); positions are >= 0
        for (int rep = 0; rep < 2; ++rep) {
            uint64_t v = (uint64_t)pos[i] + (uint64_t)rep;
            char tmp[20];
            int len = 0;
            do { tmp[len++] = '0' + (char)(v % 10); v /= 10; } while (v);
            while (len) *p++ = tmp[--len];
            *p++ = '\t';
        }
        *p++ = neg[i] ? '-' : '+';
        *p++ = '\t';
        *p++ = '0';
        for (int64_t j = 0; j < n_class; ++j) {
            *p++ = '\t';
            p += snprintf(p, 16, "%.4g", probs[i * n_class + j]);
        }
        *p++ = '\n';
    }
    return p - out;
}

}  // extern "C"
