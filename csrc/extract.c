/* Native genome winnowing: rolling encode + window minimizer + LSH keep.
 *
 * Semantics are identical to krepp_tpu/core/minimizer.py::extract_sequence_mers
 * (itself oracle-tested against the reference RSeq::extract_mers,
 * ref: src/rqseq.cpp:51-144), including:
 *   - the zero-initialised minimizer window (an end-of-sequence emission
 *     before ldiff valid k-mers selects the zero entry -> row 0 / residual 0)
 *   - stale pre-N entries surviving in the window across N resets
 *   - first-minimum (oldest) tie-breaking in the window scan
 *   - HyperLogLog(b=12) register updates for every valid k-mer (c1) and
 *     every emitted minimizer (c2)
 *
 * Index builds are host-side IO + winnowing, so this native path is the
 * default build ingester (the device path remains available).
 */

#include <stdint.h>
#include <string.h>

#define HLL_B 12
#define HLL_REGS (1 << HLL_B)

static inline uint64_t xur64(uint64_t h) {
    /* murmur3 finaliser (ref: src/common.hpp:147-155) */
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
}

static inline void hll_add(uint8_t *reg, uint32_t zlo) {
    /* rank = min(32-b, clz(zlo << b)) + 1, clz(0) = 32
     * (ref: src/hyperloglog.hpp:21,98-105) */
    uint32_t idx = zlo >> (32 - HLL_B);
    uint32_t v = zlo << HLL_B;
    int clz = v ? __builtin_clz(v) : 32;
    int rank = (clz < (32 - HLL_B) ? clz : (32 - HLL_B)) + 1;
    if (reg[idx] < (uint8_t)rank) reg[idx] = (uint8_t)rank;
}

/* Extract kept (local_row, residual) pairs from one contig.
 *
 * codes:      n base codes (0-3 = ACGT, >=4 = invalid)
 * k, w:       k-mer and minimizer window lengths (w >= k)
 * m, r, frac: LSH residue subsampling (ref: src/rqseq.cpp:125-139)
 * ppos[h]:    LSH hash bit-positions, ascending
 * npos[nres]: residual bit-positions, ascending
 * out_rows/out_res: caller buffers with capacity >= n - k + 2
 * c1reg/c2reg: 4096-byte HLL registers, caller-zeroed
 * Returns the number of kept pairs.
 */
int64_t krepp_extract(const uint8_t *codes, int64_t n,
                      int32_t k, int32_t w,
                      uint32_t m, uint32_t r, int32_t frac,
                      const int32_t *ppos, int32_t h,
                      const int32_t *npos, int32_t nres,
                      uint32_t *out_rows, uint32_t *out_res,
                      uint8_t *c1reg, uint8_t *c2reg) {
    if (n < w || k < 1) return 0;
    const int32_t ldiff = w - k + 1;
    const uint64_t enc_mask =
        (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);

    /* minimizer ring over the last ldiff valid k-mers, zero-initialised
     * (ref: src/rqseq.cpp:67); slot = compacted-valid-index % ldiff */
    enum { MAX_LDIFF_STACK = 4096 };
    uint64_t ring_z[MAX_LDIFF_STACK];
    uint32_t ring_rix[MAX_LDIFF_STACK];
    uint32_t ring_res[MAX_LDIFF_STACK];
    if (ldiff > MAX_LDIFF_STACK) return -1;
    memset(ring_z, 0, sizeof(uint64_t) * (size_t)ldiff);
    memset(ring_rix, 0, sizeof(uint32_t) * (size_t)ldiff);
    memset(ring_res, 0, sizeof(uint32_t) * (size_t)ldiff);

    uint64_t enc = 0;
    int64_t run = 0;      /* current ACGT run length */
    int64_t vcount = 0;   /* valid k-mers seen */
    int64_t kept = 0;

    for (int64_t e = 0; e < n; e++) {
        uint8_t b = codes[e];
        if (b >= 4) {
            run = 0;
            continue;
        }
        run++;
        enc = ((enc << 2) | b) & enc_mask;
        if (run < k) continue;

        /* current k-mer: bit-position j (from the right-hand end) is base
         * codes[e - j] = (enc >> 2j) & 3 (ref: src/common.hpp:225-243) */
        uint64_t z = xur64(enc);
        hll_add(c1reg, (uint32_t)z);

        uint32_t rix = 0;
        for (int32_t i = 0; i < h; i++)
            rix |= (uint32_t)((enc >> (2 * ppos[i])) & 3ULL) << (2 * i);
        uint32_t res = 0;
        for (int32_t i = 0; i < nres; i++) {
            uint32_t base = (uint32_t)((enc >> (2 * npos[i])) & 3ULL);
            res |= (base & 1u) << i;
            res |= (base >> 1) << (16 + i);
        }
        int64_t slot = vcount % ldiff;
        ring_z[slot] = z;
        ring_rix[slot] = rix;
        ring_res[slot] = res;
        vcount++;

        int emit = (run >= w) || (e == n - 1);
        if (!emit) continue;

        /* first minimum over the window ordered oldest -> newest, with
         * zero entries standing in before ldiff valid k-mers were seen */
        uint64_t best_z;
        uint32_t best_rix, best_res;
        if (vcount < ldiff) {
            /* a zero pad is oldest in the window and 0 <= every hash, so
             * the first-minimum scan always selects the zero entry here
             * (the reference's zero-initialised buffer quirk) */
            best_z = 0;
            best_rix = 0;
            best_res = 0;
        } else {
            int64_t oldest = vcount - ldiff;   /* compacted index */
            best_z = ring_z[oldest % ldiff];
            best_rix = ring_rix[oldest % ldiff];
            best_res = ring_res[oldest % ldiff];
            for (int64_t j = oldest + 1; j < vcount; j++) {
                int64_t idx = j % ldiff;
                if (ring_z[idx] < best_z) {
                    best_z = ring_z[idx];
                    best_rix = ring_rix[idx];
                    best_res = ring_res[idx];
                }
            }
        }
        hll_add(c2reg, (uint32_t)best_z);

        uint32_t rmod = best_rix % m;
        if (frac ? (rmod <= r) : (rmod == r)) {
            uint32_t local = frac ? (best_rix / m) * (r + 1) + rmod
                                  : best_rix / m;
            out_rows[kept] = local;
            out_res[kept] = best_res;
            kept++;
        }
    }
    return kept;
}
