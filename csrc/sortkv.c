/* Parallel LSD radix sort of (u64 key, u32 payload) pairs.
 *
 * The index build's global sort-and-group union (the accelerator-friendly replacement
 * for the reference's locked union tree, ref: src/krepp.cpp:248-303,
 * src/table.cpp:182-232) sorts tens of millions of (row<<32|residual, leaf)
 * tuples; numpy's single-threaded comparison sort is the bottleneck there.
 * This is a stable byte-wise LSD radix with OpenMP-parallel histogram and
 * scatter passes; passes whose byte is constant across all keys are skipped
 * (row bits above nrows and residual bits above 2(k-h) are always zero).
 *
 * Called via ctypes (releases the GIL for the whole sort).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads(void) { return 1; }
static int omp_get_thread_num(void) { return 0; }
#endif

#define RADIX 256

int64_t krepp_sort_k(uint64_t *keys, int64_t n);

/* Sorts keys[0..n) ascending (stable), permuting vals alongside.
 * Returns 0 on success, -1 on allocation failure. */
int64_t krepp_sort_kv(uint64_t *keys, uint32_t *vals, int64_t n)
{
    if (n <= 1)
        return 0;

    uint64_t all_or = 0, all_and = ~(uint64_t)0;
#ifdef _OPENMP
#pragma omp parallel for reduction(|:all_or) reduction(&:all_and)
#endif
    for (int64_t i = 0; i < n; i++) {
        all_or |= keys[i];
        all_and &= keys[i];
    }

    int passes[8], npass = 0;
    for (int b = 0; b < 8; b++) {
        uint64_t o = (all_or >> (8 * b)) & 0xFF;
        uint64_t a = (all_and >> (8 * b)) & 0xFF;
        if (o != a) /* byte varies across keys */
            passes[npass++] = b;
    }
    if (npass == 0)
        return 0;

    uint64_t *kbuf = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    uint32_t *vbuf = (uint32_t *)malloc((size_t)n * sizeof(uint32_t));
    if (!kbuf || !vbuf) {
        free(kbuf);
        free(vbuf);
        return -1;
    }

    int nt = omp_get_max_threads();
    if (nt > 64)
        nt = 64;
    int64_t *hist = (int64_t *)calloc((size_t)nt * RADIX, sizeof(int64_t));
    if (!hist) {
        free(kbuf);
        free(vbuf);
        return -1;
    }

    uint64_t *ksrc = keys, *kdst = kbuf;
    uint32_t *vsrc = vals, *vdst = vbuf;

    for (int p = 0; p < npass; p++) {
        int shift = 8 * passes[p];
        memset(hist, 0, (size_t)nt * RADIX * sizeof(int64_t));

#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = omp_get_thread_num();
            int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t *h = hist + (size_t)t * RADIX;
            for (int64_t i = lo; i < hi; i++)
                h[(ksrc[i] >> shift) & 0xFF]++;
        }

        /* column-major exclusive scan: digit-major, thread-minor keeps the
         * per-thread scatter stable */
        int64_t sum = 0;
        for (int d = 0; d < RADIX; d++) {
            for (int t = 0; t < nt; t++) {
                int64_t c = hist[(size_t)t * RADIX + d];
                hist[(size_t)t * RADIX + d] = sum;
                sum += c;
            }
        }

#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = omp_get_thread_num();
            int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t *h = hist + (size_t)t * RADIX;
            for (int64_t i = lo; i < hi; i++) {
                int64_t j = h[(ksrc[i] >> shift) & 0xFF]++;
                kdst[j] = ksrc[i];
                vdst[j] = vsrc[i];
            }
        }

        uint64_t *kt = ksrc; ksrc = kdst; kdst = kt;
        uint32_t *vt = vsrc; vsrc = vdst; vdst = vt;
    }

    if (ksrc != keys) {
        memcpy(keys, ksrc, (size_t)n * sizeof(uint64_t));
        memcpy(vals, vsrc, (size_t)n * sizeof(uint32_t));
    }
    free(hist);
    free(kbuf);
    free(vbuf);
    return 0;
}

/* Pack (row, residual) u32 pairs into u64 keys row<<32|res, in parallel. */
void krepp_pack_keys(const uint32_t *rows, const uint32_t *res,
                     uint64_t *out, int64_t n)
{
#ifdef _OPENMP
#pragma omp parallel for
#endif
    for (int64_t i = 0; i < n; i++)
        out[i] = ((uint64_t)rows[i] << 32) | res[i];
}

/* Per-genome dedupe: pack (row, residual) pairs, sort, drop duplicates,
 * unpack in place. Returns the unique count, or -1 on failure.
 * (The reference dedupes per genome inside DynHT::fill_table,
 * ref: src/table.cpp:157-166.) */
int64_t krepp_sort_unique_pairs(uint32_t *rows, uint32_t *res, int64_t n)
{
    if (n <= 1)
        return n;
    uint64_t *keys = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    if (!keys)
        return -1;
    krepp_pack_keys(rows, res, keys, n);
    if (krepp_sort_k(keys, n) != 0) {
        free(keys);
        return -1;
    }
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        if (i > 0 && keys[i] == keys[i - 1])
            continue;
        rows[m] = (uint32_t)(keys[i] >> 32);
        res[m] = (uint32_t)keys[i];
        m++;
    }
    free(keys);
    return m;
}

/* 2-bit-pack a read batch for the device upload (the host half of
 * codec.pack_codes_host; numpy needs several full-array passes). codes: u8 [B, L] base codes
 * (0..3 = ACGT, >=4 invalid); lengths: i32 [B]. Fills packed u32
 * [B, (L+15)/16] and vbits u32 [B, (L+31)/32] (1 = valid base), and
 * returns the number of reads carrying an invalid base inside their
 * length (0 => the caller can drop vbits). */
int64_t krepp_pack_codes(const uint8_t *codes, int64_t B, int64_t L,
                         const int32_t *lengths, uint32_t *packed,
                         uint32_t *vbits)
{
    int64_t W = (L + 15) / 16;
    int64_t WV = (L + 31) / 32;
    int64_t n_invalid = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+:n_invalid)
#endif
    for (int64_t b = 0; b < B; b++) {
        const uint8_t *row = codes + b * L;
        int32_t len = lengths[b];
        int bad = 0;
        for (int64_t w = 0; w < W; w++) {
            uint32_t acc = 0;
            int64_t base = w * 16;
            int64_t hi = base + 16 < L ? base + 16 : L;
            for (int64_t j = base; j < hi; j++) {
                uint8_t c = row[j];
                if (c < 4)
                    acc |= (uint32_t)c << (2 * (j - base));
            }
            packed[b * W + w] = acc;
        }
        for (int64_t w = 0; w < WV; w++) {
            uint32_t acc = 0;
            int64_t base = w * 32;
            int64_t hi = base + 32 < L ? base + 32 : L;
            for (int64_t j = base; j < hi; j++) {
                if (row[j] < 4)
                    acc |= 1u << (j - base);
                else if (j < len)
                    bad = 1;
            }
            vbits[b * WV + w] = acc;
        }
        n_invalid += bad;
    }
    return n_invalid;
}

/* Sort u64 keys only (no payload; per-genome dedupe and sketch builds). */
int64_t krepp_sort_k(uint64_t *keys, int64_t n)
{
    if (n <= 1)
        return 0;

    uint64_t all_or = 0, all_and = ~(uint64_t)0;
#ifdef _OPENMP
#pragma omp parallel for reduction(|:all_or) reduction(&:all_and)
#endif
    for (int64_t i = 0; i < n; i++) {
        all_or |= keys[i];
        all_and &= keys[i];
    }
    int passes[8], npass = 0;
    for (int b = 0; b < 8; b++) {
        if (((all_or >> (8 * b)) & 0xFF) != ((all_and >> (8 * b)) & 0xFF))
            passes[npass++] = b;
    }
    if (npass == 0)
        return 0;

    uint64_t *kbuf = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    if (!kbuf)
        return -1;
    int nt = omp_get_max_threads();
    if (nt > 64)
        nt = 64;
    int64_t *hist = (int64_t *)calloc((size_t)nt * RADIX, sizeof(int64_t));
    if (!hist) {
        free(kbuf);
        return -1;
    }
    uint64_t *ksrc = keys, *kdst = kbuf;
    for (int p = 0; p < npass; p++) {
        int shift = 8 * passes[p];
        memset(hist, 0, (size_t)nt * RADIX * sizeof(int64_t));
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = omp_get_thread_num();
            int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t *h = hist + (size_t)t * RADIX;
            for (int64_t i = lo; i < hi; i++)
                h[(ksrc[i] >> shift) & 0xFF]++;
        }
        int64_t sum = 0;
        for (int d = 0; d < RADIX; d++) {
            for (int t = 0; t < nt; t++) {
                int64_t c = hist[(size_t)t * RADIX + d];
                hist[(size_t)t * RADIX + d] = sum;
                sum += c;
            }
        }
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = omp_get_thread_num();
            int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t *h = hist + (size_t)t * RADIX;
            for (int64_t i = lo; i < hi; i++)
                kdst[h[(ksrc[i] >> shift) & 0xFF]++] = ksrc[i];
        }
        uint64_t *kt = ksrc; ksrc = kdst; kdst = kt;
    }
    if (ksrc != keys)
        memcpy(keys, ksrc, (size_t)n * sizeof(uint64_t));
    free(hist);
    free(kbuf);
    return 0;
}
