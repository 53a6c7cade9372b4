/* Native host hashing engine: Keccak-f[1600] / Keccak-256 and the
 * width-12 Goldilocks Poseidon permutation.
 *
 * This is the framework's host-side native runtime component, standing in
 * for the reference's hand-written SIMD/asm hash layers
 * (core/src/arch/x86_64/poseidon_goldilocks_avx2_bmi2.rs,
 * core/src/poseidon.rs packed paths, keccak-hash crate): the Python host
 * fallbacks (transcript duplexes, host Merkle paths for the Keccak and
 * Poseidon2 hasher configs, proof verification) dispatch here when the
 * shared library is available.
 *
 * Poseidon round constants / MDS tables are injected from Python at init
 * so the constant tables live in one place (hash/poseidon_constants.py).
 */

#include <stdint.h>
#include <string.h>

#define GL_P 0xFFFFFFFF00000001ULL

/* ---------------- Goldilocks arithmetic ---------------- */

typedef unsigned __int128 u128;

static inline uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    int carry = s < a;
    if (carry || s >= GL_P) s -= GL_P;
    return s;
}

static inline uint64_t gl_reduce128(u128 x) {
    uint64_t lo = (uint64_t)x;
    uint64_t hi = (uint64_t)(x >> 64);
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    /* x = lo + 2^64 hi_lo' ... standard two-step reduction:
       2^64 = 2^32 - 1 (mod p), 2^96 = -1 (mod p) */
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= 0xFFFFFFFFULL; /* borrow: subtract 2^32-1 */
    uint64_t t1 = (hi_lo << 32) - hi_lo; /* hi_lo * (2^32 - 1) */
    uint64_t r = t0 + t1;
    if (r < t0 || r >= GL_P) r -= GL_P;
    return r;
}

static inline uint64_t gl_mul(uint64_t a, uint64_t b) {
    return gl_reduce128((u128)a * (u128)b);
}

/* ---------------- Poseidon (width 12) ---------------- */

static uint64_t RC[360];        /* ALL_ROUND_CONSTANTS */
static uint64_t MDS_CIRC[12];
static uint64_t MDS_DIAG[12];
static int poseidon_ready = 0;

void poseidon_init(const uint64_t *rc, const uint64_t *circ, const uint64_t *diag) {
    memcpy(RC, rc, sizeof(RC));
    memcpy(MDS_CIRC, circ, sizeof(MDS_CIRC));
    memcpy(MDS_DIAG, diag, sizeof(MDS_DIAG));
    poseidon_ready = 1;
}

static inline uint64_t sbox7(uint64_t x) {
    uint64_t x2 = gl_mul(x, x);
    uint64_t x4 = gl_mul(x2, x2);
    uint64_t x3 = gl_mul(x, x2);
    return gl_mul(x3, x4);
}

static void mds_layer(uint64_t *st) {
    uint64_t out[12];
    for (int r = 0; r < 12; r++) {
        u128 acc = 0;
        for (int c = 0; c < 12; c++)
            acc += (u128)MDS_CIRC[c] * (u128)st[(r + c) % 12];
        acc += (u128)MDS_DIAG[r] * (u128)st[r];
        out[r] = gl_reduce128(acc);
    }
    memcpy(st, out, sizeof(out));
}

void poseidon_permute(uint64_t *st) {
    int rc = 0;
    for (int round = 0; round < 4; round++) {
        for (int i = 0; i < 12; i++) st[i] = sbox7(gl_add(st[i], RC[rc + i]));
        rc += 12;
        mds_layer(st);
    }
    for (int round = 0; round < 22; round++) {
        for (int i = 0; i < 12; i++) st[i] = gl_add(st[i], RC[rc + i]);
        rc += 12;
        st[0] = sbox7(st[0]);
        mds_layer(st);
    }
    for (int round = 0; round < 4; round++) {
        for (int i = 0; i < 12; i++) st[i] = sbox7(gl_add(st[i], RC[rc + i]));
        rc += 12;
        mds_layer(st);
    }
}

/* batched: n states of 12 lanes, in place */
void poseidon_permute_batch(uint64_t *states, uint64_t n) {
    for (uint64_t i = 0; i < n; i++) poseidon_permute(states + 12 * i);
}

/* ---------------- Keccak-f[1600] / Keccak-256 ---------------- */

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rol64(uint64_t x, int n) {
    return n == 0 ? x : (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint64_t *A) {
    static const int R[5][5] = {{0, 36, 3, 41, 18},
                                {1, 44, 10, 45, 2},
                                {62, 6, 43, 15, 61},
                                {28, 55, 25, 21, 56},
                                {27, 20, 39, 8, 14}};
    uint64_t B[5][5], C[5], D[5];
    for (int rnd = 0; rnd < 24; rnd++) {
        for (int x = 0; x < 5; x++)
            C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
        for (int x = 0; x < 5; x++)
            D[x] = C[(x + 4) % 5] ^ rol64(C[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                B[y][(2 * x + 3 * y) % 5] = rol64(A[x + 5 * y] ^ D[x], R[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                A[x + 5 * y] =
                    B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y]);
            }
        A[0] ^= KECCAK_RC[rnd];
    }
}

/* Original Keccak-256 (pad 0x01) */
void keccak256(const uint8_t *data, uint64_t len, uint8_t *out32) {
    uint64_t A[25];
    memset(A, 0, sizeof(A));
    const uint64_t rate = 136;
    uint8_t block[136];
    while (len >= rate) {
        for (int i = 0; i < 17; i++) {
            uint64_t w;
            memcpy(&w, data + 8 * i, 8);
            A[i] ^= w;
        }
        keccak_f1600(A);
        data += rate;
        len -= rate;
    }
    memset(block, 0, rate);
    memcpy(block, data, len);
    block[len] = 0x01;
    block[rate - 1] |= 0x80;
    for (int i = 0; i < 17; i++) {
        uint64_t w;
        memcpy(&w, block + 8 * i, 8);
        A[i] ^= w;
    }
    keccak_f1600(A);
    memcpy(out32, A, 32);
}
