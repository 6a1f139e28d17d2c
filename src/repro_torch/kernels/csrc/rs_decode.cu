// Batched Reed-Solomon RS(15,12) decode over GF(16), t = 1, by syndromes:
// bits (B, 60) int32 -> message_bits (B, 48) int32, codeword_bits (B, 60)
// int32, ok (B,) bool, n_corrected (B,) int32.
//
// Replaces the Pallas kernel `rs_decode_batch`
// (src/repro/kernels/rs_decode.py:202, pallas_call at :215, body `_kernel`
// :86), a branch-free Berlekamp-Welch decoder, and gives its four outputs
// bit for bit on every int32 input.  A word whose bits are all in {0, 1}
// (as the `bits` stage makes them: logits > 0) takes the closed form
// below; a word with any other entry takes `bw_decode_word`, the
// reference's Berlekamp-Welch algorithm step for step in its int32
// arithmetic, run by lane 0 of the word's warp (see the end of this note).
//
// Why a closed form is exact.  The code is evaluation-form RS at the 15
// points alpha^0..alpha^14 (deg P < 12), so S_s = sum_i R_i alpha^(i s),
// s = 1, 2, 3, vanish exactly on codewords.  If R is within distance 1 of
// a codeword c, Berlekamp-Welch's nullspace vector has Q != 0 and
// Nu = Q P_c (Nu - Q P_c has degree <= 12 and 14 zeros), Q vanishes at the
// error, Lagrange through the first 12 positions where Q != 0 returns c:
// ok, n_corrected = dist.  Otherwise the interpolant is a codeword at
// distance >= 2 from R: not ok, codeword = R, n_corrected = -1.  The
// syndromes decide the same: S = 0 is a codeword; S1, S2, S3 all nonzero
// with S1 S3 = S2^2 is one error at log(S2 / S1) of value S1^2 / S2;
// anything else is at distance >= 2.
//
// Layout: one warp a codeword, four a 128-thread block.  Lane l < 30 loads
// bits 2l, 2l+1 as one int2 (rows are 240 bytes, so the warp's loads
// coalesce), the two high or low bits of symbol l / 2.  That partial
// symbol times alpha^(s i) is the lane's share of S_s; the three shares,
// 4 bits each, are XOR-reduced across the warp in one __reduce_xor_sync.
// Every lane then locates and sizes the error redundantly (~10 integer
// ops), XORs it into its own two bits and stores them coalesced; lane 0
// writes ok and n_corrected.  GF(16) log and exp are nibble fields of two
// 64-bit immediates, so no table lives in memory and nothing in local
// memory.
//
// Words outside {0, 1}.  The reference reads any int32 bits: a symbol is
// sum_j bits[4i + j] * 2^(3 - j) in int32 (wrapping), and its carry-less
// GF(16) products of such symbols keep (and shift) every bit above bit 3.
// The warp finds such a word with one vote (__any_sync on the lanes' two
// loaded bits) and hands it to `bw_decode_word`, which mirrors the
// reference (and the plain version, rs_decode.py) step for step in uint32,
// whose wrap-around, XOR, AND and shifts by less than 32 give the int32
// bits: masked-pivot RREF of the 15 x 15 system, the first free column,
// Q's zeros, the first K error-free positions, Lagrange, n_err.  Its
// state (the 15 x 15 system and the per-position arrays, 1.2 KB) lives in
// the block's shared memory, one slot a warp, so the kernel keeps no
// stack frame; a word in {0, 1} never reaches it.
//
// What bounds it on the H100: the launch.  A word needs ~400 integer ops
// and ~690 bytes; at B = 32 that is 8 blocks, and the kernel's time is its
// launch and one pass of a few dozen dependent instructions per lane.
#include <cuda_runtime.h>

namespace {

constexpr int N = 15, K = 12, M = 4;
constexpr int WARPS = 4;  // codewords per block

// nibble e = alpha^e mod x^4 + x + 1 for e = 0..14 (1, 2, 4, 8, 3, 6, 12,
// 11, 5, 10, 7, 14, 15, 13, 9), and nibble 15 = alpha^15 = 1
constexpr unsigned long long EXP = 0x19dfe7a5bc638421ull;
// nibble a = log_alpha(a) for a = 1..15 (nibble 0 unused: callers mask 0)
constexpr unsigned long long LOG = 0xcbd679e3a5824100ull;

__device__ __forceinline__ int gf_exp(int e) {
  return (int)(EXP >> (4 * e)) & 15;
}
__device__ __forceinline__ int gf_log(int a) {
  return (int)(LOG >> (4 * a)) & 15;
}
// e mod 15 for 0 <= e < 30
__device__ __forceinline__ int mod15(int e) { return e >= N ? e - N : e; }

// ---- the reference's Berlekamp-Welch, for words outside {0, 1} ----------
constexpr int T = 1, NQ = T + 1, NN = T + K, COLS = NQ + NN;  // 2 + 13

// The reference's carry-less multiply, argument order kept (bits of b
// select shifted copies of a), then bits 6..4 reduced by x^4 + x + 1;
// bits above 6 stay, as in its int32 arithmetic.
__device__ __forceinline__ unsigned gf16_mul(unsigned a, unsigned b) {
  unsigned res = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if ((b >> i) & 1u) res ^= a << i;
#pragma unroll
  for (int j = 6; j >= 4; --j)
    if ((res >> j) & 1u) res ^= 0x13u << (j - 4);
  return res;
}

__device__ __forceinline__ unsigned gf16_inv(unsigned a) {  // a^14
  const unsigned a2 = gf16_mul(a, a), a4 = gf16_mul(a2, a2),
                 a8 = gf16_mul(a4, a4);
  return gf16_mul(a8, gf16_mul(a4, a2));
}

// The Berlekamp-Welch state of one word, in shared memory.
struct BwState {
  unsigned A[N][COLS];
  unsigned R[N], P_at[N], xs_sel[K], ys_sel[K], wgt[K];
  int pivot_col[N];
};

// One word's four outputs, by one thread, in the reference's order of
// operations; xs(e) = alpha^e are the evaluation points.
__device__ __forceinline__ void bw_decode_word(const int* __restrict__ bi,
                                               int* __restrict__ msg,
                                               int* __restrict__ cw,
                                               bool* ok_out, int* ncorr_out,
                                               BwState& st) {
  unsigned(&A)[N][COLS] = st.A;
  unsigned *R = st.R, *P_at = st.P_at, *xs_sel = st.xs_sel,
           *ys_sel = st.ys_sel, *wgt = st.wgt;
  int* pivot_col = st.pivot_col;
  auto xs = [](int e) { return (unsigned)gf_exp(e); };
  for (int e = 0; e < N; ++e) {
    unsigned s = 0;
    for (int j = 0; j < M; ++j) s += (unsigned)bi[e * M + j] << (M - 1 - j);
    R[e] = s;
  }
  for (int i = 0; i < N; ++i) {
    unsigned p = 1;
    for (int j = 0; j < NQ; ++j) {
      A[i][j] = gf16_mul(R[i], p);
      p = gf16_mul(p, xs(i));
    }
    p = 1;
    for (int j = 0; j < NN; ++j) {
      A[i][NQ + j] = p;
      p = gf16_mul(p, xs(i));
    }
  }
  for (int i = 0; i < N; ++i) pivot_col[i] = COLS;
  int r = 0;
  for (int c = 0; c < COLS; ++c) {
    int pr = -1;  // the first eligible row: row >= r, nonzero
    for (int i = r; i < N && pr < 0; ++i)
      if (A[i][c] != 0) pr = i;
    if (pr < 0) continue;  // none: the column is free, nothing changes
    for (int j = 0; j < COLS; ++j) {
      const unsigned t = A[r][j];
      A[r][j] = A[pr][j];
      A[pr][j] = t;
    }
    const unsigned inv = gf16_inv(A[r][c]);
    for (int j = 0; j < COLS; ++j) A[r][j] = gf16_mul(A[r][j], inv);
    for (int i = 0; i < N; ++i) {
      if (i == r) continue;
      const unsigned f = A[i][c];
      for (int j = 0; j < COLS; ++j) A[i][j] ^= gf16_mul(f, A[r][j]);
    }
    pivot_col[r] = c;
    r += 1;
  }
  int free_col = 0;  // the first non-pivot column, 0 when all pivot
  for (int c = COLS - 1; c >= 0; --c) {
    bool pivot = false;
    for (int i = 0; i < N; ++i) pivot |= pivot_col[i] == c;
    if (!pivot) free_col = c;
  }
  unsigned Q[NQ];
  for (int c = 0; c < NQ; ++c) {
    unsigned s = c == free_col ? 1u : 0u;
    for (int i = 0; i < N; ++i)
      if (pivot_col[i] == c) s ^= A[i][free_col];
    Q[c] = s;
  }
  const bool q_nonzero = Q[0] != 0 || Q[1] != 0;
  // the first K error-free positions
  for (int s = 0; s < K; ++s) xs_sel[s] = ys_sel[s] = 0;
  int rank = 0;
  for (int e = 0; e < N; ++e) {
    unsigned qx = 0;
    for (int j = NQ - 1; j >= 0; --j) qx = gf16_mul(qx, xs(e)) ^ Q[j];
    if (!(qx == 0 && q_nonzero)) {
      if (rank < K) {
        xs_sel[rank] = xs(e);
        ys_sel[rank] = R[e];
      }
      rank += 1;
    }
  }
  for (int i = 0; i < K; ++i) {  // y_i * inv(prod_{j != i} (X_i ^ X_j))
    unsigned denom = 1;
    for (int j = 0; j < K; ++j)
      denom = gf16_mul(denom, j == i ? 1u : xs_sel[i] ^ xs_sel[j]);
    wgt[i] = gf16_mul(ys_sel[i], gf16_inv(denom));
  }
  int n_err = 0;
  for (int e = 0; e < N; ++e) {
    unsigned acc = 0;
    for (int i = 0; i < K; ++i) {
      unsigned numer = 1;
      for (int j = 0; j < K; ++j)
        if (j != i) numer = gf16_mul(numer, xs(e) ^ xs_sel[j]);
      acc ^= gf16_mul(numer, wgt[i]);
    }
    P_at[e] = acc;
    n_err += acc != R[e];
  }
  const bool ok = n_err <= T && q_nonzero;
  for (int e = 0; e < N; ++e) {
    const unsigned sym = ok ? P_at[e] : R[e];
    for (int j = 0; j < M; ++j) {
      const int bit = (int)((sym >> (M - 1 - j)) & 1u);
      cw[e * M + j] = bit;
      if (e < K) msg[e * M + j] = bit;
    }
  }
  *ok_out = ok;
  *ncorr_out = ok ? n_err : -1;
}

__global__ void __launch_bounds__(32 * WARPS)
    rs_syndrome_decode_kernel(const int* __restrict__ bits,
                              int* __restrict__ msg_out,
                              int* __restrict__ cw_out,
                              bool* __restrict__ ok_out,
                              int* __restrict__ ncorr_out, int B) {
  __shared__ BwState bw[WARPS];  // the out-of-{0, 1} path's state
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps only: the reduction needs all 32
  const int sym = lane >> 1;            // lanes 30, 31: sym 15, no bits
  const int sh = (lane & 1) ? 0 : 2;    // the lane's bits in its symbol
  int2 b = make_int2(0, 0);
  if (lane < N * M / 2)
    b = reinterpret_cast<const int2*>(bits + row * N * M)[lane];
  // a word with an entry outside {0, 1}: the reference's algorithm
  if (__any_sync(0xffffffffu, ((b.x | b.y) & ~1) != 0)) {
    if (lane == 0)
      bw_decode_word(bits + row * N * M, msg_out + row * K * M,
                     cw_out + row * N * M, ok_out + row, ncorr_out + row,
                     bw[threadIdx.x >> 5]);
    return;
  }
  const int part = ((b.x << 1) | b.y) << sh;
  // part * alpha^(s sym), s = 1, 2, 3, packed as S1 | S2 << 4 | S3 << 8
  const int e1 = mod15(gf_log(part) + sym), e2 = mod15(e1 + sym),
            e3 = mod15(e2 + sym);
  int synd = part ? gf_exp(e1) | gf_exp(e2) << 4 | gf_exp(e3) << 8 : 0;
  synd = (int)__reduce_xor_sync(0xffffffffu, (unsigned)synd);
  const int s1 = synd & 15, s2 = (synd >> 4) & 15, s3 = synd >> 8;
  const int l1 = gf_log(s1), l2 = gf_log(s2), l3 = gf_log(s3);
  const bool zero = synd == 0;
  const bool one = s1 && s2 && s3 && mod15(l1 + l3) == mod15(2 * l2);
  const int pos = mod15(l2 + N - l1);                   // S2 / S1
  const int val = gf_exp(mod15(l1 + mod15(l1 + N - l2)));  // S1^2 / S2
  const int flip = (one && sym == pos) ? (val >> sh) & 3 : 0;
  b.x ^= flip >> 1;
  b.y ^= flip & 1;
  if (lane < N * M / 2)
    reinterpret_cast<int2*>(cw_out + row * N * M)[lane] = b;
  if (lane < K * M / 2)
    reinterpret_cast<int2*>(msg_out + row * K * M)[lane] = b;
  if (lane == 0) {
    ok_out[row] = zero || one;
    ncorr_out[row] = zero ? 0 : (one ? 1 : -1);
  }
}

}  // namespace

// bits must be 8-byte aligned (the wrapper checks); the outputs are fresh
// allocations.
extern "C" int qr_rs_decode(const void* bits, void* msg, void* cw, void* ok,
                            void* ncorr, int B, void* stream) {
  rs_syndrome_decode_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, 0,
                              (cudaStream_t)stream>>>(
      (const int*)bits, (int*)msg, (int*)cw, (bool*)ok, (int*)ncorr, B);
  return (int)cudaGetLastError();
}
