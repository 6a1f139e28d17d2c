// Batched Reed-Solomon RS(15,12) decode over GF(16), t = 1,
// Berlekamp-Welch: bits (B, 60) -> message_bits (B, 48),
// codeword_bits (B, 60), ok (B,), n_corrected (B,).
//
// Replaces the Pallas kernel `rs_decode_batch`
// (src/repro/kernels/rs_decode.py:202, pallas_call at :215, body `_kernel`
// :86).  The outputs are integers and equal the reference's exactly,
// degenerate inputs included, so this kernel follows the reference's
// algorithm step for step rather than the classical branchy decoder:
//   * bits -> symbols MSB first; the (15 x 15) system A = [R_i * X_i^j |
//     X_i^j] (j < 2 | j < 13);
//   * masked-pivot RREF: for each column the FIRST eligible row (row >= r,
//     nonzero) is the pivot, rows swap, the pivot row is normalised by
//     inv(pivot) and XOR-eliminated from every other row;
//   * nullspace vector from the FIRST free column (column 0 when all 15
//     columns pivot), x[pivot_col[row]] += A[row][free];
//   * error locations = zeros of Q (none when Q == 0, and then ok = 0);
//   * the first K error-free positions by rank prefix-sum; unfilled
//     (x, y) slots stay 0 and inv(0) = 0 flows through Lagrange;
//   * n_err = #(P(X_i) != R_i); ok = n_err <= t and Q != 0; on failure
//     the codeword is the received word and n_corrected = -1.
// GF(16) multiply is the reference's carry-less form (4 partial products,
// then reduction of bits 6..4 by x^4 + x + 1), argument order kept, so
// even out-of-range symbols map exactly as in the reference; inverse is
// a^14.  The TPU avoided gathers (rs_decode.py:8); here the point is
// bit-exact agreement, and the carry-less form costs only ALU ops.
//
// What bounds it on the H100: neither bytes (~680 B per codeword) nor
// throughput at serving batch sizes — one thread per codeword runs ~6k
// GF(16) multiplies (~120k dependent integer ops; the Lagrange step alone
// is N * K * K multiplies), so at B=32 a single warp's latency sets the
// time.  The (15 x 15) elimination state
// lives in the thread's local memory (L1-resident).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 4, N = 15, K = 12, T = 1;
constexpr int NQ = T + 1, NN = T + K, COLS = NQ + NN;  // 2 + 13 = 15

__constant__ int c_xs[N] = {1, 2, 4, 8, 3, 6, 12, 11, 5, 10, 7, 14, 15, 13,
                            9};  // alpha^0 .. alpha^14 mod x^4 + x + 1

__device__ __forceinline__ int gf16_mul(int a, int b) {
  int res = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if ((b >> i) & 1) res ^= a << i;
#pragma unroll
  for (int j = 6; j >= 4; --j)
    if ((res >> j) & 1) res ^= 0x13 << (j - 4);
  return res;
}

__device__ __forceinline__ int gf16_inv(int a) {
  const int a2 = gf16_mul(a, a);
  const int a4 = gf16_mul(a2, a2);
  const int a8 = gf16_mul(a4, a4);
  return gf16_mul(a8, gf16_mul(a4, a2));  // a^14
}

__global__ void rs_decode_kernel(const int* __restrict__ bits,
                                 int* __restrict__ msg_out,
                                 int* __restrict__ cw_out,
                                 int* __restrict__ ok_out,
                                 int* __restrict__ ncorr_out, int B) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int* bi = bits + (long long)row * N * M;
  int R[N];
  for (int e = 0; e < N; ++e) {
    int s = 0;
    for (int j = 0; j < M; ++j) s += bi[e * M + j] * (1 << (M - 1 - j));
    R[e] = s;
  }
  int A[N][COLS];
  for (int i = 0; i < N; ++i) {
    const int x = c_xs[i];
    int p = 1;
    for (int j = 0; j < NQ; ++j) {
      A[i][j] = gf16_mul(R[i], p);
      p = gf16_mul(p, x);
    }
    p = 1;
    for (int j = 0; j < NN; ++j) {
      A[i][NQ + j] = p;
      p = gf16_mul(p, x);
    }
  }
  int pivot_col[N];
  for (int i = 0; i < N; ++i) pivot_col[i] = COLS;
  int r = 0;
  for (int c = 0; c < COLS; ++c) {
    int pr = -1;
    for (int i = r; i < N; ++i)
      if (A[i][c] != 0) { pr = i; break; }
    if (pr < 0) continue;  // no eligible row: the column is free
    if (pr != r)
      for (int j = 0; j < COLS; ++j) {
        const int tmp = A[r][j];
        A[r][j] = A[pr][j];
        A[pr][j] = tmp;
      }
    const int inv = gf16_inv(A[r][c]);
    for (int j = 0; j < COLS; ++j) A[r][j] = gf16_mul(A[r][j], inv);
    for (int i = 0; i < N; ++i) {
      if (i == r) continue;
      const int f = A[i][c];
      for (int j = 0; j < COLS; ++j) A[i][j] ^= gf16_mul(f, A[r][j]);
    }
    pivot_col[r] = c;
    r += 1;
  }
  int free_col = 0;  // argmin(is_pivot): first free column, 0 if none
  for (int c = COLS - 1; c >= 0; --c) {
    bool is_pivot = false;
    for (int i = 0; i < N; ++i) is_pivot |= pivot_col[i] == c;
    if (!is_pivot) free_col = c;
  }
  int Q[NQ];
  for (int c = 0; c < NQ; ++c) {
    int s = 0;
    for (int i = 0; i < N; ++i)
      if (pivot_col[i] == c) s += A[i][free_col];
    Q[c] = (c == free_col ? 1 : 0) ^ s;
  }
  const bool q_nonzero = (Q[0] != 0) || (Q[1] != 0);
  // first K error-free positions (rank prefix-sum)
  int xs_sel[K], ys_sel[K];
  for (int s = 0; s < K; ++s) xs_sel[s] = ys_sel[s] = 0;
  int rank = 0;
  for (int e = 0; e < N; ++e) {
    int qx = 0;
    for (int j = NQ - 1; j >= 0; --j) qx = gf16_mul(qx, c_xs[e]) ^ Q[j];
    const bool err = (qx == 0) && q_nonzero;
    if (!err) {
      if (rank < K) {
        xs_sel[rank] = c_xs[e];
        ys_sel[rank] = R[e];
      }
      rank += 1;
    }
  }
  // Lagrange weights wgt_i = y_i * inv(prod_{j != i} (X_i ^ X_j))
  int wgt[K];
  for (int i = 0; i < K; ++i) {
    int denom = 1;
    for (int j = 0; j < K; ++j)
      denom = gf16_mul(denom, j == i ? 1 : (xs_sel[i] ^ xs_sel[j]));
    wgt[i] = gf16_mul(ys_sel[i], gf16_inv(denom));
  }
  int n_err = 0;
  int P_at[N];
  for (int e = 0; e < N; ++e) {
    int acc = 0;
    for (int i = 0; i < K; ++i) {
      int numer = 1;
      for (int j = 0; j < K; ++j)
        if (j != i) numer = gf16_mul(numer, c_xs[e] ^ xs_sel[j]);
      acc ^= gf16_mul(numer, wgt[i]);
    }
    P_at[e] = acc;
    n_err += acc != R[e];
  }
  const bool ok = (n_err <= T) && q_nonzero;
  int* cw = cw_out + (long long)row * N * M;
  int* msg = msg_out + (long long)row * K * M;
  for (int e = 0; e < N; ++e) {
    const int sym = ok ? P_at[e] : R[e];
    for (int j = 0; j < M; ++j) {
      const int bit = (sym >> (M - 1 - j)) & 1;
      cw[e * M + j] = bit;
      if (e < K) msg[e * M + j] = bit;
    }
  }
  ok_out[row] = ok ? 1 : 0;
  ncorr_out[row] = ok ? n_err : -1;
}

}  // namespace

extern "C" int qr_rs_decode(const void* bits, void* msg, void* cw, void* ok,
                            void* ncorr, int B, void* stream) {
  const int threads = 128;
  rs_decode_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)bits, (int*)msg, (int*)cw, (int*)ok, (int*)ncorr, B);
  return (int)cudaGetLastError();
}
