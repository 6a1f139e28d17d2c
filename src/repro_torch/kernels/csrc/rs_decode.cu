// Batched Reed-Solomon RS(15,12) decode over GF(16), t = 1, by syndromes:
// bits (B, 60) int32 -> message_bits (B, 48) int32, codeword_bits (B, 60)
// int32, ok (B,) bool, n_corrected (B,) int32.
//
// Replaces the Pallas kernel `rs_decode_batch`
// (src/repro/kernels/rs_decode.py:202, pallas_call at :215, body `_kernel`
// :86), a branch-free Berlekamp-Welch decoder, and gives its four outputs
// bit for bit on every input whose bits are in {0, 1} (as the `bits` stage
// makes them: logits > 0).  On other values the reference's carry-less
// arithmetic is not modelled; the plain version is the op-for-op mirror.
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

__global__ void __launch_bounds__(32 * WARPS)
    rs_syndrome_decode_kernel(const int* __restrict__ bits,
                              int* __restrict__ msg_out,
                              int* __restrict__ cw_out,
                              bool* __restrict__ ok_out,
                              int* __restrict__ ncorr_out, int B) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps only: the reduction needs all 32
  const int sym = lane >> 1;            // lanes 30, 31: sym 15, no bits
  const int sh = (lane & 1) ? 0 : 2;    // the lane's bits in its symbol
  int2 b = make_int2(0, 0);
  if (lane < N * M / 2)
    b = reinterpret_cast<const int2*>(bits + row * N * M)[lane];
  b.x &= 1;
  b.y &= 1;
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
