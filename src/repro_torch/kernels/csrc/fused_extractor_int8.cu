// Extractor decode kernels, int8 rung, on the int8 tensor cores: the flat
// schedule's conv and to_bits (`conv_imma_kernel`, `gap_corr_imma_kernel`),
// the blocked schedule's conv (`conv_blocked_imma_kernel`, whose to_bits is
// the flat one), and their C entry points.  No int8 path launches a
// quantize pass: every conv quantizes its output in its epilogue.
//
// Replaces, at the int8 rung, the Pallas kernels `fused_extractor`
// (src/repro/kernels/fused_extractor.py:82, pallas_call at :113) and
// `fused_extractor_blocked` (:149, pallas_call at :257), whose
// tap dot is the reference's `tap_dot` (src/repro/core/extractor.py:140)
// with `quantize_rows_int8` (:119): for each 3x3 tap, each input pixel's
// cin channels quantized per row, s = max(amax, 1e-8) * float(1/127) and
// q = clip(rint(x / s), +-127); an exact int8 x int8 -> int32 dot against
// the per-column-quantized weights; (y * s_row) * w_scale[co]; folded into
// the fp32 sum in [ky, kx] order.  Epilogue: bias, channel_norm, ReLU; the
// to_bits layer sums (y + bias) into 8x16 GAP partials beside the
// correlation partials.
//
// What bounds it on the H100: at b = 32, l = 64, a 64 -> 64 block is 9.73
// G operations, 4.9 us at the 1979 TOP/s of the int8 tensor cores, and
// moves about 17.8 MB with int8 activations in and out, 5.3 us at 3.35
// TB/s.  What the tensor cores leave is the fp32 work the bits require:
// each tap's int32 dot is dequantized and folded for every (pixel,
// column) with its own roundings (4 fp32 operations, nine taps), and the
// epilogue's norm and quantize (a division per output), about 70 fp32
// operations per output that the FP32 pipes issue, one warp instruction a
// cycle per scheduler.
//
// Design (one block: a 16x16 pixel tile of one image, 8 warps):
//   * the tap dot is mma.sync.m16n8k32 s8 x s8 -> s32: M = 16 pixels (one
//     row of the tile), N = 8 output columns, K = 32 input channels (one
//     k-step at cin <= 32, two at 64; layer 0's three channels are one
//     word padded with zeros to 32).  Warp w owns pixel rows 2w, 2w + 1
//     and every column: 2 x COUT / 8 tiles of 16 x 8.  The int32 dot is
//     exact as the __dp4a chain's was (|dot| <= 64 * 127^2 < 2^22), so
//     each tap's partial, and every bit downstream, is unchanged;
//   * the accumulator of each tap starts at 0x4B400000 (the bits of
//     1.5 * 2^23), so the dot lands in the mantissa of a float in
//     [2^23, 2^24) and one exact __fsub_rn of 1.5 * 2^23 gives
//     float(dot) without a conversion instruction; then, per output,
//     (float(dot) * s_pixel) * w_scale[co] with __fmul_rn and the fold
//     with __fadd_rn in tap order;
//   * the halo (18 x 18 pixels, a pixel's int8 words contiguous, pitch
//     KW + 4 words so ldmatrix's eight row addresses fall in distinct bank
//     quads) lands with cp.async; ldmatrix.x4 gives a tap's A fragment for
//     16 pixels, whose rows the tap's shift picks;
//   * the weights are re-laid once on the device, beside the pack
//     (kernels/fused_extractor.py, `imma_fragments`), into the B fragments'
//     order: for each (tap, k-step, 8-column tile) 32 lanes x 2 words, so
//     a lane's fragment is one 8-byte shared load.  All nine taps (36 KB
//     at 64 -> 64) stream in with cp.async in three groups of three taps,
//     the halo with the first, and the taps of a group start when it has
//     landed;
//   * the quantize is folded into the producer: the hidden block's
//     epilogue stages the pre-norm tile in shared memory (pitch C + 1),
//     runs `norm_relu` with one thread per pixel in channel order, and
//     quantizes the pixel's outputs right there (`norm_relu_quantize`):
//     int8 words and one fp32 scale a pixel, 68 B at C = 64 instead of
//     256, bit for bit what `quantize_rows_int8` makes of the fp32
//     activation.  Layer 0 quantizes the tile's pixels as its halo lands;
//   * to_bits runs the same engine at 60 columns padded to 64 (zero
//     weights and scales in the padding, which is computed and dropped),
//     stages (y + bias) and reduces the 8x16 GAP and the correlation
//     partials in their row-major order with the fp32 kernel's helpers.
// Shared memory at 64 -> 64: weights 36,864 B, halo 25,920 B, scales
// 1,552 B, the epilogue's staged tile (66,560 B) over them; two blocks an
// SM (launch bounds cap a thread at 128 registers).
//
// Blocked schedule (`conv_blocked_imma_kernel`): the reference's blocked
// body (src/repro/kernels/fused_extractor.py:189-245: batch blocks of bb
// images, each conv's output columns in channel tiles of ct, the
// flat-norm epilogue on the full row) on the same engine.  Blocked ==
// flat bit for bit by construction: both call `imma_halo`, `imma_tap`
// (the int32 dot is exact and the fold per column, so a channel tile
// changes no output's chain), `stage_pre` and `norm_relu_quantize`.  What
// the schedule sets is which images share a staged weight slice:
//   * a block computes four 8x8 pixel slots a round (256 pixels, as the
//     flat tile), each an (image, subtile) pair with a 10x10 halo of its
//     own; warp w owns slot w / 2, rows 4 (w % 2) .. + 3, as two m16
//     fragments of two 8-pixel rows each (ldmatrix takes a row address
//     per lane), and every 8-column tile of the channel tile.  bb picks
//     the pairs as the fp32 blocked kernel does (extractor.cuh,
//     `bk_region`, `bk_blocks`): 512 blocks at b = 32, l = 64 for bb 1, 2
//     and 4, 256 (two rounds each) at bb 8;
//   * per channel tile the block stages the B fragments of its 8-column
//     tiles for all nine taps once (cp.async; 36,864 B at 64 -> 64, ct =
//     64) and reuses them for every round; `db` (ct < C) prefetches the
//     next tile's fragments into a second buffer while this tile runs.  A
//     ct of 4 computes its 8-column tile and keeps its half;
//   * ct = C: each round stages its pre-norm rows over the halo and runs
//     the flat epilogue (one thread a pixel).  ct < C: each pass writes
//     its columns to an fp32 (b, l, l, C) scratch (the reference's (M, C)
//     accumulator; the halo stays resident across passes where a block
//     has one round), and after the last pass the block reads its pixels'
//     rows back into shared memory and runs the same epilogue.
// Idle slots of a ragged last block load no halo and write nothing.
// Shared memory at 64 -> 64: the staged rows 66,560 B (the halos, 32,000
// B, and their scales, 1,600 B, under them), the column scales, one or
// two slices of fragments (36,864 B at ct = 64, 18,432 at ct = 32): two
// blocks an SM (every instantiation takes at most 128 registers).
#include "extractor.cuh"

namespace qr {

constexpr float kInvQmax = 0x1.020408p-7f;  // float(1/127)
constexpr float kQEps = 1e-8f;

// ---- the int8 quantize, shared by layer 0's halo and every epilogue -----
// s = max(amax, 1e-8) * float(1/127)
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, kQEps), kInvQmax);
}

// q = clip(rint(v / s), +-127) as a byte (rintf rounds half to even, as
// jnp.round)
__device__ __forceinline__ unsigned quant_byte(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (unsigned)(uint8_t)(int8_t)(int)r;
}

// quant_byte(v, s) for |v| <= amax, with rs = __frcp_rn(s): the division
// replaced by a product wherever that cannot change the byte.  |v / s| <=
// 127.00002, so x = v rs lies within 2.3e-5 of the rounded quotient, and
// rint(x) is rint(v / s) unless x lies within 2^-14 of a half-integer,
// where __fdiv_rn decides.
__device__ __forceinline__ unsigned quant_byte_rcp(float v, float s,
                                                   float rs) {
  const float x = __fmul_rn(v, rs);
  float r = rintf(x);
  if (fabsf(__fsub_rn(x, r)) > 0.5f - 0x1p-14f) r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return (unsigned)(uint8_t)(int8_t)(int)r;
}

// ---- the tensor-core engine ------------------------------------------------
constexpr int IT = 16;               // a block's pixel tile is IT x IT
constexpr int IHW = IT + 2;          // halo side
constexpr int ITHREADS = 256;        // 8 warps; warp w: pixel rows 2w, 2w + 1
constexpr int kMagic = 0x4B400000;   // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;

// Geometry of an input of CIN channels: CW words a pixel in memory, KS
// k-steps of 32 channels, KW = 8 KS words the dot reads a pixel (the
// words past CW zero), P words a halo pixel.
template <int CIN>
struct Geo {
  static constexpr int CW = (CIN + 3) / 4;
  static constexpr int KS = (CW + 7) / 8;
  static constexpr int KW = 8 * KS;
  static constexpr int P = KW + 4;
};

// Shared memory of a kernel at CIN input channels, NT 8-column tiles and
// an epilogue of EPI bytes (over the rest): the weight fragments of the
// nine taps, the halo, the halo pixels' scales, the column scales.
// Offsets in bytes, 16-byte aligned.
template <int CIN, int NT, int EPI>
struct ISmem {
  using G = Geo<CIN>;
  static constexpr int WTAP = G::KS * NT * 32;  // int2 per tap
  static constexpr int W = 0;
  static constexpr int HALO = W + 9 * WTAP * 8;
  static constexpr int SC = HALO + IHW * IHW * G::P * 4;
  static constexpr int WS = SC + ((IHW * IHW * 4 + 15) & ~15);
  static constexpr int CONV = WS + NT * 8 * 4;
  static constexpr int END = CONV > EPI ? CONV : EPI;
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       int2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The HW x HW halo of the pixel tile whose first pixel is (y0, x0) of
// image img (the flat tile's 18 x 18, a blocked slot's 10 x 10), rows HW
// pixels apart, and its pixels' scales, zero outside the image (a padding
// pixel's words and scale are 0, so its taps add (0 * 0) * w_scale = +0,
// as the reference's zero rows do).  CIN = 3: x is the fp32 tiles,
// quantized here as they land; else x holds the (b, l, l, CW) words and xs
// the (b, l, l) scales, copied with cp.async into the group the caller
// commits next.
template <int CIN, int HW = IHW>
__device__ __forceinline__ void imma_halo(const void* __restrict__ x,
                                          const float* __restrict__ xs,
                                          int* s_in, float* s_sc,
                                          long long img, int y0, int x0,
                                          int l) {
  using G = Geo<CIN>;
  for (int p = threadIdx.x; p < HW * HW; p += blockDim.x) {
    const int gy = y0 + p / HW - 1, gx = x0 + p % HW - 1;
    const bool in = gy >= 0 && gy < l && gx >= 0 && gx < l;
    const long long gp = (img * l + gy) * l + gx;
    int* hp = s_in + p * G::P;
    if constexpr (CIN == 3) {
      float v[3] = {0.f, 0.f, 0.f}, amax = 0.f;
      if (in) {
        for (int c = 0; c < 3; ++c) {
          v[c] = static_cast<const float*>(x)[gp * 3 + c];
          amax = fmaxf(amax, fabsf(v[c]));
        }
      }
      const float sc = quant_scale(amax);
      unsigned word = 0;
      if (in)
        for (int c = 0; c < 3; ++c) word |= quant_byte(v[c], sc) << (8 * c);
      hp[0] = (int)word;
      s_sc[p] = in ? sc : 0.f;
    } else {
      const int* xq = static_cast<const int*>(x);
#pragma unroll
      for (int q = 0; q < G::CW / 4; ++q)
        cp_async16_zfill(hp + 4 * q, in ? xq + gp * G::CW + 4 * q : xq, in);
      s_sc[p] = in ? xs[gp] : 0.f;
    }
#pragma unroll
    for (int k = G::CW; k < G::KW; ++k) hp[k] = 0;
  }
}

// THE tap primitive of the int8 rung, flat and blocked: one tap of the
// warp's two fragment tiles (16 pixels each) x NT 8-column tiles, folded
// into acc (FIRST: tap 0, which starts the sum).  toff: the tap's offset
// in halo pixels (dy * pitch + dx); a_row: this lane's ldmatrix row
// address of fragment 0 at tap 0; s_row: the halo pixel of fragment 0's
// row g at tap 0, its row g + 8 being R8 pixels on; fragment 1 is MSTEP
// halo pixels on from fragment 0; w_lane: this tap's B fragments at this
// lane; s_ws: the scales of the NT column tiles.
template <int CIN, int NT, int R8, int MSTEP, bool FIRST>
__device__ __forceinline__ void imma_tap(int toff, unsigned a_row, int s_row,
                                         const float* s_sc,
                                         const int2* w_lane,
                                         const float* s_ws,
                                         float (&acc)[2][NT][4]) {
  using G = Geo<CIN>;
  const int t = threadIdx.x & 3;
  unsigned a[2][G::KS][4];
  float sx[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int off = toff + m * MSTEP;
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk)
      ldmatrix_x4(a[m][kk], a_row + off * G::P * 4 + 32 * kk);
    sx[m][0] = s_sc[s_row + off];
    sx[m][1] = s_sc[s_row + off + R8];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    int2 b[G::KS];
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) b[kk] = w_lane[(kk * NT + j) * 32];
    const float2 ws = *reinterpret_cast<const float2*>(s_ws + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      int c[4] = {kMagic, kMagic, kMagic, kMagic};
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk) mma_s8(c, a[m][kk], b[kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dot = __fsub_rn(__int_as_float(c[i]), kMagicF);
        const float d = __fmul_rn(__fmul_rn(dot, sx[m][i >> 1]),
                                  (i & 1) ? ws.y : ws.x);
        acc[m][j][i] = FIRST ? d : __fadd_rn(acc[m][j][i], d);
      }
    }
  }
}

// ldmatrix.x4: lane i names row (i & 7) + 8 ((i >> 3) & 1) of the
// fragment's 16 pixels at byte 16 (i >> 4) of the k-step's 32: matrices
// 0..3 are the fragment's a0..a3 (rows 0-7 / 8-15, channels 0-15 / 16-31).
// Row j of a fragment is halo pixel `first + j` (flat: 16 pixels of one
// row) or `first + (j >> 3) * pitch + (j & 7)` (blocked: two 8-pixel rows).
template <int CIN>
__device__ __forceinline__ unsigned lane_row(const int* s_in, int pix) {
  return (unsigned)__cvta_generic_to_shared(s_in) +
         (unsigned)((pix * Geo<CIN>::P + 4 * ((threadIdx.x & 31) >> 4)) * 4);
}

// The nine taps of the flat block's tile into acc[m][j][i]: pixel row 2w
// + m, column tile j, fragment element i (row g + 8 (i / 2) of the 16
// pixels, column 8 j + 2 t + i % 2; g = lane / 4, t = lane % 4).  wf holds
// the nine taps' B fragments (9, KS, NT, 32 lanes) as int2, wscale the NC
// column scales.  Ends with a barrier, after which shared memory is free.
template <int CIN, int NT, int NC, int EPI>
__device__ __forceinline__ void imma_conv(const void* __restrict__ x,
                                          const float* __restrict__ xs,
                                          const int2* __restrict__ wf,
                                          const float* __restrict__ wscale,
                                          char* smem, long long img, int y0,
                                          int x0, int l,
                                          float (&acc)[2][NT][4]) {
  using G = Geo<CIN>;
  using S = ISmem<CIN, NT, EPI>;
  int2* s_w = reinterpret_cast<int2*>(smem + S::W);
  int* s_in = reinterpret_cast<int*>(smem + S::HALO);
  float* s_sc = reinterpret_cast<float*>(smem + S::SC);
  float* s_ws = reinterpret_cast<float*>(smem + S::WS);
  // three groups of three taps' fragments (16-byte chunks), the halo's
  // words with the first
  for (int grp = 0; grp < 3; ++grp) {
    const char* src = reinterpret_cast<const char*>(wf + grp * 3 * S::WTAP);
    char* dst = reinterpret_cast<char*>(s_w + grp * 3 * S::WTAP);
    for (int e = threadIdx.x; e < 3 * S::WTAP / 2; e += blockDim.x)
      cp_async16(dst + 16 * e, src + 16 * e);
    if (grp == 0) imma_halo<CIN>(x, xs, s_in, s_sc, img, y0, x0, l);
    cp_async_commit();
  }
  for (int c = threadIdx.x; c < NT * 8; c += blockDim.x)
    s_ws[c] = c < NC ? wscale[c] : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // fragment m: pixel row 2w + m, halo row 2w + m at tap 0
  const int first = 2 * warp * IHW;
  const unsigned a_row =
      lane_row<CIN>(s_in, first + (lane & 7) + 8 * ((lane >> 3) & 1));
  const int s_row = first + (lane >> 2);
  const int2* w_lane = s_w + lane;
  cp_async_wait<2>();  // the halo and taps 0-2 have landed
  __syncthreads();
  imma_tap<CIN, NT, 8, IHW, true>(0, a_row, s_row, s_sc, w_lane, s_ws, acc);
#pragma unroll 1
  for (int tap = 1; tap < 9; ++tap) {
    if (tap == 3 || tap == 6) {  // the next group of taps has landed
      if (tap == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    imma_tap<CIN, NT, 8, IHW, false>(tap / 3 * IHW + tap % 3, a_row, s_row,
                                     s_sc, w_lane + tap * S::WTAP, s_ws, acc);
  }
  __syncthreads();
}

// The block's tile (img, y0, x0) for blockIdx.x: b * (l / IT)^2 blocks.
struct ITile {
  long long img;
  int by, bx, y0, x0;
  __device__ ITile(int l) {
    const int tiles_x = l / IT;
    img = blockIdx.x / (tiles_x * tiles_x);
    const int t = blockIdx.x % (tiles_x * tiles_x);
    by = t / tiles_x;
    bx = t % tiles_x;
    y0 = by * IT;
    x0 = bx * IT;
  }
};

// element i of fragment tile (m, j): its pixel among the block's 256
// (the flat tile's row-major order; the blocked slots' slot-major, each
// row-major, so that warp w's fragments are pixels 32 w .. 32 w + 31 in
// both) and its column
__device__ __forceinline__ int frag_pixel(int m, int i) {
  return (2 * (threadIdx.x >> 5) + m) * IT + ((threadIdx.x & 31) >> 2) +
         8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int j, int i) {
  return 8 * j + 2 * (threadIdx.x & 3) + (i & 1);
}

// the warp's pre-norm fragments into the staged rows (pitch SP)
template <int NT, int SP>
__device__ __forceinline__ void stage_pre(float* s_pre,
                                          const float (&acc)[2][NT][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_pre[frag_pixel(m, i) * SP + frag_col(j, i)] = acc[m][j][i];
}

// The hidden block's epilogue on one pixel's staged pre-norm row: bias,
// channel_norm and ReLU, the operations of `norm_relu_to` in its order
// (the row held in registers, so (pre + bias) is formed once), then the
// quantize of `quantize_rows_int8` (its amax as four partial maxima, exact
// in any order; the bytes by quant_byte_rcp): writes the words to qo,
// returns the scale.
template <int COUT>
__device__ __forceinline__ float norm_relu_quantize(
    const float* row, const float* __restrict__ bias, int4* qo) {
  float u[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) u[co] = __fadd_rn(row[co], bias[co]);
  float sum = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) sum = __fadd_rn(sum, u[co]);
  const float mu = __fdiv_rn(sum, (float)COUT);
  float ss = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    const float d = __fsub_rn(u[co], mu);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(ss, (float)COUT);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  float am[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    u[co] = fmaxf(__fmul_rn(__fsub_rn(u[co], mu), rs), 0.f);
    am[co & 3] = fmaxf(am[co & 3], fabsf(u[co]));
  }
  const float sc = quant_scale(fmaxf(fmaxf(am[0], am[1]), fmaxf(am[2], am[3])));
  const float rsc = __frcp_rn(sc);
#pragma unroll
  for (int v = 0; v < COUT / 16; ++v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[k] |= quant_byte_rcp(u[16 * v + 4 * k + j], sc, rsc) << (8 * j);
    }
    qo[v] = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
  return sc;
}

// the hidden block's epilogue: the staged (IT^2, COUT + 1) pre-norm tile
template <int COUT>
constexpr int kHiddenEpi = IT * IT * (COUT + 1) * 4;

// One hidden block, int8 flat schedule: SAME 3x3 conv + bias +
// channel_norm + ReLU, quantized: q_out (b, l, l, COUT / 4) words and
// s_out (b, l, l) scales.  Grid b * (l / 16)^2, 256 threads.
template <int CIN, int COUT>
__global__ void __launch_bounds__(ITHREADS, 2)
conv_imma_kernel(const void* __restrict__ x, const float* __restrict__ xs,
                 const int2* __restrict__ wf,
                 const float* __restrict__ wscale,
                 const float* __restrict__ bias, int* __restrict__ q_out,
                 float* __restrict__ s_out, int l) {
  constexpr int NT = COUT / 8, SP = COUT + 1;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ITile tl(l);
  float acc[2][NT][4];
  imma_conv<CIN, NT, COUT, kHiddenEpi<COUT>>(
      x, xs, wf, wscale, smem, tl.img, tl.y0, tl.x0, l, acc);
  float* s_pre = reinterpret_cast<float*>(smem);
  stage_pre<NT, SP>(s_pre, acc);
  __syncthreads();
  // one thread a pixel
  const int p = threadIdx.x;
  const long long gp = (tl.img * l + tl.y0 + p / IT) * l + tl.x0 + p % IT;
  s_out[gp] = norm_relu_quantize<COUT>(
      s_pre + p * SP, bias, reinterpret_cast<int4*>(q_out + gp * (COUT / 4)));
}

constexpr int kToBitsEpi = IT * IT * (60 + 1) * 4 + IT * IT * 3 * 4;

// to_bits, int8 (both schedules): the conv + bias at 60 columns (64 in
// the engine), reduced into the GAP partials and, with the correlation
// bank, the highpass(tiles) . corr partials of the two 8x16 tiles the
// block covers, as gap_corr_regtile_kernel writes them.
template <int CIN>
__global__ void __launch_bounds__(ITHREADS, 2)
gap_corr_imma_kernel(const int* __restrict__ xq, const float* __restrict__ xs,
                     const int2* __restrict__ wf,
                     const float* __restrict__ wscale,
                     const float* __restrict__ bias,
                     const float* __restrict__ tiles_in,
                     const float* __restrict__ corr,
                     float* __restrict__ part_gap,
                     float* __restrict__ part_corr, int l, int has_corr) {
  constexpr int NB = 60, NT = 8, SR = NB + 1;
  static_assert(IT == RT, "the to_bits epilogue covers a 16x16 tile");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ITile tl(l);
  float acc[2][NT][4];
  imma_conv<CIN, NT, NB, kToBitsEpi>(xq, xs, wf, wscale, smem, tl.img,
                                     tl.y0, tl.x0, l, acc);
  float* s_red = reinterpret_cast<float*>(smem);
  float* s_hp = s_red + IT * IT * SR;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = frag_col(j, i);
        if (col < NB)
          s_red[frag_pixel(m, i) * SR + col] = __fadd_rn(acc[m][j][i],
                                                         bias[col]);
      }
  if (has_corr) rt_highpass<float>(tiles_in, s_hp, tl.img, tl.y0, tl.x0, l);
  __syncthreads();
  rt_gap_corr_partials<float>(s_red, s_hp, corr, part_gap, part_corr, tl.img,
                              tl.by, tl.bx, l, has_corr);
}

// ---- blocked schedule ------------------------------------------------------
// Shared memory of the blocked kernel at CIN input channels, COUT output
// columns and channel tile CT: the four slot halos and their pixels'
// scales, under the staged (256, COUT + 1) pre-norm rows; the COUT column
// scales; one weight slice, or two with db (ct < C).  A slice is the B
// fragments of the tile's NT 8-column tiles, all nine taps.  Offsets in
// bytes, 16-byte aligned.
template <int CIN, int COUT, int CT>
struct BkI {
  using G = Geo<CIN>;
  static constexpr int NT = (CT + 7) / 8;  // 8-column tiles a pass
  static constexpr int NJ = COUT / CT;     // passes (channel tiles)
  static constexpr int SLOT = BHW * BHW;   // pixels of a slot's halo
  static constexpr int SC = BSLOTS * SLOT * G::P * 4;
  static constexpr int HALO_END = SC + BSLOTS * SLOT * 4;
  static constexpr int STAGE = BSLOTS * BS * BS * (COUT + 1) * 4;
  static constexpr int WS =
      ((HALO_END > STAGE ? HALO_END : STAGE) + 15) & ~15;
  static constexpr int W = WS + COUT * 4;
  static constexpr int SLICE = 9 * G::KS * NT * 32;  // int2 of a slice
  static constexpr int END1 = W + SLICE * 8;             // one slice
  static constexpr int END2 = W + (NJ > 1 ? 2 : 1) * SLICE * 8;  // db
  // two blocks an SM: 228 KB of shared memory, 1 KB of it kept a block
  static_assert(W % 16 == 0 && 2 * (END2 + 1024) <= 233472,
                "two blocks an SM");
};

// A channel tile's slice: the B fragments of the NT 8-column tiles from
// nt0 on, of all nine taps ((9, KS, ntt, 32) int2 in global memory), into
// s_w (9, KS, NT, 32), with cp.async.
template <int CIN, int NT>
__device__ __forceinline__ void stage_fragments(const int2* __restrict__ wf,
                                                int2* s_w, int ntt, int nt0) {
  constexpr int RUN = NT * 32 * 8 / 16;  // 16-byte chunks of a (tap, k-step)
  for (int e = threadIdx.x; e < 9 * Geo<CIN>::KS * RUN; e += blockDim.x) {
    const int tk = e / RUN, c = e % RUN;
    cp_async16(reinterpret_cast<char*>(s_w + tk * NT * 32) + 16 * c,
               reinterpret_cast<const char*>(wf + (tk * ntt + nt0) * 32) +
                   16 * c);
  }
}

// One hidden block at int8 on the blocked schedule (see the header): grid
// bk_blocks(b, l, bb), 256 threads.  x / xs, q_out / s_out as
// conv_imma_kernel's; wf the layer's fragments (9, KS, COUT / 8, 32) int2,
// wscale its COUT column scales; scratch the fp32 (b, l, l, COUT)
// pre-norm scratch of ct < C (unused at ct = C).  Layer 0 asks for one
// block an SM: with two, ptxas spilled 16 B at <3, 64, 64>; with one it
// allocates the same 128 registers and spills nothing, so two blocks
// still fit an SM.
template <int CIN, int COUT, int CT>
__global__ void __launch_bounds__(ITHREADS, CIN == 3 ? 1 : 2)
conv_blocked_imma_kernel(const void* __restrict__ x,
                         const float* __restrict__ xs,
                         const int2* __restrict__ wf,
                         const float* __restrict__ wscale,
                         const float* __restrict__ bias,
                         int* __restrict__ q_out, float* __restrict__ s_out,
                         float* __restrict__ scratch, int b, int l, int bb,
                         int db) {
  using G = Geo<CIN>;
  using K = BkI<CIN, COUT, CT>;
  constexpr int NT = K::NT, NJ = K::NJ, SP = COUT + 1;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  int* s_in = reinterpret_cast<int*>(smem);
  float* s_sc = reinterpret_cast<float*>(smem + K::SC);
  float* s_pre = reinterpret_cast<float*>(smem);
  float* s_ws = reinterpret_cast<float*>(smem + K::WS);
  int2* s_w0 = reinterpret_cast<int2*>(smem + K::W);
  const bool two = db && NJ > 1;
  // the block's images and region; a round's slot s holds pair
  // p = r * BSLOTS + s: image img0 + p / q, subtile p % q of the region
  const int q = bk_region(bb), qw = q == 1 ? 1 : 2, qh = q == 4 ? 2 : 1;
  const int rcols = l / (BS * qw), regions = rcols * (l / (BS * qh));
  const int img0 = blockIdx.x / regions * bb, reg = blockIdx.x % regions;
  const int ry0 = reg / rcols * BS * qh, rx0 = reg % rcols * BS * qw;
  const int pairs = min(bb, b - img0) * q;
  const int rounds = (pairs + BSLOTS - 1) / BSLOTS;
  // false for an idle slot of a ragged last block
  auto origin = [&](int p, long long& img, int& y0, int& x0) {
    img = img0 + p / q;
    y0 = ry0 + (p % q) / qw * BS;
    x0 = rx0 + (p % q) % qw * BS;
    return p < pairs;
  };
  auto halos = [&](int r) {  // issue the round's halo copies
    for (int s = 0; s < BSLOTS; ++s) {
      long long img;
      int y0, x0;
      if (origin(r * BSLOTS + s, img, y0, x0))
        imma_halo<CIN, BHW>(x, xs, s_in + s * K::SLOT * G::P,
                            s_sc + s * K::SLOT, img, y0, x0, l);
    }
  };
  for (int c = threadIdx.x; c < COUT; c += blockDim.x) s_ws[c] = wscale[c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp >> 1;
  // the epilogue of round r, one thread a pixel of the staged rows
  auto finish = [&](int r) {
    const int p = threadIdx.x;
    long long img;
    int y0, x0;
    if (origin(r * BSLOTS + p / (BS * BS), img, y0, x0)) {
      const long long gp =
          (img * l + y0 + p % (BS * BS) / BS) * l + x0 + p % BS;
      s_out[gp] = norm_relu_quantize<COUT>(
          s_pre + p * SP, bias,
          reinterpret_cast<int4*>(q_out + gp * (COUT / 4)));
    }
  };
  if (two) {
    stage_fragments<CIN, NT>(wf, s_w0, COUT / 8, 0);
    cp_async_commit();
  }
  float acc[2][NT][4];
  for (int jt = 0; jt < NJ; ++jt) {
    const int nt0 = jt * CT / 8;  // the tile's first 8-column tile
    const int2* w_lane = s_w0 + (two ? (jt & 1) * K::SLICE : 0) + lane;
    if (!two) {
      __syncthreads();  // every thread is done with slice jt - 1
      stage_fragments<CIN, NT>(wf, s_w0, COUT / 8, nt0);
      cp_async_commit();
    }
    for (int r = 0; r < rounds; ++r) {
      const bool fresh = jt == 0 || rounds > 1;  // else the halo stays
      const bool prefetch = two && jt + 1 < NJ && r == 0;
      if (fresh || prefetch) __syncthreads();  // done with what is refilled
      if (fresh) {
        halos(r);
        cp_async_commit();
      }
      if (prefetch) {  // the next tile's slice, into the other buffer
        stage_fragments<CIN, NT>(wf, s_w0 + ((jt + 1) & 1) * K::SLICE,
                                 COUT / 8, (jt + 1) * CT / 8);
        cp_async_commit();
        cp_async_wait<1>();  // all but the prefetch have landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // warp w: slot w / 2; fragment m: slot rows 4 (w % 2) + 2 m and + 1
      const int first = slot * K::SLOT + 4 * (warp & 1) * BHW;
      const unsigned a_row = lane_row<CIN>(
          s_in, first + ((lane >> 3) & 1) * BHW + (lane & 7));
      const int s_row = first + (lane >> 2);
      imma_tap<CIN, NT, BHW, 2 * BHW, true>(0, a_row, s_row, s_sc, w_lane,
                                            s_ws + 8 * nt0, acc);
#pragma unroll 1
      for (int tap = 1; tap < 9; ++tap)
        imma_tap<CIN, NT, BHW, 2 * BHW, false>(
            tap / 3 * BHW + tap % 3, a_row, s_row, s_sc,
            w_lane + tap * G::KS * NT * 32, s_ws + 8 * nt0, acc);
      if constexpr (NJ == 1) {  // the pre-norm rows over the halo
        __syncthreads();        // every thread is done with the halo
        stage_pre<NT, SP>(s_pre, acc);
        __syncthreads();
        finish(r);
      } else {  // pass jt's columns to the scratch
        long long img;
        int y0, x0;
        if (origin(r * BSLOTS + slot, img, y0, x0)) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // fragment row g + 8 h
                const int col = 8 * (nt0 + j) + 2 * (lane & 3);
                if (col / CT != jt) continue;  // ct 4: the other half
                const int row = 4 * (warp & 1) + 2 * m + h;
                const long long gp =
                    (img * l + y0 + row) * l + x0 + (lane >> 2);
                *reinterpret_cast<float2*>(scratch + gp * COUT + col) =
                    make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
              }
        }
      }
    }
  }
  if constexpr (NJ > 1) {  // read each round's rows back, then normalise
    for (int r = 0; r < rounds; ++r) {
      __syncthreads();  // every pass is written; the staged rows are free
      for (int e = threadIdx.x; e < BSLOTS * BS * BS * (COUT / 4);
           e += blockDim.x) {
        const int p = e / (COUT / 4), c4 = e % (COUT / 4);
        long long img;
        int y0, x0;
        if (!origin(r * BSLOTS + p / (BS * BS), img, y0, x0)) continue;
        const long long gp =
            (img * l + y0 + p % (BS * BS) / BS) * l + x0 + p % BS;
        const float4 v =
            *reinterpret_cast<const float4*>(scratch + gp * COUT + 4 * c4);
        float* d = s_pre + p * SP + 4 * c4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      __syncthreads();
      finish(r);
    }
  }
}

template <int CIN, int COUT>
int conv_imma(const void* x, const float* xs, const int2* wf,
              const float* wscale, const float* bias, int* q, float* s,
              int b, int l, cudaStream_t stream) {
  constexpr int smem = ISmem<CIN, COUT / 8, kHiddenEpi<COUT>>::END;
  cudaError_t err = set_smem(conv_imma_kernel<CIN, COUT>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_imma_kernel<CIN, COUT><<<b * (l / IT) * (l / IT), ITHREADS, smem,
                                stream>>>(x, xs, wf, wscale, bias, q, s, l);
  return (int)cudaGetLastError();
}

template <int CIN>
int gap_corr_imma(const int* xq, const float* xs, const int2* wf,
                  const float* wscale, const float* bias, const float* tiles,
                  const float* corr, float* part_gap, float* part_corr,
                  int b, int l, int has_corr, cudaStream_t stream) {
  constexpr int smem = ISmem<CIN, 8, kToBitsEpi>::END;
  cudaError_t err = set_smem(gap_corr_imma_kernel<CIN>, smem);
  if (err != cudaSuccess) return (int)err;
  gap_corr_imma_kernel<CIN><<<b * (l / IT) * (l / IT), ITHREADS, smem,
                              stream>>>(xq, xs, wf, wscale, bias, tiles,
                                        corr, part_gap, part_corr, l,
                                        has_corr);
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, int CT>
int conv_blocked_imma(const void* x, const float* xs, const int2* wf,
                      const float* wscale, const float* bias, int* q,
                      float* s, float* scratch, int b, int l, int bb, int db,
                      cudaStream_t stream) {
  using K = BkI<CIN, COUT, CT>;
  if (K::NJ > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(conv_blocked_imma_kernel<CIN, COUT, CT>,
                             K::END2);
  if (err != cudaSuccess) return (int)err;
  const int smem = db && K::NJ > 1 ? K::END2 : K::END1;
  conv_blocked_imma_kernel<CIN, COUT, CT>
      <<<bk_blocks(b, l, bb), ITHREADS, smem, stream>>>(
          x, xs, wf, wscale, bias, q, s, scratch, b, l, bb, db);
  return (int)cudaGetLastError();
}

}  // namespace qr

// One hidden block at int8 on the flat schedule.  x: the (b, l, l, 3)
// fp32 tiles (cin 3) or the (b, l, l, cin / 4) int32 words of the layer
// before, with its (b, l, l) scales xs; wf: the layer's weight fragments
// (9, KS, cout / 8, 32, 2) int32; wscale (cout) fp32.  Writes q
// (b, l, l, cout / 4) words and s (b, l, l) scales.  cin in
// {3, 16, 32, 64}, cout in {16, 32, 64}, l a multiple of 16; every
// pointer 16-byte aligned.
extern "C" int qr_conv3x3_imma(const void* x, const void* xs, const void* wf,
                               const void* wscale, const void* bias, void* q,
                               void* s, int b, int l, int cin, int cout,
                               void* stream) {
  if (l % qr::IT) return (int)cudaErrorInvalidValue;
  const float *xsf = (const float*)xs, *sf = (const float*)wscale,
              *bf = (const float*)bias;
  const int2* w = (const int2*)wf;
  cudaStream_t st = (cudaStream_t)stream;
#define QR_IMMA(CI, CO)                                                    \
  if (cin == CI && cout == CO)                                             \
    return qr::conv_imma<CI, CO>(x, xsf, w, sf, bf, (int*)q, (float*)s, b, \
                                 l, st);
  QR_IMMA(3, 16) QR_IMMA(3, 32) QR_IMMA(3, 64)
  QR_IMMA(16, 16) QR_IMMA(16, 32) QR_IMMA(16, 64)
  QR_IMMA(32, 16) QR_IMMA(32, 32) QR_IMMA(32, 64)
  QR_IMMA(64, 16) QR_IMMA(64, 32) QR_IMMA(64, 64)
#undef QR_IMMA
  return (int)cudaErrorInvalidValue;
}

// One hidden block at int8 on the blocked schedule: x, xs, wf, wscale,
// bias, q and s as qr_conv3x3_imma's; scratch an fp32 (b, l, l, cout)
// buffer, used (and required) when ct < cout.  cout in {16, 32, 64}, cin
// 3 or cout, ct a multiple of 4 dividing cout, bb >= 1, l a multiple of
// 16.
extern "C" int qr_conv3x3_imma_blocked(const void* x, const void* xs,
                                       const void* wf, const void* wscale,
                                       const void* bias, void* q, void* s,
                                       void* scratch, int b, int l, int cin,
                                       int cout, int bb, int ct, int db,
                                       void* stream) {
  if (l % 16 || bb < 1) return (int)cudaErrorInvalidValue;
  const float *xsf = (const float*)xs, *sf = (const float*)wscale,
              *bf = (const float*)bias;
  const int2* w = (const int2*)wf;
  int* qi = (int*)q;
  float *sp = (float*)s, *scr = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
#define QR_BLOCKED_IMMA(CO, CTV)                                             \
  if (cout == CO && ct == CTV) {                                             \
    if (cin == 3)                                                            \
      return qr::conv_blocked_imma<3, CO, CTV>(x, xsf, w, sf, bf, qi, sp,    \
                                               scr, b, l, bb, db, st);       \
    if (cin == CO)                                                           \
      return qr::conv_blocked_imma<CO, CO, CTV>(x, xsf, w, sf, bf, qi, sp,   \
                                                scr, b, l, bb, db, st);      \
  }
  QR_BLOCKED_IMMA(16, 16) QR_BLOCKED_IMMA(16, 8) QR_BLOCKED_IMMA(16, 4)
  QR_BLOCKED_IMMA(32, 32) QR_BLOCKED_IMMA(32, 16) QR_BLOCKED_IMMA(32, 8)
  QR_BLOCKED_IMMA(32, 4)
  QR_BLOCKED_IMMA(64, 64) QR_BLOCKED_IMMA(64, 32) QR_BLOCKED_IMMA(64, 16)
  QR_BLOCKED_IMMA(64, 8) QR_BLOCKED_IMMA(64, 4)
#undef QR_BLOCKED_IMMA
  return (int)cudaErrorInvalidValue;
}

// to_bits + GAP + corr at int8 (both schedules): xq / xs the last hidden
// block's words and scales; wf the to_bits fragments (9, KS, 8, 32, 2)
// int32 (60 columns padded to 64), wscale (60).  n_bits == 60, cin in
// {16, 32, 64}; corr and part_corr may be null when has_corr is 0.
extern "C" int qr_conv3x3_gap_corr_imma(const void* xq, const void* xs,
                                        const void* wf, const void* wscale,
                                        const void* bias, const void* tiles,
                                        const void* corr, void* part_gap,
                                        void* part_corr, int b, int l,
                                        int cin, int n_bits, int has_corr,
                                        void* stream) {
  if (l % qr::IT || n_bits != 60) return (int)cudaErrorInvalidValue;
  const int* q = (const int*)xq;
  const float *xsf = (const float*)xs, *sf = (const float*)wscale,
              *bf = (const float*)bias, *tf = (const float*)tiles,
              *cf = (const float*)corr;
  const int2* w = (const int2*)wf;
  float *pg = (float*)part_gap, *pc = (float*)part_corr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cin) {
    case 16: return qr::gap_corr_imma<16>(q, xsf, w, sf, bf, tf, cf, pg, pc,
                                          b, l, has_corr, st);
    case 32: return qr::gap_corr_imma<32>(q, xsf, w, sf, bf, tf, cf, pg, pc,
                                          b, l, has_corr, st);
    case 64: return qr::gap_corr_imma<64>(q, xsf, w, sf, bf, tf, cf, pg, pc,
                                          b, l, has_corr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
