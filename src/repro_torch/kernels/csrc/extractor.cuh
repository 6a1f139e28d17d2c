// Extractor decode: the conv stack, to_bits, GAP, head and correlation bank
// that turn (b, l, l, 3) tiles into (b, n_bits) bit logits (and, on
// request, the (b, n_bits) GAP embedding), at the three rungs of the
// reference's precision ladder.  Templates shared by the three sources
// fused_extractor.cu (fp32 and the C entry points), fused_extractor_bf16.cu
// and fused_extractor_int8.cu, each of which instantiates one rung, so
// nvcc builds the rungs in parallel.
//
// Replaces the Pallas kernels `fused_extractor`
// (src/repro/kernels/fused_extractor.py:82, pallas_call at :113) and
// `fused_extractor_blocked` (:149, pallas_call at :257).  Their grid step
// runs the shared body `extractor_forward_packed_embed`
// (src/repro/core/extractor.py:273): D SAME 3x3 conv blocks as nine tap
// dots in static [ky, kx] order + bias + channel_norm + ReLU, the to_bits
// 3x3 conv, GAP, the head as broadcast-multiply + sum, and
// highpass(tiles) . corr summed over (pixel, channel) x corr_scale.  The
// packed dtype picks the rung (the reference's `tap_dot`,
// src/repro/core/extractor.py:140):
//
//   fp32  fp32 tap dots;
//   bf16  tap-dot inputs and weights rounded to bf16, exact products, fp32
//         sums (the weights stay bf16 in memory; a block rounds the fp32
//         activations as its halo lands, so the fp32 FFMA chain runs on
//         exactly representable products); head and correlation: fp32
//         products of bf16-rounded operands (the jitted reference keeps
//         them at fp32; the highpass is computed in fp32, then rounded);
//   int8  each tap's input row (one input pixel's cin channels, zero for
//         padding) quantized per row, an exact int8 x int8 -> int32 dot,
//         dequantized as (y * s_row) * w_scale[co] and folded into the
//         fp32 sum; head and correlation fp32.
//
// The per-output arithmetic is one chain at every rung and in every
// kernel here, which is what keeps the flat and the blocked schedules
// bitwise equal and a row's logits independent of its batch: for each
// output (pixel, column) and each tap, a fresh partial over the input
// channels in order (`rt_tap`'s chain: 0, then fmaf over ci; int8: the
// exact dot, dequantized), folded into the accumulator over the taps in
// [ky, kx] order with __fadd_rn; then `norm_relu` (bias, channel_norm with
// sums in channel order, ReLU) or, for to_bits, (y + bias) summed per 8x16
// pixel tile in row-major order.  No split-K, no TF32, no reassociation.
//
// What bounds it on the H100: operations.  At l=64, C=64, D=7 one image
// costs ~2.1 GFLOP.  A 64->64 hidden block at b=32 is 9.73 GFLOP, 0.145 ms
// at the 67 TFLOP/s FFMA peak; to_bits + GAP + corr 9.08 GFLOP, 0.136 ms.
// Layer 0 (cin = 3) is bound by bytes: 35 MB (its 64-channel output) at
// 3.35 TB/s, 0.0105 ms.  The fp32 rung runs on FFMA, bf16 runs the fp32
// FFMA chain on rounded operands (its tensor-core bound, 989 TFLOP/s, is
// not used yet); the int8 rung takes its tap dots on the int8 tensor
// cores (1979 TOP/s), see fused_extractor_int8.cu.
//
// Activations go through global memory between layers: fp32 at the fp32
// and bf16 rungs; int8 words and one fp32 scale a pixel at the int8 rung,
// on both schedules.  One image's fp32 activation
// is 1 MiB at l=64, C=64, more than an SM's 227 KB of shared memory, so
// the TPU's whole-forward-per-step fusion does not carry over.  One
// direct-conv kernel per layer, then to_bits (which also reduces its
// tile's GAP and correlation partials) and a small head kernel that sums
// the partials per image in tile order.
//
// Flat schedule, fp32 and bf16 (`conv_regtile_kernel`,
// `gap_corr_regtile_kernel`): a register-tiled direct conv.  What held the
// first, one-thread-per-pixel design at 20 % of the FFMA peak was shared
// memory issue (each input channel cost one LDS.32 of the activation and
// C/4 LDS.128 weight broadcasts for C FFMA: 17 loads per 64 FFMA at
// C=64), a barrier pair around every tap's weights with nothing in flight
// across it, and 128-pixel blocks that refetched a layer's 147 KB of
// weights 1024 times.  The redesign:
//   * a block owns a 16x16 pixel tile of one image and every output column
//     (to_bits: 60 columns, zero-padded to 64 in shared memory; the
//     padding columns are computed and dropped, they enter no sum);
//   * a thread owns TM = 8 pixels of one row (columns px0 + 2m) x TN = 8
//     columns (two float4 groups, interleaved between the block's column
//     groups so a warp's weight loads hit distinct banks).  The halo keeps
//     a pixel's input channels contiguous (pitch cin + 4, rows of 20
//     pixels, so the pixels a warp loads at once fall in distinct bank
//     quads): per four input channels a thread issues 8 LDS.128 of
//     activations and 8 LDS.128 of weights for 256 FFMA (16 FFMA per
//     shared load; was 3.8).  The partial and the accumulator are 2 x 64
//     registers indexed only by compile-time constants.  The sizes are
//     measured (tools/torch_regtile_sweep.py; 4 x 16, 4 x 8, 2 x 16 and
//     unrolls of 1, 2 and 4 were slower);
//   * the halo is fetched once per block with cp.async (zero-fill for the
//     SAME padding; bf16 rounds it in place once it has landed; layer 0's
//     12-byte pixels are loaded synchronously), and the taps' weights
//     stream through a three-slot ring with cp.async, two taps ahead, so
//     each tap costs one barrier and the next tap's copy is always in
//     flight;
//   * the epilogue stages the pre-norm tile in shared memory (pitch C + 1),
//     runs `norm_relu` with one thread per pixel in channel order, and
//     writes the tile out coalesced; to_bits stages (y + bias) and has 120
//     threads sum the two 8x16 GAP partials and 120 more the correlation
//     partials, each in the fixed row-major order.
// Shared memory at C=64: halo 97,920 B + ring 49,152 B, one block (8 warps)
// per SM.  Layer 0 (cin = 3) runs the same engine; its work is small and
// its output bytes bound it.
//
// int8: the tensor-core kernels of fused_extractor_int8.cu, flat
// (`conv_imma_kernel`, `gap_corr_imma_kernel`) and blocked
// (`conv_blocked_imma_kernel`), which quantize each layer's output in
// their epilogue, so no int8 path runs a quantize pass.
//
// Blocked schedule, `conv_blocked_kernel`: the same forward re-blocked by
// a schedule (batch block bb, output-channel tile ct, double_buffer) whose
// output is bitwise the flat kernels' at every rung.  On the TPU the
// schedule sizes VMEM scratch and grid steps; here it sets how often a
// block stages a weight slice and which images share it.  The to_bits
// conv, GAP, correlation and head run the flat schedule's kernels (n_bits
// is always one full-width tile, as in the reference).
//
// fp32 and bf16 (`conv_blocked_rt`) run the flat kernels' register-tiled
// engine: `rt_tap` on a halo of pitch rt_pitch(cin), rounded to bf16 in
// place, so every output goes through the flat kernels' chain on the same
// staged values and blocked == flat holds by construction.  The first
// design (one thread a pixel with acc[ct], each input channel one shared
// load of the activation and ct / 4 of weights) held the flat kernel at 20
// % of the FFMA peak, spilled at every ct < C, and put one 16x16 tile of bb
// images on a block: 64 blocks on 132 SMs at bb 8, b 32.  Now:
//   * a block computes four 8x8 pixel slots at a time (256 pixels, as the
//     flat kernel's tile); a thread owns one slot row of BTM = 8 pixels x
//     8 columns at ct = 64, x 4 at ct <= 32 (so ct 32 still runs 8 warps),
//     32 * ct / 8 or 32 * ct / 4 threads;
//   * bb picks the (image, 8x8 subtile) pairs that fill the slots, round
//     after round: bb >= 4, one 8x8 subtile of bb images, four a round;
//     bb 2-3, an 8x16 region of bb images, two a round; bb 1, a 16x16
//     region of one image.  The grid, ceil(b / bb) * (l / 8)^2 / (subtiles
//     a region), is 512 blocks at b = 32, l = 64 for bb 1, 2 and 4, and
//     256 at bb 8;
//   * for each output-channel tile [jt * ct, (jt + 1) * ct) a block stages
//     the weight slice of all nine taps once with cp.async and reuses it
//     for every round of its bb images, where it fits beside the halo
//     (bf16 at ct = C, fp32 at ct <= 32; at C <= 32 and layer 0 always).
//     fp32 at ct = C = 64 (147 KB of weights beside a 109 KB halo) streams
//     the taps through the flat kernel's three-slot ring (`rt_ring`) every
//     round, so bb there buys nothing but grid shape.  `db` (ct < C)
//     prefetches the next channel tile's slice with cp.async during the
//     current tile's last round, each tap once every thread is done with
//     the one it replaces;
//   * with ct = C the epilogue is the flat kernel's (the pre-norm tile
//     staged in shared memory, `norm_relu` one thread a pixel, a coalesced
//     write); with ct < C each pass writes its pre-norm columns to the
//     output buffer, as the reference's (M, C) accumulator scratch (the
//     halo stays resident across passes when there is one round), and
//     after the last pass the block normalises its pixels there.
// A ragged batch (bb not dividing b) leaves slots of the last block idle:
// the reference computes zero pad rows and slices them off, which leaves
// the real rows the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace qr {

// ---- rungs -------------------------------------------------------------
// The fp32 and bf16 rungs of the register-tiled engine (the int8 rung is
// fused_extractor_int8.cu's).  W: a packed conv weight in global memory;
// SW: the same weight staged in shared memory; H: the head / correlation
// operands (the int8 rung's head is fp32's).
struct RF32 {
  using W = float;
  using SW = float;
  using H = float;
};
struct RBF16 {
  using W = __nv_bfloat16;
  using SW = __nv_bfloat16;
  using H = __nv_bfloat16;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the precision of T (identity for float)
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive staged weights as floats
__device__ __forceinline__ float4 load_w4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The GAP and correlation partials' pixel tile, TH x TW, at every rung.
constexpr int TH = 8, TW = 16;

// The hidden block's epilogue on one pixel: + bias, channel_norm
// (population variance, sums in channel order), ReLU; store(q, v) takes
// output channels 4q..4q+3.  pre(co) is the pixel's pre-norm conv output
// of channel co: the thread's registers, or what the block staged (flat
// fp32 / bf16: a shared-memory row; blocked, ct < C: what the thread wrote
// to o one channel tile at a time), overwritten in place.  One body for
// every kernel keeps the flat and the blocked kernels bitwise equal.
template <int COUT, class Pre, class Store4>
__device__ __forceinline__ void norm_relu_to(Pre pre,
                                             const float* __restrict__ bias,
                                             Store4 store) {
  float sum = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co)
    sum = __fadd_rn(sum, __fadd_rn(pre(co), bias[co]));
  const float mu = __fdiv_rn(sum, (float)COUT);
  float ss = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    const float d = __fsub_rn(__fadd_rn(pre(co), bias[co]), mu);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(ss, (float)COUT);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  auto out = [&](int co) {
    return fmaxf(__fmul_rn(__fsub_rn(__fadd_rn(pre(co), bias[co]), mu), rs),
                 0.f);
  };
#pragma unroll
  for (int q = 0; q < COUT / 4; ++q)
    store(q, make_float4(out(4 * q), out(4 * q + 1), out(4 * q + 2),
                         out(4 * q + 3)));
}

// ... stored as float4 to o (COUT contiguous floats)
template <int COUT, class Pre>
__device__ __forceinline__ void norm_relu(Pre pre,
                                          const float* __restrict__ bias,
                                          float* o) {
  float4* o4 = reinterpret_cast<float4*>(o);
  norm_relu_to<COUT>(pre, bias, [o4](int q, float4 v) { o4[q] = v; });
}

// ---- cp.async ------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- flat schedule, fp32 and bf16: the register-tiled engine --------------
// (see the header).  A block's RT x RT pixel tile, its halo (RHW pixels
// a side, rows RHP pixels apart), a thread's TM pixels x TN columns, and
// the RSTAGES slots of the weight ring.  A row holds RPG threads' pixel
// groups; a thread's pixel m is RPG * m columns on from its first.
constexpr int RT = 16, RHW = RT + 2, RHP = 20;
// tools/torch_regtile_sweep.py rewrites the next line (and the unroll of
// the channel loop in rt_tap) to build its variants: keep its text.
constexpr int TM = 8, TN = 8, RSTAGES = 3;
constexpr int RPG = RT / TM;

// floats per halo pixel: cin + 4 (layer 0: 4), so a pixel's channels are
// float4-aligned and neighbouring pixels an odd number of bank quads apart
__host__ __device__ constexpr int rt_pitch(int cin) {
  return cin % 4 ? (cin + 3) / 4 * 4 : cin + 4;
}

// Launch shape and shared memory of the engine at NP output columns
// (padded to a multiple of TN) and CIN input channels: the halo, which the
// epilogue reuses, then the weight ring.  Offsets in bytes, 16-byte
// aligned.
template <class R, int NP, int CIN>
struct Rt {
  static_assert(NP % TN == 0, "columns come in groups of TN");
  static constexpr int NCG = NP / TN;  // column groups
  static constexpr int THREADS = RT * RT / TM * NCG;
  static constexpr int SIN = rt_pitch(CIN);
  static constexpr int HALO = RHW * RHP * SIN * 4;
  // the staged (RT^2, NP + 1) rows and the to_bits highpass (RT^2, 3)
  static constexpr int STAGE = RT * RT * (NP + 4) * 4;
  static constexpr int W = ((HALO > STAGE ? HALO : STAGE) + 15) & ~15;
  static constexpr int WTAP = CIN * NP;  // weights in one slot
  static constexpr int END = W + RSTAGES * WTAP * (int)sizeof(typename R::SW);
};

// 16 bytes, or 16 zero bytes when !valid (the SAME padding)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// The (HW x HW) halo of the pixel tile at (y0 + 1, x0 + 1) of image img
// (the flat kernels': 18 x 18 of a 16 x 16 tile; the blocked kernel's: 10
// x 10 of an 8 x 8 slot), zero outside the image: s_in[(hy * HP + hx) *
// SIN + ci], rows HP pixels apart.  cin % 4 == 0 with cp.async (bf16
// rounds it once it has landed, rt_round_halo); layer 0's 12-byte pixels
// synchronously, rounded for bf16.
template <class R, int CIN, int HW = RHW, int HP = RHP>
__device__ __forceinline__ void rt_load_halo(const float* __restrict__ x,
                                             float* s_in, long long img,
                                             int y0, int x0, int l) {
  constexpr int SIN = rt_pitch(CIN);
  const float* xi = x + img * l * l * CIN;
  if constexpr (CIN % 4 == 0) {
    constexpr int Q = CIN / 4;
    for (int e = threadIdx.x; e < HW * HW * Q; e += blockDim.x) {
      const int q = e % Q, p = e / Q;
      const int hy = p / HW, hx = p % HW;
      const int gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool in = gy >= 0 && gy < l && gx >= 0 && gx < l;
      cp_async16_zfill(s_in + (hy * HP + hx) * SIN + 4 * q,
                       in ? xi + ((long long)gy * l + gx) * CIN + 4 * q : xi,
                       in);
    }
  } else {
    for (int e = threadIdx.x; e < HW * HW * CIN; e += blockDim.x) {
      const int c = e % CIN, p = e / CIN;
      const int hy = p / HW, hx = p % HW;
      const int gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (gy >= 0 && gy < l && gx >= 0 && gx < l)
        v = xi[((long long)gy * l + gx) * CIN + c];
      if constexpr (std::is_same<R, RBF16>::value)
        v = round_to<__nv_bfloat16>(v);
      s_in[(hy * HP + hx) * SIN + c] = v;
    }
  }
}

template <int CIN, int HW = RHW, int HP = RHP>
__device__ __forceinline__ void rt_round_halo(float* s_in) {
  constexpr int SIN = rt_pitch(CIN);
  for (int e = threadIdx.x; e < HW * HW * CIN; e += blockDim.x) {
    const int c = e % CIN, p = e / CIN;
    float* v = s_in + ((p / HW) * HP + p % HW) * SIN + c;
    *v = round_to<__nv_bfloat16>(*v);
  }
}

// Tap `tap`'s weights, the CIN rows of the NC columns of the packed
// (9 * CIN, NC) weight, into a ring slot of row pitch NP, with cp.async.
template <class R, int NP, int NC, int CIN>
__device__ __forceinline__ void rt_stage_tap(
    const typename R::W* __restrict__ w, typename R::SW* slot, int tap) {
  using W = typename R::W;
  static_assert(std::is_same<W, typename R::SW>::value, "staged as stored");
  constexpr int ROW = NC * (int)sizeof(W);
  constexpr int CH = ROW % 16 == 0 ? 16 : 8;
  static_assert(ROW % 8 == 0, "weight rows of 8n bytes");
  constexpr int RC = ROW / CH;  // chunks per row
  const char* src =
      reinterpret_cast<const char*>(w + (long long)tap * CIN * NC);
  char* dst = reinterpret_cast<char*>(slot);
  for (int e = threadIdx.x; e < CIN * RC; e += blockDim.x) {
    const int r = e / RC, q = e % RC;
    char* d = dst + r * NP * (int)sizeof(W) + q * CH;
    const char* s = src + r * ROW + q * CH;
    if constexpr (CH == 16)
      cp_async16(d, s);
    else
      cp_async8(d, s);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// THE tap primitive of the fp32 and bf16 rungs, flat and blocked: one tap
// of a thread's TMX x TNX register tile.  For each output a fresh partial
// over the input channels in order (0, then fmaf), folded left into acc
// (tap 0 starts the sum).  a0: the thread's first pixel in the halo at
// this tap's offset (pixel m is PSTEP * m pixels on); wt: the tap's
// weights, NP columns a row, at the thread's first column (column group q
// is 4 * NCG columns on, NCG = NP / TNX).
template <class R, int NP, int CIN, int TMX = TM, int TNX = TN,
          int PSTEP = RPG>
__device__ __forceinline__ void rt_tap(const float* a0,
                                       const typename R::SW* wt, int tap,
                                       float (&acc)[TMX][TNX]) {
  constexpr int SIN = rt_pitch(CIN), NCG = NP / TNX;
  static_assert(TNX % 4 == 0 && NP % TNX == 0, "columns come in fours");
  float part[TMX][TNX];
#pragma unroll
  for (int m = 0; m < TMX; ++m)
#pragma unroll
    for (int n = 0; n < TNX; ++n) part[m][n] = 0.f;
  // tools/torch_regtile_sweep.py rewrites this unroll count
#pragma unroll 4
  for (int c4 = 0; c4 < CIN; c4 += 4) {
    float4 a[TMX];
#pragma unroll
    for (int m = 0; m < TMX; ++m)
      a[m] = *reinterpret_cast<const float4*>(a0 + PSTEP * m * SIN + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (CIN % 4 == 0 || c4 + j < CIN) {
        float4 wv[TNX / 4];
#pragma unroll
        for (int q = 0; q < TNX / 4; ++q)
          wv[q] = load_w4(wt + (c4 + j) * NP + 4 * NCG * q);
#pragma unroll
        for (int m = 0; m < TMX; ++m) {
          const float xv = lane_of(a[m], j);
#pragma unroll
          for (int q = 0; q < TNX / 4; ++q) {
            part[m][4 * q + 0] = fmaf(xv, wv[q].x, part[m][4 * q + 0]);
            part[m][4 * q + 1] = fmaf(xv, wv[q].y, part[m][4 * q + 1]);
            part[m][4 * q + 2] = fmaf(xv, wv[q].z, part[m][4 * q + 2]);
            part[m][4 * q + 3] = fmaf(xv, wv[q].w, part[m][4 * q + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < TMX; ++m)
#pragma unroll
    for (int n = 0; n < TNX; ++n)
      acc[m][n] = tap == 0 ? part[m][n] : __fadd_rn(acc[m][n], part[m][n]);
}

// A thread's pixel m in the block's tile (row-major) and its register
// column n among the NP columns.
template <int NCG>
__device__ __forceinline__ int rt_pixel(int m) {
  const int pg = threadIdx.x / NCG;
  return (pg / RPG) * RT + pg % RPG + RPG * m;
}
template <int NCG>
__device__ __forceinline__ int rt_column(int n) {
  return 4 * NCG * (n / 4) + 4 * (threadIdx.x % NCG) + n % 4;
}

// The nine taps of a block through the three-slot weight ring s_w (slots
// of CIN x NP weights; NC < NP padding columns are zero, never copied
// over): the first two taps' weights in flight (with whatever halo the
// caller has issued and not yet committed), then per tap one barrier, the
// copy of the tap two ahead (into the slot of the tap before), and
// tap_fn(tap, slot).  landed() runs once every copy of tap 0 and the halo
// has landed, before tap 0.  Ends with a barrier, after which the halo and
// the ring are free.
template <class R, int NP, int NC, int CIN, class Landed, class TapFn>
__device__ __forceinline__ void rt_ring(const typename R::W* __restrict__ w,
                                        typename R::SW* s_w, Landed landed,
                                        TapFn tap_fn) {
  using SW = typename R::SW;
  constexpr int WTAP = CIN * NP;  // weights in one slot
  if constexpr (NC < NP) {
    for (int e = threadIdx.x; e < RSTAGES * CIN * (NP - NC); e += blockDim.x)
      s_w[(e / (NP - NC)) * NP + NC + e % (NP - NC)] = SW(0.f);
  }
  rt_stage_tap<R, NP, NC, CIN>(w, s_w, 0);
  cp_async_commit();
  rt_stage_tap<R, NP, NC, CIN>(w, s_w + WTAP, 1);
  cp_async_commit();
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait<1>();  // this thread's copies of the tap (and halo) landed
    __syncthreads();     // everyone's have; everyone is done with tap - 1
    if (tap == 0) landed();
    if (tap + 2 < 9)
      rt_stage_tap<R, NP, NC, CIN>(w, s_w + ((tap + 2) % RSTAGES) * WTAP,
                                   tap + 2);
    cp_async_commit();  // empty at the last two taps: keeps wait<1> exact
    tap_fn(tap, s_w + (tap % RSTAGES) * WTAP);
  }
  __syncthreads();
}

// The flat kernels' nine taps of the block's 16x16 tile into acc: the
// halo, then the ring.
template <class R, int NP, int NC, int CIN>
__device__ __forceinline__ void rt_conv(const float* __restrict__ x,
                                        const typename R::W* __restrict__ w,
                                        char* smem, long long img, int y0,
                                        int x0, int l, float (&acc)[TM][TN]) {
  using K = Rt<R, NP, CIN>;
  using SW = typename R::SW;
  float* s_in = reinterpret_cast<float*>(smem);
  rt_load_halo<R, CIN>(x, s_in, img, y0, x0, l);
  const int pg = threadIdx.x / K::NCG;
  const int first = (pg / RPG) * RHP + pg % RPG;  // pixel 0 at tap 0
  rt_ring<R, NP, NC, CIN>(
      w, reinterpret_cast<SW*>(smem + K::W),
      [&] {
        if constexpr (std::is_same<R, RBF16>::value && CIN % 4 == 0) {
          rt_round_halo<CIN>(s_in);
          __syncthreads();
        }
      },
      [&](int tap, const SW* slot) {
        rt_tap<R, NP, CIN>(
            s_in + (first + (tap / 3) * RHP + tap % 3) * K::SIN,
            slot + 4 * (threadIdx.x % K::NCG), tap, acc);
      });
}

// One hidden block, flat schedule, fp32 / bf16: grid b * (l / RT)^2.
template <class R, int COUT, int CIN>
__global__ void __launch_bounds__(Rt<R, COUT, CIN>::THREADS, 1)
conv_regtile_kernel(const float* __restrict__ x,
                    const typename R::W* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int l) {
  using K = Rt<R, COUT, CIN>;
  constexpr int SP = COUT + 1;  // odd: a thread per pixel reads conflict-free
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int tiles_x = l / RT;
  const long long img = blockIdx.x / (tiles_x * tiles_x);
  const int t = blockIdx.x % (tiles_x * tiles_x);
  const int y0 = (t / tiles_x) * RT, x0 = (t % tiles_x) * RT;
  float acc[TM][TN];
  rt_conv<R, COUT, COUT, CIN>(x, w, smem, img, y0, x0, l, acc);
  float* s_pre = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n)
      s_pre[rt_pixel<K::NCG>(m) * SP + rt_column<K::NCG>(n)] = acc[m][n];
  __syncthreads();
  for (int p = threadIdx.x; p < RT * RT; p += blockDim.x) {
    float* row = s_pre + p * SP;
    norm_relu_to<COUT>([row](int co) { return row[co]; }, bias,
                       [row](int q, float4 v) {
                         row[4 * q] = v.x;
                         row[4 * q + 1] = v.y;
                         row[4 * q + 2] = v.z;
                         row[4 * q + 3] = v.w;
                       });
  }
  __syncthreads();
  float* o = out + ((img * l + y0) * l + x0) * COUT;
  for (int e = threadIdx.x; e < RT * RT * COUT; e += blockDim.x) {
    const int p = e / COUT, co = e % COUT;
    o[((long long)(p / RT) * l + p % RT) * COUT + co] = s_pre[p * SP + co];
  }
}

// The to_bits epilogue of a 16x16 pixel tile, shared by the fp32 / bf16
// and the int8 (fused_extractor_int8.cu) kernels.  rt_highpass: the
// tile's highpass(tiles) = tiles - box3x3(tiles), the nine zero-padded
// views folded left in [ky, kx] order, times float(1/9) (the reference
// multiplies), then rounded to the correlation bank's precision, into
// s_hp (RT^2, 3).
template <class H>
__device__ __forceinline__ void rt_highpass(const float* __restrict__ tiles_in,
                                            float* s_hp, long long img,
                                            int y0, int x0, int l) {
  const float* ti = tiles_in + img * l * l * 3;
  for (int p = threadIdx.x; p < RT * RT; p += blockDim.x) {
    const int gy = y0 + p / RT, gx = x0 + p % RT;
    for (int c = 0; c < 3; ++c) {
      float box = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int sy = gy + tap / 3 - 1, sx = gx + tap % 3 - 1;
        float v = 0.f;
        if (sy >= 0 && sy < l && sx >= 0 && sx < l)
          v = ti[((long long)sy * l + sx) * 3 + c];
        box = tap == 0 ? v : __fadd_rn(box, v);
      }
      const float center = ti[((long long)gy * l + gx) * 3 + c];
      s_hp[p * 3 + c] =
          round_to<H>(__fsub_rn(center, __fmul_rn(box, 1.0f / 9.0f)));
    }
  }
}

// The GAP partials from the staged (y + bias) rows s_red (RT^2, 61) and,
// with the correlation bank, the correlation partials from s_hp, of the
// two TH x TW tiles of the block's tile (by, bx), each over its pixels in
// row-major order.  Partials are (b * (l / TH) * (l / TW), 60),
// tile-major within an image.
template <class H>
__device__ __forceinline__ void rt_gap_corr_partials(
    const float* s_red, const float* s_hp, const H* __restrict__ corr,
    float* __restrict__ part_gap, float* __restrict__ part_corr,
    long long img, int by, int bx, int l, int has_corr) {
  constexpr int NB = 60, SR = NB + 1;
  const int y0 = by * RT, x0 = bx * RT;
  // GAP tile s (0: rows y0..y0+7, 1: the next 8) is pixels
  // [s * TH * TW, (s + 1) * TH * TW) of the block's tile, row-major
  const long long parts_x = l / TW, first = img * (l / TH) * parts_x;
  for (int i = threadIdx.x; i < 4 * NB; i += blockDim.x) {
    const int s = (i / NB) % 2, n = i % NB;
    const long long part = first + (2 * by + s) * parts_x + bx;
    float sum = 0.f;
    if (i < 2 * NB) {
      for (int p = 0; p < TH * TW; ++p)
        sum = __fadd_rn(sum, s_red[(s * TH * TW + p) * SR + n]);
      part_gap[part * NB + n] = sum;
    } else if (has_corr) {
      for (int p = 0; p < TH * TW; ++p) {
        const long long gp =
            (long long)(y0 + s * TH + p / TW) * l + x0 + p % TW;
        const H* cp = corr + (gp * NB + n) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sum = fmaf(s_hp[(s * TH * TW + p) * 3 + c], to_f(cp[c]), sum);
      }
      part_corr[part * NB + n] = sum;
    }
  }
}

// to_bits, flat schedule, fp32 / bf16: the conv + bias at NB = 60 columns
// (64 in the engine), reduced into the GAP partials, and with the
// correlation bank the highpass(tiles) . corr partials, of the two TH x TW
// tiles the block covers, each over its pixels in row-major order.
// Partials are (b * (l / TH) * (l / TW), NB), tile-major within an image,
// as the head kernel reads them.
template <class R, int CIN>
__global__ void __launch_bounds__(Rt<R, 64, CIN>::THREADS, 1)
gap_corr_regtile_kernel(const float* __restrict__ x,
                        const typename R::W* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ tiles_in,
                        const typename R::H* __restrict__ corr,
                        float* __restrict__ part_gap,
                        float* __restrict__ part_corr, int l, int has_corr) {
  constexpr int NB = 60, NP = 64, SR = NB + 1;
  using K = Rt<R, NP, CIN>;
  static_assert(RT == TW && RT == 2 * TH, "a block covers two GAP tiles");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int tiles_x = l / RT;
  const long long img = blockIdx.x / (tiles_x * tiles_x);
  const int t = blockIdx.x % (tiles_x * tiles_x);
  const int by = t / tiles_x, bx = t % tiles_x;
  const int y0 = by * RT, x0 = bx * RT;
  float acc[TM][TN];
  rt_conv<R, NP, NB, CIN>(x, w, smem, img, y0, x0, l, acc);
  float* s_red = reinterpret_cast<float*>(smem);
  float* s_hp = s_red + RT * RT * SR;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = rt_column<K::NCG>(n);
      if (col < NB)
        s_red[rt_pixel<K::NCG>(m) * SR + col] =
            __fadd_rn(acc[m][n], bias[col]);
    }
  if (has_corr) rt_highpass<typename R::H>(tiles_in, s_hp, img, y0, x0, l);
  __syncthreads();
  rt_gap_corr_partials<typename R::H>(s_red, s_hp, corr, part_gap, part_corr,
                                      img, by, bx, l, has_corr);
}

// ---- blocked schedule, fp32 and bf16: the register-tiled engine ------------
// (see the header).  A block computes BSLOTS slots of BS x BS pixels at a
// time, each slot an (image, subtile) pair with a BHW x BHW halo of its
// own (rows BHW pixels apart, pixels rt_pitch(cin) floats apart, so the
// four pixel rows a warp loads at once fall two bank quads apart); a
// thread owns one slot row, BTM pixels, x BkTile::TNB columns.
constexpr int BS = 8, BSLOTS = 4, BHW = BS + 2, BTM = BS;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// 8x8 subtiles of an image in one block's region: 4 (16x16) at bb 1, 2
// (8 rows x 16 columns) at bb 2 and 3, 1 at bb >= 4, so that the slots of a
// round hold 4 / (subtiles) images and the grid stays >= 256 blocks at
// b = 32, l = 64 for every bb up to 8
__host__ __device__ constexpr int bk_region(int bb) {
  return bb >= 4 ? 1 : bb >= 2 ? 2 : 4;
}
__host__ __device__ inline int bk_blocks(int b, int l, int bb) {
  return (b + bb - 1) / bb * ((l / BS) * (l / BS) / bk_region(bb));
}

// A thread's columns: 8 at ct = 64, 4 below (ct 32 then still runs 256
// threads, and a ct of 4 one column group); NCG column groups.
template <int CT>
struct BkTile {
  static constexpr int TNB = CT >= 64 ? 8 : 4;
  static constexpr int NCG = CT / TNB;
  static constexpr int THREADS = BSLOTS * BS * NCG;
};

// Shared memory of the blocked engine at COUT columns, channel tile CT and
// CIN input channels: the four slot halos, which the ct = C epilogue
// reuses for the staged pre-norm rows, then the resident weight slice of
// all nine taps (9 * CIN, CT) or, where that does not fit, the three-slot
// ring.  Offsets in bytes, 16-byte aligned.
template <class R, int COUT, int CT, int CIN>
struct Bk {
  using SW = typename R::SW;
  static constexpr int NT = COUT / CT;  // channel tiles
  static constexpr int SIN = rt_pitch(CIN);
  static constexpr int SLOT = BHW * BHW * SIN;  // floats of one slot's halo
  static constexpr int HALO = BSLOTS * SLOT * 4;
  static constexpr int STAGE = NT == 1 ? BSLOTS * BS * BS * (COUT + 1) * 4 : 0;
  static constexpr int W = ((HALO > STAGE ? HALO : STAGE) + 15) & ~15;
  static constexpr int SLICE = 9 * CIN * CT * (int)sizeof(SW);
  static constexpr bool RESIDENT = W + SLICE <= kMaxSmem;
  static constexpr int END =
      W + (RESIDENT ? SLICE : RSTAGES * CIN * CT * (int)sizeof(SW));
  static_assert(RESIDENT || NT == 1, "a streamed slice is the whole width");
  static_assert(END <= kMaxSmem, "fits one block");
};

// Rows [r0, r1) of the packed (9 * cin, COUT) weight, output columns
// [jt * CT, (jt + 1) * CT), into s_w[r * CT + c] with cp.async: 16-byte
// chunks (8 bytes for a bf16 row of 4).
template <class R, int COUT, int CT>
__device__ __forceinline__ void stage_rows(const typename R::W* __restrict__ w,
                                           typename R::SW* s_w, int r0, int r1,
                                           int jt) {
  using W = typename R::W;
  static_assert(std::is_same<W, typename R::SW>::value, "staged as stored");
  constexpr int ROW = CT * (int)sizeof(W);
  constexpr int CHUNK = ROW < 16 ? ROW : 16;
  constexpr int E = CHUNK / (int)sizeof(W);  // weights per chunk
  static_assert(CHUNK == 8 || CHUNK == 16, "rows of 8 or 16n bytes");
  const int n = (r1 - r0) * (CT / E);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = r0 + e / (CT / E), q = e % (CT / E);
    const W* src = w + (long long)r * COUT + jt * CT + E * q;
    W* dst = s_w + r * CT + E * q;
    if constexpr (CHUNK == 16)
      cp_async16(dst, src);
    else
      cp_async8(dst, src);
  }
}

// One hidden block at fp32 / bf16 on the blocked schedule, CIN input
// channels: grid bk_blocks(b, l, bb), BkTile<CT>::THREADS threads.
template <class R, int COUT, int CT, int CIN>
__device__ __forceinline__ void conv_blocked_rt(
    const float* __restrict__ x, const typename R::W* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int b, int l,
    int bb, int db) {
  using K = Bk<R, COUT, CT, CIN>;
  using T = BkTile<CT>;
  using SW = typename R::SW;
  constexpr bool BF16 = std::is_same<R, RBF16>::value && CIN % 4 == 0;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* s_in = reinterpret_cast<float*>(smem);
  SW* s_w = reinterpret_cast<SW*>(smem + K::W);
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
        rt_load_halo<R, CIN, BHW, BHW>(x, s_in + s * K::SLOT, img, y0, x0, l);
    }
  };
  auto round_halos = [&] {  // bf16: once the copies have landed
    if constexpr (BF16) {
      for (int s = 0; s < BSLOTS; ++s)
        rt_round_halo<CIN, BHW, BHW>(s_in + s * K::SLOT);
      __syncthreads();
    }
  };
  const int cg = threadIdx.x % T::NCG, pg = threadIdx.x / T::NCG;
  const int slot = pg / BS, row = pg % BS;
  const float* a0 = s_in + slot * K::SLOT + row * BHW * K::SIN;
  auto tap = [&](int t, const SW* wt, float(&acc)[BTM][T::TNB]) {
    rt_tap<R, CT, CIN, BTM, T::TNB, 1>(a0 + (t / 3 * BHW + t % 3) * K::SIN,
                                       wt + 4 * cg, t, acc);
  };
  // the pre-norm tile: ct = C, staged over the halo, normalised one thread
  // a pixel and written out coalesced; ct < C, pass jt's columns to out
  auto store = [&](int r, int jt, const float(&acc)[BTM][T::TNB]) {
    if constexpr (K::NT == 1) {
      constexpr int SP = COUT + 1;  // odd: a thread per pixel reads
      float* s_pre = s_in;          // conflict-free
      __syncthreads();              // every thread is done with the halo
#pragma unroll
      for (int m = 0; m < BTM; ++m)
#pragma unroll
        for (int n = 0; n < T::TNB; ++n)
          s_pre[(pg * BTM + m) * SP + rt_column<T::NCG>(n)] = acc[m][n];
      __syncthreads();
      for (int p = threadIdx.x; p < BSLOTS * BS * BS; p += blockDim.x) {
        float* v = s_pre + p * SP;
        norm_relu_to<COUT>([v](int co) { return v[co]; }, bias,
                           [v](int q4, float4 o) {
                             v[4 * q4] = o.x;
                             v[4 * q4 + 1] = o.y;
                             v[4 * q4 + 2] = o.z;
                             v[4 * q4 + 3] = o.w;
                           });
      }
      __syncthreads();
      for (int s = 0; s < BSLOTS; ++s) {
        long long img;
        int y0, x0;
        if (!origin(r * BSLOTS + s, img, y0, x0)) continue;
        float* o = out + ((img * l + y0) * l + x0) * COUT;
        for (int e = threadIdx.x; e < BS * BS * COUT; e += blockDim.x) {
          const int p = e / COUT, co = e % COUT;
          o[((long long)(p / BS) * l + p % BS) * COUT + co] =
              s_pre[(s * BS * BS + p) * SP + co];
        }
      }
    } else {
      long long img;
      int y0, x0;
      if (!origin(r * BSLOTS + slot, img, y0, x0)) return;
      float* o = out + ((img * l + y0 + row) * l + x0) * COUT + jt * CT +
                 4 * cg;
#pragma unroll
      for (int m = 0; m < BTM; ++m)
#pragma unroll
        for (int g = 0; g < T::TNB / 4; ++g)
          *reinterpret_cast<float4*>(o + m * COUT + 4 * T::NCG * g) =
              make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2],
                          acc[m][4 * g + 3]);
    }
  };
  float acc[BTM][T::TNB];
  if constexpr (K::RESIDENT) {
    for (int jt = 0; jt < K::NT; ++jt) {
      if (jt == 0 || !db) {  // with db, the last round of jt - 1 fetched it
        __syncthreads();     // every thread is done with slice jt - 1
        stage_rows<R, COUT, CT>(w, s_w, 0, 9 * CIN, jt);
        cp_async_commit();
      }
      for (int r = 0; r < rounds; ++r) {
        const bool fresh = jt == 0 || rounds > 1;  // else the halo stays
        if (fresh) {
          __syncthreads();  // every thread is done with the last halo
          halos(r);
          cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();
        if (fresh) round_halos();
        const bool prefetch = db && jt + 1 < K::NT && r + 1 == rounds;
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          tap(t, s_w + t * CIN * CT, acc);
          if (prefetch) {  // tap t of slice jt + 1 over tap t of slice jt
            __syncthreads();
            stage_rows<R, COUT, CT>(w, s_w, t * CIN, (t + 1) * CIN, jt + 1);
            cp_async_commit();
          }
        }
        store(r, jt, acc);
      }
    }
  } else {  // ct = C, streamed: the halo, then the ring, every round
    for (int r = 0; r < rounds; ++r) {
      __syncthreads();  // every thread is done with the staged rows
      halos(r);
      rt_ring<R, CT, CT, CIN>(w, s_w, round_halos,
                              [&](int t, const SW* wt) { tap(t, wt, acc); });
      store(r, 0, acc);
    }
  }
  if constexpr (K::NT > 1) {  // normalise the block's pixels in out
    __syncthreads();          // every pass's columns are written
    for (int e = threadIdx.x; e < pairs * BS * BS; e += blockDim.x) {
      long long img;
      int y0, x0;
      origin(e / (BS * BS), img, y0, x0);
      const int p = e % (BS * BS);
      float* o = out + ((img * l + y0 + p / BS) * l + x0 + p % BS) * COUT;
      norm_relu<COUT>([o](int co) { return o[co]; }, bias, o);
    }
  }
}

// One conv block at fp32 / bf16 on the blocked schedule (see the
// header), CIN 3 or COUT input channels: grid bk_blocks(b, l, bb).
template <class R, int COUT, int CT, int CIN>
__global__ void __launch_bounds__(BkTile<CT>::THREADS, 1)
conv_blocked_kernel(const float* __restrict__ x,
                    const typename R::W* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int b, int l, int bb, int db) {
  conv_blocked_rt<R, COUT, CT, CIN>(x, w, bias, out, b, l, bb, db);
}

// Per image: GAP = (sum of the tile partials) / l^2, head as
// broadcast-multiply + sum over K (operands at the head's precision,
// products and sums fp32), + head bias, + corr * corr_scale.  The block
// first copies its image's GAP and correlation partials into shared
// memory, HEAD_TILES tiles at a time, with float4 loads issued together
// (the partials are tile-major rows of NB floats); thread n then sums
// column n over the tiles in tile order, the chain of the first design,
// which walked global memory one dependent load at a time.
constexpr int HEAD_THREADS = 128, HEAD_TILES = 32;
template <class H, int NB>
__global__ void __launch_bounds__(HEAD_THREADS)
head_kernel(const float* __restrict__ part_gap,
            const float* __restrict__ part_corr, const H* __restrict__ head_w,
            const float* __restrict__ head_b,
            const float* __restrict__ corr_scale, float* __restrict__ logits,
            float* __restrict__ embed, int l, int tiles, int has_corr) {
  static_assert(NB % 4 == 0 && NB <= HEAD_THREADS, "a thread a column");
  constexpr int CH4 = HEAD_TILES * NB / 4;  // float4s of one chunk
  __shared__ float4 s_part[2 * CH4];        // GAP chunk, then corr chunk
  __shared__ float g[NB];
  const float* s_gap = reinterpret_cast<const float*>(s_part);
  const float* s_corr = s_gap + HEAD_TILES * NB;
  const long long img = blockIdx.x;
  const int n = threadIdx.x;
  float sg = 0.f, sc = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += HEAD_TILES) {
    const int nt = min(HEAD_TILES, tiles - t0);
    const long long first = (img * tiles + t0) * NB / 4;
    const float4* pg = reinterpret_cast<const float4*>(part_gap) + first;
    const float4* pc = reinterpret_cast<const float4*>(part_corr) + first;
    __syncthreads();  // every thread is done with the last chunk
#pragma unroll 4
    for (int e = threadIdx.x; e < nt * NB / 4; e += blockDim.x) {
      s_part[e] = pg[e];
      if (has_corr) s_part[CH4 + e] = pc[e];
    }
    __syncthreads();
    if (n < NB) {
      for (int t = 0; t < nt; ++t) sg = __fadd_rn(sg, s_gap[t * NB + n]);
      if (has_corr)
        for (int t = 0; t < nt; ++t) sc = __fadd_rn(sc, s_corr[t * NB + n]);
    }
  }
  if (n < NB) {
    g[n] = __fdiv_rn(sg, (float)(l * l));
    if (embed != nullptr) embed[img * NB + n] = g[n];
  }
  __syncthreads();
  if (n < NB) {
    float acc = 0.f;
    for (int k = 0; k < NB; ++k)
      acc = __fadd_rn(acc, __fmul_rn(round_to<H>(g[k]),
                                     to_f(head_w[k * NB + n])));
    float out = __fadd_rn(acc, head_b[n]);
    if (has_corr) out = __fadd_rn(out, __fmul_rn(sc, corr_scale[n]));
    logits[img * NB + n] = out;
  }
}

// ---- launchers -------------------------------------------------------------
template <class K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The host side of the fp32 or bf16 rung: each launcher returns
// cudaGetLastError() of its launch, or cudaErrorInvalidValue for a shape
// it is not built for (cin in {3, 16, 32, 64}; blocked: cin 3 or cout).
// Members are defined out of the class, so they are not inline and
// `extern template` keeps a rung's kernels in its own source (so does
// FlatConv's `any`).  The int8 rung's launchers are in
// fused_extractor_int8.cu; its head is Extractor<RF32>::head.
template <class R>
struct Extractor {
  using W = typename R::W;
  template <int COUT, int CT>
  static int blocked(const float* x, const void* w, const float* bias,
                     float* out, int b, int l, int cin, int bb, int db,
                     cudaStream_t stream);
  template <int COUT, int CT, int CIN>
  static int blocked_cin(const float* x, const void* w, const float* bias,
                         float* out, int b, int l, int bb, int db,
                         cudaStream_t stream);
  static int blocked_any(const float* x, const void* w, const float* bias,
                         float* out, int b, int l, int cin, int cout, int bb,
                         int ct, int db, cudaStream_t stream);
  static int gap_corr(const float* x, const void* w, const float* bias,
                      const float* tiles, const void* corr, float* part_gap,
                      float* part_corr, int b, int l, int cin, int n_bits,
                      int has_corr, cudaStream_t stream);
  template <int CIN>
  static int gap_corr_rt(const float* x, const void* w, const float* bias,
                         const float* tiles, const void* corr,
                         float* part_gap, float* part_corr, int b, int l,
                         int has_corr, cudaStream_t stream);
  static int head(const float* part_gap, const float* part_corr,
                  const void* head_w, const float* head_b,
                  const float* corr_scale, float* logits, float* embed, int b,
                  int l, int n_bits, int has_corr, cudaStream_t stream);
};

// The flat conv of the fp32 and bf16 rungs (the register-tiled kernel);
// the int8 flat conv is conv_imma_kernel, launched by qr_conv3x3_imma
// (fused_extractor_int8.cu).
template <class R>
struct FlatConv {
  template <int COUT, int CIN>
  static int rt(const float* x, const void* w, const float* bias, float* out,
                int b, int l, cudaStream_t stream) {
    using K = Rt<R, COUT, CIN>;
    if (l % RT) return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(conv_regtile_kernel<R, COUT, CIN>, K::END);
    if (err != cudaSuccess) return (int)err;
    conv_regtile_kernel<R, COUT, CIN>
        <<<b * (l / RT) * (l / RT), K::THREADS, K::END, stream>>>(
            x, static_cast<const typename R::W*>(w), bias, out, l);
    return (int)cudaGetLastError();
  }
  template <int COUT>
  static int cin_any(const float* x, const void* w, const float* bias,
                     float* out, int b, int l, int cin, cudaStream_t stream) {
    switch (cin) {
      case 3: return rt<COUT, 3>(x, w, bias, out, b, l, stream);
      case 16: return rt<COUT, 16>(x, w, bias, out, b, l, stream);
      case 32: return rt<COUT, 32>(x, w, bias, out, b, l, stream);
      case 64: return rt<COUT, 64>(x, w, bias, out, b, l, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  static int any(const float* x, const void* w, const float* bias,
                 float* out, int b, int l, int cin, int cout,
                 cudaStream_t stream);
};

template <class R>
int FlatConv<R>::any(const float* x, const void* w, const float* bias,
                     float* out, int b, int l, int cin, int cout,
                     cudaStream_t stream) {
  switch (cout) {
    case 16: return cin_any<16>(x, w, bias, out, b, l, cin, stream);
    case 32: return cin_any<32>(x, w, bias, out, b, l, cin, stream);
    case 64: return cin_any<64>(x, w, bias, out, b, l, cin, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class R>
template <int COUT, int CT>
int Extractor<R>::blocked(const float* x, const void* w, const float* bias,
                          float* out, int b, int l, int cin, int bb, int db,
                          cudaStream_t stream) {
  if (l % 16) return (int)cudaErrorInvalidValue;
  if (cin == 3)
    return blocked_cin<COUT, CT, 3>(x, w, bias, out, b, l, bb, db, stream);
  if (cin == COUT)
    return blocked_cin<COUT, CT, COUT>(x, w, bias, out, b, l, bb, db, stream);
  return (int)cudaErrorInvalidValue;
}

template <class R>
template <int COUT, int CT, int CIN>
int Extractor<R>::blocked_cin(const float* x, const void* w,
                              const float* bias, float* out, int b, int l,
                              int bb, int db, cudaStream_t stream) {
  constexpr int smem = Bk<R, COUT, CT, CIN>::END;
  cudaError_t err = set_smem(conv_blocked_kernel<R, COUT, CT, CIN>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_blocked_kernel<R, COUT, CT, CIN>
      <<<bk_blocks(b, l, bb), BkTile<CT>::THREADS, smem, stream>>>(
          x, static_cast<const W*>(w), bias, out, b, l, bb, db);
  return (int)cudaGetLastError();
}

template <class R>
int Extractor<R>::blocked_any(const float* x, const void* w,
                              const float* bias, float* out, int b, int l,
                              int cin, int cout, int bb, int ct, int db,
                              cudaStream_t stream) {
  if (bb < 1) return (int)cudaErrorInvalidValue;
#define QR_BLOCKED(CO, CTV)                                                  \
  if (cout == CO && ct == CTV)                                               \
    return blocked<CO, CTV>(x, w, bias, out, b, l, cin, bb, db, stream);
  QR_BLOCKED(16, 16) QR_BLOCKED(16, 8) QR_BLOCKED(16, 4)
  QR_BLOCKED(32, 32) QR_BLOCKED(32, 16) QR_BLOCKED(32, 8) QR_BLOCKED(32, 4)
  QR_BLOCKED(64, 64) QR_BLOCKED(64, 32) QR_BLOCKED(64, 16) QR_BLOCKED(64, 8)
  QR_BLOCKED(64, 4)
#undef QR_BLOCKED
  return (int)cudaErrorInvalidValue;
}

// n_bits == 60 (the RS(15,12) GF(16) codeword)
template <class R>
int Extractor<R>::gap_corr(const float* x, const void* w, const float* bias,
                           const float* tiles, const void* corr,
                           float* part_gap, float* part_corr, int b, int l,
                           int cin, int n_bits, int has_corr,
                           cudaStream_t stream) {
  if (n_bits != 60) return (int)cudaErrorInvalidValue;
  switch (cin) {
    case 3: return gap_corr_rt<3>(x, w, bias, tiles, corr, part_gap,
                                  part_corr, b, l, has_corr, stream);
    case 16: return gap_corr_rt<16>(x, w, bias, tiles, corr, part_gap,
                                    part_corr, b, l, has_corr, stream);
    case 32: return gap_corr_rt<32>(x, w, bias, tiles, corr, part_gap,
                                    part_corr, b, l, has_corr, stream);
    case 64: return gap_corr_rt<64>(x, w, bias, tiles, corr, part_gap,
                                    part_corr, b, l, has_corr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class R>
template <int CIN>
int Extractor<R>::gap_corr_rt(const float* x, const void* w,
                              const float* bias, const float* tiles,
                              const void* corr, float* part_gap,
                              float* part_corr, int b, int l, int has_corr,
                              cudaStream_t stream) {
  using K = Rt<R, 64, CIN>;
  if (l % RT) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(gap_corr_regtile_kernel<R, CIN>, K::END);
  if (err != cudaSuccess) return (int)err;
  gap_corr_regtile_kernel<R, CIN>
      <<<b * (l / RT) * (l / RT), K::THREADS, K::END, stream>>>(
          x, static_cast<const W*>(w), bias, tiles,
          static_cast<const typename R::H*>(corr), part_gap, part_corr, l,
          has_corr);
  return (int)cudaGetLastError();
}

template <class R>
int Extractor<R>::head(const float* part_gap, const float* part_corr,
                       const void* head_w, const float* head_b,
                       const float* corr_scale, float* logits, float* embed,
                       int b, int l, int n_bits, int has_corr,
                       cudaStream_t stream) {
  constexpr int NB = 60;
  if (n_bits != NB) return (int)cudaErrorInvalidValue;
  const int tiles = (l / TH) * (l / TW);
  head_kernel<typename R::H, NB><<<b, HEAD_THREADS, 0, stream>>>(
      part_gap, part_corr, static_cast<const typename R::H*>(head_w), head_b,
      corr_scale, logits, embed, l, tiles, has_corr);
  return (int)cudaGetLastError();
}

// the bf16 rung is instantiated in its own source
extern template struct Extractor<RBF16>;
extern template struct FlatConv<RBF16>;

}  // namespace qr
