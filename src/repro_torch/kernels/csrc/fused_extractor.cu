// Extractor decode, flat schedule, fp32: the conv stack, to_bits, GAP,
// head and correlation bank that turn (b, l, l, 3) tiles into (b, n_bits)
// bit logits (and, on request, the (b, n_bits) GAP embedding).
//
// Replaces the Pallas kernel `fused_extractor`
// (src/repro/kernels/fused_extractor.py:82, pallas_call at :113), whose
// grid step runs the shared body `extractor_forward_packed_embed`
// (src/repro/core/extractor.py:273) on one whole image: D SAME 3x3 conv
// blocks as nine tap dots in static [ky, kx] order + bias + channel_norm +
// ReLU, the to_bits 3x3 conv, GAP, the head as broadcast-multiply + sum,
// and highpass(tiles) . corr summed over (pixel, channel) x corr_scale.
//
// What bounds it on the H100: operations.  At l=64, C=64, D=7 one image
// costs ~2.1 GFLOP (layers 1-6 0.30 each, to_bits 0.28), all fp32, which
// outside the tensor cores means FFMA at 67 TFLOP/s at most.
//
// Design: one image's fp32 activation is 1 MiB at l=64, C=64 — more than
// an SM's 227 KB of shared memory — so the TPU's whole-forward-per-step
// fusion does not carry over.  Instead one direct-conv kernel per layer:
// a block owns an 8x16 pixel tile of one image and ALL output channels,
// one thread per pixel, so channel_norm's reduction over channels stays in
// the thread's registers and fuses into the epilogue (bias + norm + ReLU).
// The block stages its (8+2)x(16+2) input halo channel-major in shared
// memory (zero padding = SAME) and one tap's (cin, cout) weight slice at a
// time (broadcast reads, float4).  Per tap the thread runs an FFMA chain
// over the input channels into a fresh partial, then adds the partial to
// its accumulator: the reference's nine tap dots folded left in [ky, kx]
// order.  Activations go through global memory between layers.  The last
// conv (to_bits) kernel reduces its tile's (y + bias) over pixels in a
// fixed order into a per-tile GAP partial and, when the correlation bank
// is on, the tile's highpass . corr partial; a small head kernel sums the
// partials per image in tile order and applies GAP scale, head and corr.
// Every reduction has a fixed order, so a row's logits do not depend on
// the batch it came in.
//
// Blocked schedule, `conv_blocked_kernel`: replaces the Pallas kernel
// `fused_extractor_blocked` (src/repro/kernels/fused_extractor.py:149,
// pallas_call at :257), the same forward re-blocked by a schedule (batch
// block bb, output-channel tile ct, double_buffer) whose fp32 output is
// bitwise the flat kernel's.  On the TPU the schedule sizes VMEM scratch
// and grid steps; here it sizes what a block stages in shared memory.  A
// block owns a 16x16 pixel tile (256 threads, one per pixel) of bb images
// in turn.  For each output-channel tile [j0, j0 + ct) it stages the
// weight slice of ALL nine taps once (9 * cin * ct floats) and reuses it
// for the bb images: the flat kernel restages each tap's slice for every
// 128-pixel tile of every image, and syncs between taps; this one runs the
// nine taps of an image without a barrier.  With ct < C the (pixel, C)
// pre-norm result lands in the output buffer, tile by tile, as the
// reference's (M, C) accumulator scratch, and the bias + channel_norm +
// ReLU epilogue then reads all C channels of the thread's own pixel back;
// a thread reads only what it wrote, so no barrier is needed.  Fewer
// channels per pass means fewer registers per thread.  `db` (with ct < C)
// double-buffers the weight slices: the next channel tile's slice is
// fetched with cp.async while the current one computes; with ct = C there
// is one slice and db changes nothing.  A ragged batch (bb not dividing b)
// masks the missing images of the last block: the reference computes
// zero pad rows and slices them off, which leaves the real rows the same.
// Bitwise equality with the flat kernel: every output channel keeps the
// flat kernel's FFMA chain over input channels and the left fold over the
// nine taps, and the epilogue sums over channels in channel order.  The
// to_bits conv, GAP, correlation and head run the flat kernels (n_bits is
// always one full-width tile, as in the reference).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, NPIX = TH * TW;  // one thread per pixel
constexpr int HH = TH + 2, HWD = TW + 2, NHALO = HH * HWD;

// x (b, l, l, cin) NHWC -> s_in[ci * NH + hy * (PW + 2) + hx] for the
// (PH + 2) x (PW + 2) halo of the PH x PW pixel tile at (y0, x0), zero
// outside the image.
template <int PH, int PW>
__device__ __forceinline__ void load_halo_t(const float* __restrict__ x,
                                            float* s_in, long long img,
                                            int y0, int x0, int l, int cin) {
  constexpr int HW_ = PW + 2, NH = (PH + 2) * (PW + 2);
  const float* xi = x + img * l * l * cin;
  for (int e = threadIdx.x; e < NH * cin; e += blockDim.x) {
    const int ci = e % cin, p = e / cin;
    const int gy = y0 + p / HW_ - 1, gx = x0 + p % HW_ - 1;
    float v = 0.f;
    if (gy >= 0 && gy < l && gx >= 0 && gx < l)
      v = xi[((long long)gy * l + gx) * cin + ci];
    s_in[ci * NH + p] = v;
  }
}

__device__ __forceinline__ void load_halo(const float* __restrict__ x,
                                          float* s_in, long long img,
                                          int y0, int x0, int l, int cin) {
  load_halo_t<TH, TW>(x, s_in, img, y0, x0, l, cin);
}

// The nine tap dots of a SAME 3x3 conv at this thread's pixel, folded
// left in [ky, kx] order.  w is the packed (9 * cin, COUT) weight.
template <int COUT>
__device__ __forceinline__ void conv_taps(const float* __restrict__ w,
                                          const float* s_in, float* s_w,
                                          int cin, int py, int px,
                                          float (&acc)[COUT]) {
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // halo loaded / previous tap's weights consumed
    const float* wt = w + (long long)tap * cin * COUT;
    for (int e = threadIdx.x; e < cin * COUT; e += blockDim.x) s_w[e] = wt[e];
    __syncthreads();
    const float* sp = s_in + (py + tap / 3) * HWD + (px + tap % 3);
    float part[COUT];
#pragma unroll
    for (int co = 0; co < COUT; ++co) part[co] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < cin; ++ci) {
      const float xv = sp[ci * NHALO];
      const float4* w4 = reinterpret_cast<const float4*>(s_w + ci * COUT);
#pragma unroll
      for (int q = 0; q < COUT / 4; ++q) {
        const float4 wv = w4[q];
        part[4 * q + 0] = fmaf(xv, wv.x, part[4 * q + 0]);
        part[4 * q + 1] = fmaf(xv, wv.y, part[4 * q + 1]);
        part[4 * q + 2] = fmaf(xv, wv.z, part[4 * q + 2]);
        part[4 * q + 3] = fmaf(xv, wv.w, part[4 * q + 3]);
      }
    }
    if (tap == 0) {
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[co] = part[co];
    } else {
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[co] = __fadd_rn(acc[co], part[co]);
    }
  }
}

// The hidden block's epilogue on one pixel: + bias, channel_norm
// (population variance, sums in channel order), ReLU, stored as float4 to
// o (COUT contiguous floats).  pre(co) is the pixel's pre-norm conv output
// of channel co: the thread's registers, or (blocked, ct < C) what the
// thread wrote to o one channel tile at a time, overwritten in place.  One
// body for both keeps the flat and the blocked kernels bitwise equal.
template <int COUT, class Pre>
__device__ __forceinline__ void norm_relu(Pre pre,
                                          const float* __restrict__ bias,
                                          float* o) {
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
  float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
  for (int q = 0; q < COUT / 4; ++q)
    o4[q] = make_float4(out(4 * q), out(4 * q + 1), out(4 * q + 2),
                        out(4 * q + 3));
}

// One hidden block: SAME 3x3 conv + bias + channel_norm + ReLU.
template <int COUT>
__global__ void __launch_bounds__(NPIX)
conv_norm_relu_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int l, int cin) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_in = s_w + cin * COUT;
  const int tiles_x = l / TW, tiles = (l / TH) * tiles_x;
  const long long img = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int y0 = (t / tiles_x) * TH, x0 = (t % tiles_x) * TW;
  const int py = threadIdx.x / TW, px = threadIdx.x % TW;
  load_halo(x, s_in, img, y0, x0, l, cin);
  float acc[COUT];
  conv_taps<COUT>(w, s_in, s_w, cin, py, px, acc);
  norm_relu<COUT>([&](int co) { return acc[co]; }, bias,
                  out + ((img * l + y0 + py) * l + x0 + px) * COUT);
}

// ---- blocked schedule ------------------------------------------------------
constexpr int BTH = 16, BTW = 16, BNPIX = BTH * BTW;  // one thread per pixel
constexpr int BHWD = BTW + 2, BNHALO = (BTH + 2) * BHWD;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Weight slice of channel tile jt, all nine taps: rows r of the packed
// (9 * cin, COUT) weight, columns [jt * CT, (jt + 1) * CT) -> s_w[r * CT + c].
template <int COUT, int CT>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              float* s_w, int cin, int jt,
                                              bool async) {
  const int n4 = 9 * cin * (CT / 4);
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    const int r = e / (CT / 4), q = e % (CT / 4);
    const float* src = w + (long long)r * COUT + jt * CT + 4 * q;
    float* dst = s_w + r * CT + 4 * q;
    if (async) {
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    }
  }
}

// The nine tap dots of this thread's pixel for CT output channels, from
// the staged slice s_w (9 * cin, CT): per tap an FFMA chain over input
// channels into a fresh partial, folded left into acc in [ky, kx] order.
template <int CT>
__device__ __forceinline__ void conv9(const float* s_w, const float* s_in,
                                      int cin, int py, int px,
                                      float (&acc)[CT]) {
  for (int tap = 0; tap < 9; ++tap) {
    const float* sp = s_in + (py + tap / 3) * BHWD + (px + tap % 3);
    const float* wt = s_w + tap * cin * CT;
    float part[CT];
#pragma unroll
    for (int co = 0; co < CT; ++co) part[co] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < cin; ++ci) {
      const float xv = sp[ci * BNHALO];
      const float4* w4 = reinterpret_cast<const float4*>(wt + ci * CT);
#pragma unroll
      for (int q = 0; q < CT / 4; ++q) {
        const float4 wv = w4[q];
        part[4 * q + 0] = fmaf(xv, wv.x, part[4 * q + 0]);
        part[4 * q + 1] = fmaf(xv, wv.y, part[4 * q + 1]);
        part[4 * q + 2] = fmaf(xv, wv.z, part[4 * q + 2]);
        part[4 * q + 3] = fmaf(xv, wv.w, part[4 * q + 3]);
      }
    }
    if (tap == 0) {
#pragma unroll
      for (int co = 0; co < CT; ++co) acc[co] = part[co];
    } else {
#pragma unroll
      for (int co = 0; co < CT; ++co) acc[co] = __fadd_rn(acc[co], part[co]);
    }
  }
}

// One hidden block on the blocked schedule (see the header): grid
// (ceil(b / bb) * tiles), 256 threads; dynamic shared memory holds one or
// two weight slices of 9 * cin * CT floats and one halo of cin * BNHALO.
template <int COUT, int CT>
__global__ void __launch_bounds__(BNPIX)
conv_blocked_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int b, int l, int cin, int bb, int db) {
  constexpr int NT = COUT / CT;  // channel tiles
  extern __shared__ float4 smem4[];
  const int wsz = 9 * cin * CT;
  const bool two = db && NT > 1;
  float* s_w0 = reinterpret_cast<float*>(smem4);
  float* s_in = s_w0 + (two ? 2 : 1) * wsz;
  const int tiles_x = l / BTW, tiles = (l / BTH) * tiles_x;
  const int img0 = (blockIdx.x / tiles) * bb;
  const int t = blockIdx.x % tiles;
  const int y0 = (t / tiles_x) * BTH, x0 = (t % tiles_x) * BTW;
  const int py = threadIdx.x / BTW, px = threadIdx.x % BTW;
  const int nimg = min(bb, b - img0);
  if (two) {
    stage_weights<COUT, CT>(w, s_w0, cin, 0, true);
    cp_async_commit();
  }
  for (int jt = 0; jt < NT; ++jt) {
    float* s_w = s_w0 + (two ? (jt & 1) * wsz : 0);
    __syncthreads();  // every thread is done with the buffer refilled next
    if (two) {
      if (jt + 1 < NT) {
        stage_weights<COUT, CT>(w, s_w0 + ((jt + 1) & 1) * wsz, cin, jt + 1,
                                true);
        cp_async_commit();
        cp_async_wait<1>();  // this tile's slice has landed
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_weights<COUT, CT>(w, s_w, cin, jt, false);
    }
    for (int i = 0; i < nimg; ++i) {
      const long long img = img0 + i;
      __syncthreads();  // weights visible / previous image's halo consumed
      load_halo_t<BTH, BTW>(x, s_in, img, y0, x0, l, cin);
      __syncthreads();
      float acc[CT];
      conv9<CT>(s_w, s_in, cin, py, px, acc);
      float* o = out + ((img * l + y0 + py) * l + x0 + px) * COUT;
      if constexpr (NT == 1) {
        norm_relu<CT>([&](int co) { return acc[co]; }, bias, o);
      } else {
        float4* o4 = reinterpret_cast<float4*>(o + jt * CT);
#pragma unroll
        for (int q = 0; q < CT / 4; ++q)
          o4[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                              acc[4 * q + 3]);
      }
    }
  }
  if constexpr (NT > 1) {
    for (int i = 0; i < nimg; ++i) {
      const long long img = img0 + i;
      float* o = out + ((img * l + y0 + py) * l + x0 + px) * COUT;
      norm_relu<COUT>([o](int co) { return o[co]; }, bias, o);
    }
  }
}

// to_bits conv + bias, reduced over the tile's pixels into a GAP partial;
// with the correlation bank, also the tile's highpass(tiles) . corr
// partial.  Partials are (b * tiles, NB), tile-major within an image.
template <int NB>
__global__ void __launch_bounds__(NPIX)
conv_gap_corr_kernel(const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ tiles_in,
                     const float* __restrict__ corr,
                     float* __restrict__ part_gap,
                     float* __restrict__ part_corr, int l, int cin,
                     int has_corr) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_in = s_w + cin * NB;
  float* s_red = s_in + NHALO * cin;  // (NPIX, NB + 1)
  const int tiles_x = l / TW, tiles = (l / TH) * tiles_x;
  const long long img = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int y0 = (t / tiles_x) * TH, x0 = (t % tiles_x) * TW;
  const int py = threadIdx.x / TW, px = threadIdx.x % TW;
  load_halo(x, s_in, img, y0, x0, l, cin);
  float acc[NB];
  conv_taps<NB>(w, s_in, s_w, cin, py, px, acc);
#pragma unroll
  for (int co = 0; co < NB; ++co)
    s_red[threadIdx.x * (NB + 1) + co] = __fadd_rn(acc[co], bias[co]);
  __syncthreads();
  for (int co = threadIdx.x; co < NB; co += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < NPIX; ++p) s = __fadd_rn(s, s_red[p * (NB + 1) + co]);
    part_gap[(long long)blockIdx.x * NB + co] = s;
  }
  if (!has_corr) return;
  // highpass = tiles - box3x3(tiles): the nine zero-padded views folded
  // left in [ky, kx] order, times float(1/9) (the reference multiplies).
  float* s_hp = s_w;  // the weight slice is no longer needed
  __syncthreads();
  const float* ti = tiles_in + img * l * l * 3;
  const int gy = y0 + py, gx = x0 + px;
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
    s_hp[threadIdx.x * 3 + c] =
        __fsub_rn(center, __fmul_rn(box, 1.0f / 9.0f));
  }
  __syncthreads();
  for (int n = threadIdx.x; n < NB; n += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < NPIX; ++p) {
      const long long gp = (long long)(y0 + p / TW) * l + x0 + p % TW;
      const float* cp = corr + (gp * NB + n) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) s = fmaf(s_hp[p * 3 + c], cp[c], s);
    }
    part_corr[(long long)blockIdx.x * NB + n] = s;
  }
}

// Per image: GAP = (sum of the tile partials) / l^2, head as
// broadcast-multiply + sum over K, + head bias, + corr * corr_scale.
template <int NB>
__global__ void head_kernel(const float* __restrict__ part_gap,
                            const float* __restrict__ part_corr,
                            const float* __restrict__ head_w,
                            const float* __restrict__ head_b,
                            const float* __restrict__ corr_scale,
                            float* __restrict__ logits,
                            float* __restrict__ embed, int l, int tiles,
                            int has_corr) {
  __shared__ float g[NB];
  const long long img = blockIdx.x;
  for (int n = threadIdx.x; n < NB; n += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t)
      s = __fadd_rn(s, part_gap[(img * tiles + t) * NB + n]);
    g[n] = __fdiv_rn(s, (float)(l * l));
    if (embed != nullptr) embed[img * NB + n] = g[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < NB; n += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < NB; ++k)
      acc = __fadd_rn(acc, __fmul_rn(g[k], head_w[k * NB + n]));
    float out = __fadd_rn(acc, head_b[n]);
    if (has_corr) {
      float cs = 0.f;
      for (int t = 0; t < tiles; ++t)
        cs = __fadd_rn(cs, part_corr[(img * tiles + t) * NB + n]);
      out = __fadd_rn(out, __fmul_rn(cs, corr_scale[n]));
    }
    logits[img * NB + n] = out;
  }
}

template <int COUT>
int conv_norm_relu(const float* x, const float* w, const float* bias,
                   float* out, int b, int l, int cin, cudaStream_t stream) {
  const int blocks = b * (l / TH) * (l / TW);
  const size_t smem = sizeof(float) * ((size_t)cin * COUT + NHALO * cin);
  cudaError_t err = cudaFuncSetAttribute(
      conv_norm_relu_kernel<COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_norm_relu_kernel<COUT><<<blocks, NPIX, smem, stream>>>(x, w, bias,
                                                             out, l, cin);
  return (int)cudaGetLastError();
}

template <int NB>
int conv_gap_corr(const float* x, const float* w, const float* bias,
                  const float* tiles_in, const float* corr, float* part_gap,
                  float* part_corr, int b, int l, int cin, int has_corr,
                  cudaStream_t stream) {
  const int blocks = b * (l / TH) * (l / TW);
  const size_t smem = sizeof(float) * ((size_t)cin * NB + NHALO * cin +
                                       (size_t)NPIX * (NB + 1));
  cudaError_t err = cudaFuncSetAttribute(
      conv_gap_corr_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_gap_corr_kernel<NB><<<blocks, NPIX, smem, stream>>>(
      x, w, bias, tiles_in, corr, part_gap, part_corr, l, cin, has_corr);
  return (int)cudaGetLastError();
}

template <int COUT, int CT>
int conv_blocked(const float* x, const float* w, const float* bias,
                 float* out, int b, int l, int cin, int bb, int db,
                 cudaStream_t stream) {
  const bool two = db && COUT / CT > 1;
  const int blocks = (b + bb - 1) / bb * (l / BTH) * (l / BTW);
  const size_t smem = sizeof(float) * ((two ? 2 : 1) * 9 * (size_t)cin * CT +
                                       (size_t)BNHALO * cin);
  cudaError_t err = cudaFuncSetAttribute(
      conv_blocked_kernel<COUT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_blocked_kernel<COUT, CT><<<blocks, BNPIX, smem, stream>>>(
      x, w, bias, out, b, l, cin, bb, db);
  return (int)cudaGetLastError();
}

}  // namespace

// cout in {16, 32, 64}; l a multiple of 16.  Returns cudaGetLastError().
extern "C" int qr_conv3x3_norm_relu(const void* x, const void* w,
                                    const void* bias, void* out, int b,
                                    int l, int cin, int cout, void* stream) {
  const float *xf = (const float*)x, *wf = (const float*)w,
              *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cout) {
    case 16: return conv_norm_relu<16>(xf, wf, bf, of, b, l, cin, s);
    case 32: return conv_norm_relu<32>(xf, wf, bf, of, b, l, cin, s);
    case 64: return conv_norm_relu<64>(xf, wf, bf, of, b, l, cin, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// n_bits == 60 (the RS(15,12) GF(16) codeword).
extern "C" int qr_conv3x3_gap_corr(const void* x, const void* w,
                                   const void* bias, const void* tiles,
                                   const void* corr, void* part_gap,
                                   void* part_corr, int b, int l, int cin,
                                   int n_bits, int has_corr, void* stream) {
  if (n_bits != 60) return (int)cudaErrorInvalidValue;
  return conv_gap_corr<60>((const float*)x, (const float*)w,
                           (const float*)bias, (const float*)tiles,
                           (const float*)corr, (float*)part_gap,
                           (float*)part_corr, b, l, cin, has_corr,
                           (cudaStream_t)stream);
}

// embed may be null.
extern "C" int qr_extractor_head(const void* part_gap, const void* part_corr,
                                 const void* head_w, const void* head_b,
                                 const void* corr_scale, void* logits,
                                 void* embed, int b, int l, int n_bits,
                                 int has_corr, void* stream) {
  if (n_bits != 60) return (int)cudaErrorInvalidValue;
  const int tiles = (l / TH) * (l / TW);
  head_kernel<60><<<b, 64, 0, (cudaStream_t)stream>>>(
      (const float*)part_gap, (const float*)part_corr,
      (const float*)head_w, (const float*)head_b,
      (const float*)corr_scale, (float*)logits, (float*)embed, l, tiles,
      has_corr);
  return (int)cudaGetLastError();
}

// Blocked schedule: cout in {16, 32, 64}, ct a multiple of 4 dividing cout,
// bb >= 1, l a multiple of 16, w 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int qr_conv3x3_norm_relu_blocked(const void* x, const void* w,
                                            const void* bias, void* out,
                                            int b, int l, int cin, int cout,
                                            int bb, int ct, int db,
                                            void* stream) {
  const float *xf = (const float*)x, *wf = (const float*)w,
              *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (bb < 1) return (int)cudaErrorInvalidValue;
#define QR_BLOCKED(CO, CTV)                                                \
  if (cout == CO && ct == CTV)                                             \
    return conv_blocked<CO, CTV>(xf, wf, bf, of, b, l, cin, bb, db, s);
  QR_BLOCKED(16, 16) QR_BLOCKED(16, 8) QR_BLOCKED(16, 4)
  QR_BLOCKED(32, 32) QR_BLOCKED(32, 16) QR_BLOCKED(32, 8) QR_BLOCKED(32, 4)
  QR_BLOCKED(64, 64) QR_BLOCKED(64, 32) QR_BLOCKED(64, 16) QR_BLOCKED(64, 8)
  QR_BLOCKED(64, 4)
#undef QR_BLOCKED
  return (int)cudaErrorInvalidValue;
}
