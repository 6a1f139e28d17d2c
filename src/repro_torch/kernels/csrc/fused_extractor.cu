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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, NPIX = TH * TW;  // one thread per pixel
constexpr int HH = TH + 2, HWD = TW + 2, NHALO = HH * HWD;

// x (b, l, l, cin) NHWC -> s_in[ci * NHALO + hy * HWD + hx], zero outside.
__device__ __forceinline__ void load_halo(const float* __restrict__ x,
                                          float* s_in, long long img,
                                          int y0, int x0, int l, int cin) {
  const float* xi = x + img * l * l * cin;
  for (int e = threadIdx.x; e < NHALO * cin; e += blockDim.x) {
    const int ci = e % cin, p = e / cin;
    const int gy = y0 + p / HWD - 1, gx = x0 + p % HWD - 1;
    float v = 0.f;
    if (gy >= 0 && gy < l && gx >= 0 && gx < l)
      v = xi[((long long)gy * l + gx) * cin + ci];
    s_in[ci * NHALO + p] = v;
  }
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
  float sum = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    acc[co] = __fadd_rn(acc[co], bias[co]);
    sum = __fadd_rn(sum, acc[co]);
  }
  const float mu = __fdiv_rn(sum, (float)COUT);
  float ss = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    const float d = __fsub_rn(acc[co], mu);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(ss, (float)COUT);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  float4* o4 = reinterpret_cast<float4*>(
      out + ((img * l + y0 + py) * l + x0 + px) * COUT);
#pragma unroll
  for (int q = 0; q < COUT / 4; ++q) {
    float4 v;
    v.x = fmaxf(__fmul_rn(__fsub_rn(acc[4 * q + 0], mu), rs), 0.f);
    v.y = fmaxf(__fmul_rn(__fsub_rn(acc[4 * q + 1], mu), rs), 0.f);
    v.z = fmaxf(__fmul_rn(__fsub_rn(acc[4 * q + 2], mu), rs), 0.f);
    v.w = fmaxf(__fmul_rn(__fsub_rn(acc[4 * q + 3], mu), rs), 0.f);
    o4[q] = v;
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
