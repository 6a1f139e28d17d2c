// Extractor decode kernels, int8 rung (see extractor.cuh), and the pass
// that quantizes each layer's input once per pixel.
#include "extractor.cuh"

namespace qr {

template struct Extractor<RI8>;

namespace {

// The layer input (npix, cin) fp32 -> q (npix, cw) words of four int8 and
// s (npix) fp32, one thread per pixel: the reference's
// `quantize_rows_int8` (src/repro/core/extractor.py:119) on each
// tap-shifted row, whose row is one input pixel.
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int* __restrict__ q,
                                     float* __restrict__ s, long long npix,
                                     int cin) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const float* xp = x + p * cin;
  float amax = 0.f;
  for (int ci = 0; ci < cin; ++ci) amax = fmaxf(amax, fabsf(xp[ci]));
  const float sc = __fmul_rn(fmaxf(amax, kQEps), kInvQmax);
  s[p] = sc;
  const int cw = halo_words<RI8>(cin);
  for (int k = 0; k < cw; ++k) {
    unsigned word = 0;
    for (int j = 0; j < 4; ++j) {
      const int ci = 4 * k + j;
      if (ci < cin) {
        // rintf rounds half to even, as jnp.round
        const float r =
            fminf(fmaxf(rintf(__fdiv_rn(xp[ci], sc)), -127.f), 127.f);
        word |= (unsigned)(uint8_t)(int8_t)(int)r << (8 * j);
      }
    }
    q[p * cw + k] = (int)word;
  }
}

}  // namespace
}  // namespace qr

// x (npix, cin) fp32 -> q (npix, ceil(cin / 4)) int32 words, s (npix) fp32.
extern "C" int qr_quantize_rows_int8(const void* x, void* q, void* s,
                                     long long npix, int cin, void* stream) {
  if (npix <= 0 || cin <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  qr::quantize_rows_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)x, (int*)q, (float*)s, npix, cin);
  return (int)cudaGetLastError();
}
