// Tile-first fused ingest: raw uint8 -> Resize -> CenterCrop -> Normalize
// -> tile extract, written straight to the (n, l, l, 3) decode input.
//
// Replaces the Pallas kernel `fused_tile_preprocess`
// (src/repro/kernels/fused_tile_preprocess.py:68, pallas_call at :99,
// body `_kernel` :46, math `interp_affine` fused_preprocess.py:32).
// There, each grid step runs two dense interpolation matmuls per channel,
// scale_c * (Ry[y:y+l, :] @ img_c @ Rx[:, x:x+l]) + bias_c, because
// gathers are slow on the TPU's vector unit.
//
// What bounds it on the H100: bytes.  Each output element costs four
// byte loads (mostly L1/L2 hits), twelve flops and one 4-byte store, so the
// kernel is bound by writing the output (~49 KB per 64x64 tile) and
// reading the raw pixels under the tile.
//
// Design: Ry and Rx have at most two nonzeros per row (bilinear, edge
// clamp), so the dense products become a gather with two taps per axis.
// The host passes the (index, weight) pairs read off the very float32
// matrices the reference builds (`resize_matrix`); an edge-clamp row whose
// two taps were summed into one entry arrives as (i, i) with weights
// (w, 0).  One thread per output element; the image index is t / k, so
// the (b, k, 2) escalation form costs nothing extra.  The arithmetic keeps
// the reference's order — vertical pass, horizontal pass, then
// *scale + bias — with __fmul_rn/__fadd_rn so nvcc does not contract it
// into FMAs.  Offsets are clamped to [0, crop - l] as lax.dynamic_slice
// clamps them in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tile_preprocess_kernel(
    const uint8_t* __restrict__ raw, const int* __restrict__ offsets,
    const int* __restrict__ ry_idx, const float* __restrict__ ry_w,
    const int* __restrict__ rx_idx, const float* __restrict__ rx_w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, long long total, int k, int H, int W,
    int tile, int crop) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int c = (int)(idx % 3);
    const long long pix = idx / 3;
    const int j = (int)(pix % tile);
    const int i = (int)((pix / tile) % tile);
    const long long t = pix / ((long long)tile * tile);
    const long long img = t / k;
    const int max_off = crop - tile;
    const int oy = min(max(offsets[2 * t], 0), max_off);
    const int ox = min(max(offsets[2 * t + 1], 0), max_off);
    const int row = oy + i, col = ox + j;
    const int r0 = ry_idx[2 * row], r1 = ry_idx[2 * row + 1];
    const float wr0 = ry_w[2 * row], wr1 = ry_w[2 * row + 1];
    const int c0 = rx_idx[2 * col], c1 = rx_idx[2 * col + 1];
    const float wc0 = rx_w[2 * col], wc1 = rx_w[2 * col + 1];
    const uint8_t* im = raw + img * (long long)H * W * 3 + c;
    const float p00 = (float)im[((long long)r0 * W + c0) * 3];
    const float p10 = (float)im[((long long)r1 * W + c0) * 3];
    const float p01 = (float)im[((long long)r0 * W + c1) * 3];
    const float p11 = (float)im[((long long)r1 * W + c1) * 3];
    // vertical pass (Ry @ img_c) at the two source columns
    const float v0 = __fadd_rn(__fmul_rn(wr0, p00), __fmul_rn(wr1, p10));
    const float v1 = __fadd_rn(__fmul_rn(wr0, p01), __fmul_rn(wr1, p11));
    // horizontal pass (@ Rx), then the normalising affine
    const float h = __fadd_rn(__fmul_rn(v0, wc0), __fmul_rn(v1, wc1));
    out[idx] = __fadd_rn(__fmul_rn(h, scale[c]), bias[c]);
  }
}

}  // namespace

extern "C" int qr_tile_preprocess(
    const void* raw, const void* offsets, const void* ry_idx,
    const void* ry_w, const void* rx_idx, const void* rx_w,
    const void* scale, const void* bias, void* out, int n, int k, int H,
    int W, int tile, int crop, void* stream) {
  const long long total = (long long)n * tile * tile * 3;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  tile_preprocess_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const int*)offsets, (const int*)ry_idx,
      (const float*)ry_w, (const int*)rx_idx, (const float*)rx_w,
      (const float*)scale, (const float*)bias, (float*)out, total, k, H, W,
      tile, crop);
  return (int)cudaGetLastError();
}
