// Fused ingest: raw uint8 -> Resize -> CenterCrop -> Normalize, either for
// the selected tiles only (tile-first) or for the whole (crop, crop) image
// (staged), both by `tile_preprocess_kernel`: the staged image is the one
// tile of side crop at offset (0, 0).
//
// Replaces the Pallas kernels `fused_tile_preprocess`
// (src/repro/kernels/fused_tile_preprocess.py:68, pallas_call at :99, body
// `_kernel` :46) and `fused_preprocess` (src/repro/kernels/
// fused_preprocess.py:63, pallas_call at :79, body `_kernel` :57).  Both
// share the math `interp_affine`
// (fused_preprocess.py:32): per channel,
// scale_c * (Ry @ img_c @ Rx) + bias_c, run on the TPU as dense
// interpolation matmuls because gathers are slow on its vector unit.
//
// What bounds them on the H100: bytes.  Each output element costs four
// byte loads (mostly L1/L2 hits), twelve flops and one 4-byte store, so a
// kernel is bound by writing its float32 output and reading the raw pixels
// under it: at b = 32 and the default geometry the staged ingest needs the
// 6.3 MB of raw bytes under the crop and writes 25.2 MB, 9.4 us at 3.35
// TB/s.
//
// Design: Ry and Rx have at most two nonzeros per row (bilinear, edge
// clamp), so the dense products become a gather with two taps per axis.
// The host passes the (index, weight) pairs read off the very float32
// matrices the reference builds (`resize_matrix`); an edge-clamp row whose
// two taps were summed into one entry arrives as (i, i) with weights
// (w, 0).  Every output pixel goes through the one device function
// `interp_pixel`, which keeps the reference's order — vertical pass,
// horizontal pass, then *scale + bias — with __fmul_rn/__fadd_rn so nvcc
// does not contract it into FMAs.  So the staged image's pixel (row, col)
// is bit for bit the tile-first pixel at the same (row, col): staged
// ingest followed by the tile gather equals tile-first ingest exactly.
//
// `tile_preprocess_kernel`: a block owns `rows` output rows of one tile
// (tile-first: 256 / tile rows, 4 at tile 64, a thread a pixel; staged:
// kStagedPixels / crop rows, 4 at crop 256, a thread four pixels), a
// thread a pixel's three channels.  The block clamps its tile's offsets
// once (to [0, crop - l],
// as lax.dynamic_slice clamps them; the image is t / k, so the (b, k, 2)
// escalation form costs nothing extra), stages the (index, weight) pairs
// of its rows and of the tile's columns and the affine in shared memory,
// and does its index math in 32 bits.  Its output rows are contiguous in
// the (n, l, l, 3) output: the pixels land in shared memory (a thread's
// three channels 12 bytes apart, conflict-free) and leave as float4
// stores, coalesced.  The tables are one buffer (row pairs, column pairs,
// affine), so a launch passes four pointers.  The staged ingest passes no
// offsets (its one tile sits at (0, 0)).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Output pixel (row, col), channel c, of one image `im` (H, W, 3) uint8.
__device__ __forceinline__ float interp_pixel(
    const uint8_t* __restrict__ im, int W, int row, int col, int c,
    const int* __restrict__ ry_idx, const float* __restrict__ ry_w,
    const int* __restrict__ rx_idx, const float* __restrict__ rx_w,
    const float* __restrict__ scale, const float* __restrict__ bias) {
  const int r0 = ry_idx[2 * row], r1 = ry_idx[2 * row + 1];
  const float wr0 = ry_w[2 * row], wr1 = ry_w[2 * row + 1];
  const int c0 = rx_idx[2 * col], c1 = rx_idx[2 * col + 1];
  const float wc0 = rx_w[2 * col], wc1 = rx_w[2 * col + 1];
  im += c;
  const float p00 = (float)im[((long long)r0 * W + c0) * 3];
  const float p10 = (float)im[((long long)r1 * W + c0) * 3];
  const float p01 = (float)im[((long long)r0 * W + c1) * 3];
  const float p11 = (float)im[((long long)r1 * W + c1) * 3];
  // vertical pass (Ry @ img_c) at the two source columns
  const float v0 = __fadd_rn(__fmul_rn(wr0, p00), __fmul_rn(wr1, p10));
  const float v1 = __fadd_rn(__fmul_rn(wr0, p01), __fmul_rn(wr1, p11));
  // horizontal pass (@ Rx), then the normalising affine
  const float h = __fadd_rn(__fmul_rn(v0, wc0), __fmul_rn(v1, wc1));
  return __fadd_rn(__fmul_rn(h, scale[c]), bias[c]);
}

constexpr int kIngestThreads = 256;
constexpr int kStagedPixels = 1024;  // output pixels a staged block owns

// tables: ry_idx (crop, 2) int32 | ry_w (crop, 2) | rx_idx (crop, 2) int32
// | rx_w (crop, 2) | scale (3) | bias (3), 4-byte words; offsets (n, 2),
// or null for one tile at (0, 0)
__global__ void __launch_bounds__(kIngestThreads)
    tile_preprocess_kernel(const uint8_t* __restrict__ raw,
                           const int* __restrict__ offsets,
                           const int* __restrict__ tables,
                           float* __restrict__ out, int k, int H, int W,
                           int tile, int crop, int rows) {
  extern __shared__ float4 smem4[];
  int* s_ry_idx = reinterpret_cast<int*>(smem4);
  float* s_ry_w = reinterpret_cast<float*>(s_ry_idx + 2 * rows);
  int* s_rx_idx = reinterpret_cast<int*>(s_ry_w + 2 * rows);
  float* s_rx_w = reinterpret_cast<float*>(s_rx_idx + 2 * tile);
  float* s_aff = s_rx_w + 2 * tile;  // scale[3], bias[3], 2 unused
  float* s_out = s_aff + 8;          // 16-byte aligned: 4 (rows + tile) + 8
  const int groups = (tile + rows - 1) / rows;
  const int t = blockIdx.x / groups;
  const int r0 = (blockIdx.x - t * groups) * rows;
  const int nr = min(rows, tile - r0);
  const int max_off = crop - tile;
  const int oy = (offsets ? min(max(offsets[2 * t], 0), max_off) : 0) + r0;
  const int ox = offsets ? min(max(offsets[2 * t + 1], 0), max_off) : 0;
  const float* ry_w = reinterpret_cast<const float*>(tables + 2 * crop);
  const int* rx_idx = tables + 4 * crop;
  const float* rx_w = reinterpret_cast<const float*>(tables + 6 * crop);
  const float* aff = reinterpret_cast<const float*>(tables + 8 * crop);
  for (int e = threadIdx.x; e < 2 * nr; e += blockDim.x) {
    s_ry_idx[e] = tables[2 * oy + e];
    s_ry_w[e] = ry_w[2 * oy + e];
  }
  for (int e = threadIdx.x; e < 2 * tile; e += blockDim.x) {
    s_rx_idx[e] = rx_idx[2 * ox + e];
    s_rx_w[e] = rx_w[2 * ox + e];
  }
  if (threadIdx.x < 6) s_aff[threadIdx.x] = aff[threadIdx.x];
  __syncthreads();
  const uint8_t* im = raw + (long long)(t / k) * H * W * 3;
  const int npix = nr * tile;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / tile, j = p - i * tile;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s_out[3 * p + c] = interp_pixel(im, W, i, j, c, s_ry_idx, s_ry_w,
                                      s_rx_idx, s_rx_w, s_aff, s_aff + 3);
  }
  __syncthreads();
  // the block's rows, contiguous in the output
  float* o = out + ((long long)t * tile + r0) * tile * 3;
  const int n = 3 * npix;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      reinterpret_cast<float4*>(o)[e] = reinterpret_cast<float4*>(s_out)[e];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) o[e] = s_out[e];
  }
}

// dynamic shared memory of a block of `rows` rows of a tile
size_t ingest_smem(int rows, int tile) {
  return sizeof(float) * (4 * (rows + tile) + 8 + 3 * rows * tile);
}

}  // namespace

// tables as tile_preprocess_kernel reads them; n tiles (b * k), tile <= crop.
extern "C" int qr_tile_preprocess(const void* raw, const void* offsets,
                                  const void* tables, void* out, int n,
                                  int k, int H, int W, int tile, int crop,
                                  void* stream) {
  if (n <= 0 || tile <= 0 || tile > crop) return (int)cudaErrorInvalidValue;
  const int rows = tile < kIngestThreads ? kIngestThreads / tile : 1;
  const int groups = (tile + rows - 1) / rows;
  tile_preprocess_kernel<<<n * groups, kIngestThreads,
                           ingest_smem(rows, tile), (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const int*)offsets, (const int*)tables,
      (float*)out, k, H, W, tile, crop, rows);
  return (int)cudaGetLastError();
}

// The staged ingest: the whole (crop, crop) image of each of the b raw
// images, as the one tile of side crop at (0, 0); tables as above.
extern "C" int qr_preprocess(const void* raw, const void* tables, void* out,
                             int b, int H, int W, int crop, void* stream) {
  if (b <= 0 || crop <= 0) return (int)cudaErrorInvalidValue;
  const int rows = crop < kStagedPixels ? kStagedPixels / crop : 1;
  const int groups = (crop + rows - 1) / rows;
  tile_preprocess_kernel<<<b * groups, kIngestThreads,
                           ingest_smem(rows, crop), (cudaStream_t)stream>>>(
      (const uint8_t*)raw, nullptr, (const int*)tables, (float*)out, 1, H, W,
      crop, crop, rows);
  return (int)cudaGetLastError();
}
