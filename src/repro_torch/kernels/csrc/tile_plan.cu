// Escalation plans: per-image keys (n, 2) int64 holding uint32 words ->
// the (n, k, 2) int32 tile offsets of `tiling.escalation_offsets`
// (src/repro_torch/core/tiling.py), bit for bit, for the three strategies.
//
// Replaces no Pallas kernel: the JAX package draws its plans with
// jax.random under XLA (`escalation_offsets`, src/repro/core/tiling.py:136).
// The port draws them from the same Threefry-2x32 stream in int64 torch ops
// (core/prng.py), which costs ~2,100 small CPU ops a plan whatever its rows;
// the rs lanes run three such plans at once beside the ingest lane's and the
// feeder's draws, and the threads slow one another through the interpreter
// lock.  This kernel draws a plan in one launch and leaves it on the card,
// where the tile-first ingest reads it.
//
// What bounds it on the H100: the launch.  At the mixed cells' shape (a
// batch of 256 rows, `random_grid`, 16 cells, k = 3, one sort round) a row
// is a block of 32 threads; a thread runs ~8 Threefry blocks (~3 integer ops
// a round, 20 rounds) and 16 compares, and a row writes 24 bytes: a few
// microseconds of device time against a launch of a few.
//
// The draws, as core/prng.py defines them (JAX's partitionable threefry):
// fold_in(key, d) and key j of split(key) are threefry(key, (0, d)) and
// threefry(key, (0, j)); 32 random bits at index i are y0 ^ y1 of
// threefry(key, (0, i)); randint(key, 0, maxval) draws `higher` and `lower`
// from the two keys of split(key) and folds them into the span with uint32
// arithmetic.  Every uint32 product and sum here wraps as the torch form's
// `& MASK32` does, so the words are the same.
//
// Layout.  `random_grid` with k > 1 is a block a row (rows looped over
// the grid): column 0's cell c0 = randint(key, gy * gx); then
// permutation(fold_in(key, 0x5AFE), cells) — each round splits the key,
// draws 32 bits a position and sorts the positions stably by their bits
// (`rounds` = ceil(3 ln cells / ln(2^32 - 1)), computed by the wrapper as
// prng does) — and columns 1..k-1 are the permutation with c0 taken out.
// A position's new place is its rank: the count of positions whose (bits,
// index) is smaller, a stable sort with no data-dependent branch; the
// row's bits and the two position arrays live in shared memory (12 bytes
// a cell, up to the card's 227 KB a block), or, for larger grids, in a
// scratch buffer the wrapper allocates, a slot a block.  Every other plan
// (`fixed`, `random`, `random_grid` at k = 1) is a thread an entry (row,
// column): `random` column j > 0 draws from fold_in(key, 0x5AFE + j),
// `fixed` is raster order, column 0 is the one-tile draw.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFixed = 0, kRandom = 1, kGrid = 2;  // tile_plan.STRATEGIES
constexpr uint32_t kSalt = 0x5AFE;                 // tiling._ESC_SALT
constexpr int kMaxRowThreads = 256;
constexpr int kDrawThreads = 128;
constexpr int kMaxDrawBlocks = 8192;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kStaticSmem = 16;  // s_p, as ptxas -v reports it

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, A) ^ x0;
  x0 += x1; x1 = rotl(x1, B) ^ x0;
  x0 += x1; x1 = rotl(x1, C) ^ x0;
  x0 += x1; x1 = rotl(x1, D) ^ x0;
}

// Threefry-2x32, 20 rounds: key, counter (x0, x1) -> (y0, y1)
__device__ __forceinline__ Key threefry(Key key, uint32_t x0, uint32_t x1) {
  const uint32_t ks0 = key.k0, ks1 = key.k1;
  const uint32_t ks2 = key.k0 ^ key.k1 ^ 0x1BD11BDAu;
  x0 += ks0; x1 += ks1;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks1; x1 += ks2 + 1u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += ks2; x1 += ks0 + 2u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks0; x1 += ks1 + 3u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += ks1; x1 += ks2 + 4u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks2; x1 += ks0 + 5u;
  return {x0, x1};
}

__device__ __forceinline__ uint32_t bits_at(Key key, uint32_t i) {
  const Key y = threefry(key, 0u, i);
  return y.k0 ^ y.k1;
}

// randint(key, (), 0, maxval): maxval <= 0 is the span 1 (always 0)
__device__ __forceinline__ uint32_t randint(Key key, int maxval) {
  const uint32_t span = maxval <= 0 ? 1u : (uint32_t)maxval;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t higher = bits_at(threefry(key, 0u, 0u), 0u);
  const uint32_t lower = bits_at(threefry(key, 0u, 1u), 0u);
  return ((higher % span) * mult + lower % span) % span;
}

__device__ __forceinline__ Key load_key(const long long* keys, long long row) {
  return {(uint32_t)keys[2 * row], (uint32_t)keys[2 * row + 1]};
}

__device__ __forceinline__ int2 cell_offset(uint32_t cell, int gx, int tile) {
  return make_int2((int)(cell / gx) * tile, (int)(cell % gx) * tile);
}

// per_image_offsets("random", key): (randint(y key), randint(x key))
__device__ __forceinline__ int2 random_offset(Key key, int H, int W,
                                              int tile) {
  return make_int2((int)randint(threefry(key, 0u, 0u), H - tile + 1),
                   (int)randint(threefry(key, 0u, 1u), W - tile + 1));
}

// `random_grid`, k > 1: one row at a time per block; `buf` holds the bits,
// the positions and the next positions, `cells` words each.
__device__ void grid_rows(const long long* __restrict__ keys,
                          int2* __restrict__ plan, uint32_t* buf, int n,
                          int k, int H, int W, int tile, int rounds) {
  __shared__ uint32_t s_p;  // c0's place in the final permutation
  const int gx = W / tile, cells = (H / tile) * gx;
  uint32_t* bits = buf;
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    uint32_t* x = buf + cells;
    uint32_t* xn = buf + 2 * cells;
    const Key key = load_key(keys, row);
    const uint32_t c0 = randint(key, cells);
    if (threadIdx.x == 0) plan[(long long)row * k] = cell_offset(c0, gx, tile);
    Key pk = threefry(key, 0u, kSalt);
    for (int i = threadIdx.x; i < cells; i += blockDim.x) x[i] = i;
    for (int r = 0; r < rounds; ++r) {
      const Key sub = threefry(pk, 0u, 1u);
      pk = threefry(pk, 0u, 0u);
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        bits[i] = bits_at(sub, (uint32_t)i);
      __syncthreads();
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const uint32_t b = bits[i];
        int rank = 0;
        for (int j = 0; j < cells; ++j) {
          const uint32_t bj = bits[j];
          rank += (bj < b) + (bj == b && j < i);
        }
        xn[rank] = x[i];
      }
      __syncthreads();
      uint32_t* t = x; x = xn; xn = t;
    }
    for (int i = threadIdx.x; i < cells; i += blockDim.x)
      if (x[i] == c0) s_p = i;
    __syncthreads();
    const int p = (int)s_p;
    // column c + 1 is place c of the permutation without c0
    for (int i = threadIdx.x; i < cells && i < k; i += blockDim.x) {
      const int col = i < p ? i + 1 : i;
      if (i != p && col < k)
        plan[(long long)row * k + col] = cell_offset(x[i], gx, tile);
    }
    __syncthreads();  // the next row rewrites the buffers
  }
}

// every other plan: a thread an entry (row, column)
__device__ void draws(const long long* __restrict__ keys,
                      int2* __restrict__ plan, int n, int k, int strategy,
                      int H, int W, int tile) {
  const int gx = W / tile, cells = (H / tile) * gx;
  const long long total = (long long)n * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / k;
    const int col = (int)(e - row * k);
    int2 o;
    if (strategy == kFixed) {
      o = cell_offset((uint32_t)col, gx, tile);
    } else {
      const Key key = load_key(keys, row);
      if (strategy == kRandom)
        o = random_offset(col == 0 ? key : threefry(key, 0u, kSalt + col),
                          H, W, tile);
      else
        o = cell_offset(randint(key, cells), gx, tile);
    }
    plan[e] = o;
  }
}

__global__ void escalation_plan_kernel(const long long* __restrict__ keys,
                                       int2* __restrict__ plan,
                                       uint32_t* __restrict__ scratch, int n,
                                       int k, int strategy, int H, int W,
                                       int tile, int rounds) {
  extern __shared__ uint32_t smem[];
  if (strategy == kGrid && k > 1) {
    const int cells = (H / tile) * (W / tile);
    grid_rows(keys, plan,
              scratch ? scratch + (size_t)blockIdx.x * 3 * cells : smem, n,
              k, H, W, tile, rounds);
  } else {
    draws(keys, plan, n, k, strategy, H, W, tile);
  }
}

}  // namespace

// keys (n, 2) int64, plan (n, k, 2) int32; the wrapper has checked k
// against the strategy's cap, tile against the image and that the grid has
// a column.  `scratch_rows` 0: a `random_grid` row's arrays live in shared
// memory; else `scratch` holds that many rows' 3 * cells words and the
// grid has as many blocks.
extern "C" int qr_escalation_plan(const void* keys, void* plan, void* scratch,
                                  int n, int k, int strategy, int H, int W,
                                  int tile, int rounds, int scratch_rows,
                                  void* stream) {
  if (n <= 0 || k <= 0 || tile <= 0 || strategy < kFixed ||
      strategy > kGrid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (strategy == kGrid && k > 1) {
    const int cells = (H / tile) * (W / tile);
    const int threads = min(kMaxRowThreads, (cells + 31) / 32 * 32);
    size_t smem = 0;
    int blocks = n;
    if (scratch_rows > 0) {
      blocks = min(n, scratch_rows);
    } else {
      smem = (size_t)3 * cells * sizeof(uint32_t);
      // the block's static word counts against the default 48 KB too
      if (smem + kStaticSmem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            escalation_plan_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
    }
    escalation_plan_kernel<<<blocks, threads, smem, s>>>(
        (const long long*)keys, (int2*)plan, (uint32_t*)scratch, n, k,
        strategy, H, W, tile, rounds);
  } else {
    const long long total = (long long)n * k;
    const long long want = (total + kDrawThreads - 1) / kDrawThreads;
    const int blocks = (int)(want < kMaxDrawBlocks ? want : kMaxDrawBlocks);
    escalation_plan_kernel<<<blocks, kDrawThreads, 0, s>>>(
        (const long long*)keys, (int2*)plan, nullptr, n, k, strategy, H, W,
        tile, rounds);
  }
  return (int)cudaGetLastError();
}
