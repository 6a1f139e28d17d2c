// Extractor decode kernels, bf16 rung (see extractor.cuh): bf16 weights
// and bf16-rounded activations, exact products, fp32 sums.
#include "extractor.cuh"

namespace qr {
template struct Extractor<RBF16>;
template struct FlatConv<RBF16>;
}  // namespace qr
