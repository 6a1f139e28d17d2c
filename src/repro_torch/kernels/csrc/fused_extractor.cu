// Extractor decode kernels: the fp32 rung and the C entry points of all
// three rungs.  The kernels, their design and what they replace are in
// extractor.cuh; the bf16 and int8 rungs are instantiated in
// fused_extractor_bf16.cu and fused_extractor_int8.cu.
//
// `rung` selects the packed dtype: 0 fp32, 1 bf16, 2 int8 (the int8 convs
// and to_bits are fused_extractor_int8.cu's entry points; here int8 has
// only the head, fp32's).  Pointers are the rung's: x the fp32 layer
// input, w the packed weight in the rung's dtype, head_w / corr in the
// head's dtype (bf16 for the bf16 rung, else fp32).  Unused pointers may
// be null.  Each returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a shape it is not built for.
#include "extractor.cuh"

using namespace qr;

// fp32 / bf16 (the register-tiled kernel): cout in {8, 16, 24, 32, 64},
// cin in {3, 8, 16, 24, 32, 64}, l a multiple of 16; with cin > 3, x and
// w 16-byte aligned.  The int8 flat conv is qr_conv3x3_imma.
extern "C" int qr_conv3x3_norm_relu(const void* x, const void* w,
                                    const void* bias, void* out, int b, int l,
                                    int cin, int cout, int rung,
                                    void* stream) {
  const float *xf = (const float*)x, *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case 0: return FlatConv<RF32>::any(xf, w, bf, of, b, l, cin, cout, s);
    case 1: return FlatConv<RBF16>::any(xf, w, bf, of, b, l, cin, cout, s);
    default: return (int)cudaErrorInvalidValue;  // int8: qr_conv3x3_imma
  }
}

// Blocked schedule, fp32 / bf16: cout in {8, 16, 24, 32, 64}, cin 3 or
// cout, ct
// a multiple of 4 dividing cout, bb >= 1, l a multiple of 16, w 16-byte
// aligned.  The int8 blocked conv is qr_conv3x3_imma_blocked.
extern "C" int qr_conv3x3_norm_relu_blocked(const void* x, const void* w,
                                            const void* bias, void* out,
                                            int b, int l, int cin, int cout,
                                            int bb, int ct, int db, int rung,
                                            void* stream) {
  const float *xf = (const float*)x, *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case 0: return Extractor<RF32>::blocked_any(xf, w, bf, of, b, l, cin,
                                                cout, bb, ct, db, s);
    case 1: return Extractor<RBF16>::blocked_any(xf, w, bf, of, b, l, cin,
                                                 cout, bb, ct, db, s);
    default: return (int)cudaErrorInvalidValue;  // int8: *_imma_blocked
  }
}

// n_bits == 60 (the RS(15,12) GF(16) codeword).  fp32 / bf16: cin in
// {3, 8, 16, 24, 32, 64}, x and w 16-byte aligned.  corr and part_corr may
// be null when has_corr is 0.  The int8 to_bits is qr_conv3x3_gap_corr_imma.
extern "C" int qr_conv3x3_gap_corr(const void* x, const void* w,
                                   const void* bias, const void* tiles,
                                   const void* corr, void* part_gap,
                                   void* part_corr, int b, int l, int cin,
                                   int n_bits, int has_corr, int rung,
                                   void* stream) {
  const float *xf = (const float*)x, *bf = (const float*)bias,
              *tf = (const float*)tiles;
  float *pg = (float*)part_gap, *pc = (float*)part_corr;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case 0: return Extractor<RF32>::gap_corr(xf, w, bf, tf, corr, pg, pc, b,
                                             l, cin, n_bits, has_corr, s);
    case 1: return Extractor<RBF16>::gap_corr(xf, w, bf, tf, corr, pg, pc, b,
                                              l, cin, n_bits, has_corr, s);
    default: return (int)cudaErrorInvalidValue;  // int8: *_gap_corr_imma
  }
}

// embed may be null.  The int8 rung's head is fp32's (an fp32 head_w).
extern "C" int qr_extractor_head(const void* part_gap, const void* part_corr,
                                 const void* head_w, const void* head_b,
                                 const void* corr_scale, void* logits,
                                 void* embed, int b, int l, int n_bits,
                                 int has_corr, int rung, void* stream) {
  const float *pg = (const float*)part_gap, *pc = (const float*)part_corr,
              *hb = (const float*)head_b, *cs = (const float*)corr_scale;
  float *lg = (float*)logits, *em = (float*)embed;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case 0: return Extractor<RF32>::head(pg, pc, head_w, hb, cs, lg, em, b, l,
                                         n_bits, has_corr, s);
    case 1: return Extractor<RBF16>::head(pg, pc, head_w, hb, cs, lg, em, b,
                                          l, n_bits, has_corr, s);
    case 2: return Extractor<RF32>::head(pg, pc, head_w, hb, cs, lg, em, b, l,
                                         n_bits, has_corr, s);  // int8's head
    default: return (int)cudaErrorInvalidValue;
  }
}
