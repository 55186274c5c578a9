// The VQ attention probe's variants of K1's forward (P2: bound_shift and
// mxu_sum, variants 1-3 of attention_blc_fwd), built as a library of their
// own so that nvcc compiles their template instances beside those of
// csrc/attention_blc.cu instead of after them.

#define VILCO_PROBE_VARIANTS
#include "attention_blc.cu"
