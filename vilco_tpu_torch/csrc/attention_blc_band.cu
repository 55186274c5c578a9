// K6's forward (frame_band_fwd: the band mode of K1's forward kernels),
// built as a library of its own so that nvcc compiles its template
// instances beside those of csrc/attention_blc.cu instead of after them.

#define VILCO_FRAME_BAND
#include "attention_blc.cu"
