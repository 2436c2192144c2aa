// Kernels 7 and 8 at 'high' (MODE 1): train_decode.cuh's instantiations
// and entry points for this mode (gwtf_train_decode_*_high), which
// train_decode.cu's entry points call.

#define GWTF_TRAIN_DECODE_MODE kHigh
#define GWTF_TRAIN_DECODE_MODE_NAME high
#include "train_decode.cuh"
