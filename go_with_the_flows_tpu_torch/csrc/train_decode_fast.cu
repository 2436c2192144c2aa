// Kernels 7 and 8 at 'fast' (MODE 2): train_decode.cuh's instantiations
// and entry points for this mode (gwtf_train_decode_*_fast), which
// train_decode.cu's entry points call.

#define GWTF_TRAIN_DECODE_MODE kFast
#define GWTF_TRAIN_DECODE_MODE_NAME fast
#include "train_decode.cuh"
