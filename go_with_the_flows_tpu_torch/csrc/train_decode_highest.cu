// Kernels 7 and 8 at 'highest' (MODE 0): train_decode.cuh's instantiations
// and entry points for this mode (gwtf_train_decode_*_highest), which
// train_decode.cu's entry points call.

#define GWTF_TRAIN_DECODE_MODE kHighest
#define GWTF_TRAIN_DECODE_MODE_NAME highest
#include "train_decode.cuh"
