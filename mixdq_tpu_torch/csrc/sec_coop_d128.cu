// The cooperative sec_attention* kernels (sec_attention.cu) at head dim
// 128, in a source of their own so that the head dims build in parallel.
#define SEC_HEAD_DIM 128
#include "sec_attention.cuh"
