// The cooperative sec_attention* kernels (sec_attention.cu) at head dim
// 32, in a source of their own so that the head dims build in parallel.
#define SEC_HEAD_DIM 32
#include "sec_attention.cuh"
