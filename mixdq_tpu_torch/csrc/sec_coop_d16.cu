// The cooperative sec_attention* kernels (sec_attention.cu) at head dim
// 16, in a source of their own so that the head dims build in parallel.
#define SEC_HEAD_DIM 16
#include "sec_attention.cuh"
