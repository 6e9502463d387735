// flash_attention_f16.cu -- the flash attention kernels of
// flash_attention16.cu for float16 q, k, v: the forward (out in float16)
// and the backward (dO in, dQ, dK, dV out in float16; lse, the row sums
// and every accumulation in float32), on the tensor cores' float16
// products. A library of its own, so that the three element types build in
// parallel.
#define FLASH_ELEMENT __half
#include "flash_attention16.cu"
