// flash_attention_bf16.cu -- the flash attention kernels of
// flash_attention16.cu for bfloat16 q, k, v: the forward (out in bfloat16)
// and the backward (dO in, dQ, dK, dV out in bfloat16; lse, the row sums
// and every accumulation in float32), on the tensor cores' bfloat16
// products. A library of its own, so that the three element types build in
// parallel.
#define FLASH_ELEMENT __nv_bfloat16
#include "flash_attention16.cu"
