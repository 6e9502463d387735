// flash_attention_bf16.cu -- the flash attention kernels of
// flash_attention.cu for bfloat16 q, k, v: the forward (out in bfloat16)
// and the backward (dO in, dQ, dK, dV out in bfloat16; lse, the row sums
// and every accumulation in float32). A library of its own, so that
// flash_attention.cu's three element types build in parallel.
#define FLASH_ELEMENT __nv_bfloat16
#include "flash_attention.cu"
