// K1-K3 on the tensor cores (flash_wgmma.cuh) for __nv_bfloat16 at D 64: one
// part of the flash_attention library, compiled on its own so that the
// parts build in parallel (ops/_build.py).
#include "flash_wgmma.cuh"

RTT_TC_INSTANCES(__nv_bfloat16, 64)
