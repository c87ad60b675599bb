// The flash-attention backward for bfloat16 inputs (flash_bwd.cuh), one
// source per type so that the types build in parallel.

#include "flash_bwd.cuh"

// dq, dk, dv of B1/B2; the contract is at dft::bwd::backward in
// flash_bwd.cuh.  This library takes dtype 2 (bfloat16) only.
DFT_FLASH_BACKWARD_ENTRY(__nv_bfloat16, 2)
