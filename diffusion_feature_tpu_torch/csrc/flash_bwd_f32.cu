// The flash-attention backward for float32 inputs (flash_bwd.cuh), one
// source per type so that the types build in parallel.

#include "flash_bwd.cuh"

// dq, dk, dv of B1/B2; the contract is at dft::bwd::backward in
// flash_bwd.cuh.  This library takes dtype 0 (float32) only.
DFT_FLASH_BACKWARD_ENTRY(float, 0)
