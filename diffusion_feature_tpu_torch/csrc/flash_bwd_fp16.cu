// The flash-attention backward for float16 inputs: the Hopper main pass of
// flash_bwd_hopper.cuh, one source per type so that the types build in
// parallel.

#include "flash_bwd_hopper.cuh"

// dq, dk, dv of B1/B2; the contract is at dft::bwd::backward in
// flash_bwd.cuh.  This library takes dtype 1 (float16) only.
DFT_FLASH_BACKWARD_ENTRY(__half, 1)
