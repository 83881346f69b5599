// K8 `e1_rcarry` with int16 TV carries (kernels and designs: e1_rcarry.cuh).
#include "e1_rcarry.cuh"

LPT_E1_RCARRY_ENTRY(int16_t)
