// K8 `e1_rcarry` with bf16 TV carries (kernels and designs: e1_rcarry.cuh).
#include "e1_rcarry.cuh"

LPT_E1_RCARRY_ENTRY(__nv_bfloat16)
