// Kernels 2, 3 and 4 of ec_kernels.cu for a != 0 curves (RCB16 algorithm
// 1, NL = 8: ed25519), as a library of their own, so that nvcc builds
// them in parallel with the a = 0 library (ops/build.py).  Their C
// functions are ec_kernels.cu's with "_a" at the end of the name.

#define BP_GENERAL_A
#include "ec_kernels.cu"
