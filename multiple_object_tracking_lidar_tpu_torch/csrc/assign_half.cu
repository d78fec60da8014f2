// K4's half builds (dtype="bfloat16" / "float16"; greedy and Hungarian
// association, narrow and xl): assign.cu's kernels and its half entries
// (motl_track_step{,_xl}_{bf16,f16}), built from this file so that nvcc
// compiles them beside assign.cu's f32 and double builds, at once.  What
// they compute, what bounds them and how: assign.cu's header.

#define MOTL_ASSIGN_HALF
#include "assign.cu"
