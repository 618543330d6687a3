// Grid-wide barrier of the persistent cooperative kernels (dit_mega.cu,
// vae_resunit.cu).  Every block must be resident: the kernels are launched with
// cudaLaunchCooperativeKernel on a grid sized from the occupancy query.
//
// sync[0] counts arrivals, sync[1] is the generation word.  The last block to
// arrive resets the counter before it bumps the generation, so the counter is
// 0 again for the next barrier and after the launch; the others spin on the
// generation.  The fences publish every write of the block before it arrives
// and order the reads after it leaves.
#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ void grid_barrier(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}
