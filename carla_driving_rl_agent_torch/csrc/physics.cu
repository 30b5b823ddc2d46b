// CUDA physics kernel for Hopper (sm_90a): K ticks of every world without
// NPC traffic, auto-reset merges included, one thread per world.
//
// Replaces the Pallas TPU kernel `_step_kernel` of
// carla_driving_rl_agent_tpu/ops/physics_pallas.py (entry point
// step_physics_batch_fused), and with K > 1 the `lax.scan` of a rollout
// block's ticks around it (carla_driving_rl_agent_tpu/agents/rollout.py).
// The TPU version put worlds across vector lanes and left to XLA what lanes
// cannot do: the control and bicycle prologue, the bank gathers (route
// window, cell segments, route length, destination, road half-width), the
// int merges.  A CUDA thread gathers for itself, so this kernel folds all
// of that in and writes the merged state, each tick's reward, flags and
// info directly (physics.cuh, step_world_ticks).
//
// What bounds it on the H100: per world and tick it reads ~0.3 kB (the
// route window, 24 cell segments, the action and reset draws) and writes
// ~20 B, against ~700 float operations; at the 32-1024 worlds of training
// and the env bench that is 10-400 kB and at most 0.7 MFLOP per tick, far
// below a microsecond of memory or arithmetic time: a call costs its
// launch and its host path.  So one launch runs a whole rollout block (K =
// past_obs_freq ticks, whose actions the policy drew before the block),
// each world's state in registers from the first tick to the last, and the
// host packs, allocates and draws once per block instead of once per tick.
//
// Built by utils/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no fast-math flags: sin, cos, tan, atan, atan2, sqrt and the divisions
// stay the IEEE-accurate CUDA math functions that PyTorch's kernels call.

#include <cuda_runtime.h>

#include "physics.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) physics_kernel(cdrl::PhysicsArgs args) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < args.n_worlds) cdrl::step_world_ticks(args, i);
}

}  // namespace

// args->n_ticks ticks of args->n_worlds worlds on `stream`.  `args` is read on the
// host and passed to the kernel by value.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int cdrl_physics_step(const cdrl::PhysicsArgs* args, void* stream) {
  const int blocks = (args->n_worlds + kThreads - 1) / kThreads;
  physics_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
