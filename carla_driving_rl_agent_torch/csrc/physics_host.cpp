// Host build of the physics kernel's per-world arithmetic (physics.cuh),
// compiled with g++ so that the CPU tests can hold the CUDA kernel's math
// against the plain PyTorch version and the JAX package on a machine
// without a GPU.  Same argument layout as cdrl_physics_step in physics.cu.

#include "physics.cuh"

extern "C" void cdrl_physics_step_host(const cdrl::PhysicsArgs* args) {
  for (int i = 0; i < args->n_worlds; ++i) cdrl::step_world_ticks(*args, i);
}
