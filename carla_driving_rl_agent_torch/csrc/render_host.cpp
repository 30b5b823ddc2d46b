// Host build of the render kernel's arithmetic (render.cuh), compiled with
// g++ so that the CPU tests can hold the CUDA kernel's math against the
// plain PyTorch version on a machine without a GPU.  It runs the kernel's
// two stages in the kernel's order: the per-world stage, then every quad.
// Same arguments and output layout as cdrl_render_planes in render.cu,
// without the launch shape.

#include <cstring>

#include "render.cuh"

extern "C" void cdrl_render_planes_host(const float* geom, const float* lut,
                                        uint8_t* out, int n_worlds,
                                        int with_depth, int n_actors) {
  const int channels = with_depth ? 4 : 3;
  for (int wi = 0; wi < n_worlds; ++wi) {
    cdrl::WorldConsts w;
    for (int item = 0; item < cdrl::STAGE_ITEMS; ++item) {
      cdrl::stage_world(geom + static_cast<size_t>(wi) * cdrl::GEOM_PAD, n_actors, item, w);
    }
    uint8_t* base = out + static_cast<size_t>(wi) * channels * cdrl::PLANE;
    for (int q = 0; q < cdrl::N_QUADS; ++q) {
      uint32_t words[4];
      const int off = cdrl::render_quad(w, lut, q, n_actors, with_depth, words);
      for (int c = 0; c < channels; ++c) {
        std::memcpy(base + c * cdrl::PLANE + off, &words[c], sizeof(uint32_t));
      }
    }
  }
}

// The kernel's helpers over arrays, for the tests: even_floor(x[i]) and
// the fmodf form it replaces; div_rn(a[i], b[i], 1 / b[i]) and a[i] / b[i].
extern "C" void cdrl_render_helpers_host(const float* x, uint8_t* even, uint8_t* even_ref,
                                         const float* a, const float* b, float* q,
                                         float* q_ref, int n) {
  for (int i = 0; i < n; ++i) {
    even[i] = cdrl::even_floor(x[i]);
    even_ref[i] = fmodf(floorf(x[i]), 2.0f) == 0.0f;
    q[i] = cdrl::div_rn(a[i], b[i], 1.0f / b[i]);
    q_ref[i] = a[i] / b[i];
  }
}
