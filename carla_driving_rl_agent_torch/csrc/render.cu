// CUDA render kernel for Hopper (sm_90a): the three-camera ray caster of
// the environment, one thread per quad of 4 adjacent pixels.
//
// Replaces the Pallas TPU kernel `_render_kernel` / `_render_world` of
// carla_driving_rl_agent_tpu/ops/rasterizer_pallas.py (entry points
// render_tile and render_tiles_grid).  The TPU kernel flattened the 8100
// pixels of one world into a (64, 128) vector tile; here a 2-D grid runs
// (splits of a world's 2025 quads) x (worlds), and each block writes the
// (B, C, 45, 180) uint8 planar frame storage directly, so the TPU path's
// tile_to_planes epilogue (with its front-view-only depth plane) is folded
// in.
//
// What bounds it on the H100: per pixel it reads 16 bytes of LUT and
// writes 3 (or 4) bytes, against ~190 float operations for every pixel
// and ~320 more where the ground shows (12 segment distances, 4 junction
// distances; chip_smoke.py counts them): it is bound by issued
// instructions, not by memory.  The design cuts the instructions a pixel
// issues:
//   * a per-world stage (render.cuh::stage_world) computes once per block,
//     into shared memory, what a pixel of the first port recomputed: the
//     segments' vectors, lengths and reciprocals, the buildings' slab
//     offsets (sorted for each quadrant of ray directions, so that a ray
//     meets them in order and needs no min/max), the sky, light,
//     wet-road and fog coefficients, and every actor's billboard in each
//     view (its projection's four divisions); the LUT carries the
//     per-ray ground distance (ops/render.py);
//   * the buildings come first, and the road and junction distances are
//     computed only for quads where the ground shows: above the horizon
//     (half the rays) and behind a building they decide nothing;
//   * a thread renders 4 pixels of one row, so the stage's shared loads,
//     the index arithmetic and an actor's row test are paid once per 4
//     pixels, and each channel is one 32-bit store;
//   * the per-pixel divisions by a segment's L2, by 0.6 and by 150 are
//     exact FMA corrections of a product with a hoisted reciprocal
//     (render.cuh::div_rn), the ray reciprocals skip the range test their
//     operands never need (rcp_rn), and the parity test needs no fmodf;
//   * a pixel visits only the actors whose billboard spans its row.
// Every float result is the first port's and the plain version's bit for
// bit: the hoisted values use the same operations in the same order, and
// the build passes --fmad=false (ops/render.py) so that no multiply-add
// is contracted; sqrt, the reciprocals, exp and log1p stay IEEE-accurate
// (no fast-math).  The launch shape (ops/render.py::launch_shape) gives few
// worlds large blocks and many worlds small ones.

#include <cuda_runtime.h>

#include "render.cuh"

namespace {

constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
render_kernel(const float* __restrict__ geom, const float* __restrict__ lut,
              uint8_t* __restrict__ out, int with_depth, int n_actors, int quads_per_block) {
  __shared__ cdrl::WorldConsts w;
  const int world = blockIdx.y;
  if (threadIdx.x < cdrl::STAGE_ITEMS) {
    cdrl::stage_world(geom + static_cast<size_t>(world) * cdrl::GEOM_PAD, n_actors,
                      threadIdx.x, w);
  }
  __syncthreads();
  uint8_t* base = out + static_cast<size_t>(world) * (with_depth ? 4 : 3) * cdrl::PLANE;
  const int q_end = min((static_cast<int>(blockIdx.x) + 1) * quads_per_block, cdrl::N_QUADS);
  for (int q = blockIdx.x * quads_per_block + threadIdx.x; q < q_end; q += blockDim.x) {
    uint32_t words[4];
    const int off = cdrl::render_quad(w, lut, q, n_actors, with_depth, words);
    uint32_t* dst = reinterpret_cast<uint32_t*>(base + off);
    dst[0] = words[0];
    dst[cdrl::PLANE / 4] = words[1];
    dst[2 * cdrl::PLANE / 4] = words[2];
    if (with_depth) dst[3 * cdrl::PLANE / 4] = words[3];
  }
}

}  // namespace

// geom (n_worlds, 176) f32, lut (4, 8100) f32, out (n_worlds, C, 45, 180)
// u8, all contiguous on the current device (out 4-byte aligned).  A world's
// 2025 quads are split over `splits` blocks of `threads` threads.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int cdrl_render_planes(const float* geom, const float* lut, uint8_t* out,
                                  int n_worlds, int with_depth, int n_actors,
                                  int threads, int splits, void* stream) {
  if (threads < cdrl::STAGE_ITEMS || threads > kMaxThreads || threads % 32 != 0 ||
      splits < 1 || splits > cdrl::N_QUADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quads_per_block = (cdrl::N_QUADS + splits - 1) / splits;
  const dim3 grid(splits, n_worlds);
  render_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, lut, out, with_depth, n_actors, quads_per_block);
  return static_cast<int>(cudaGetLastError());
}
