// CUDA kernels of the fused stride-1 ShuffleNet-V2 unit for Hopper (sm_90a):
// inference, training forward with the three BatchNorms' batch statistics,
// and training backward.
//
// Replace the Pallas TPU kernels of carla_driving_rl_agent_tpu/ops/
// shuffle_unit_pallas.py: `_make_infer_kernel` / `_make_infer_halo_kernel`
// (entry shuffle_unit_infer), `_make_fwd_kernel` / `_make_fwd_halo_kernel`
// (_run_fwd, via shuffle_unit_train) and `_make_bwd_kernel` /
// `_make_bwd_halo_kernel` (_run_bwd, the custom_vjp backward).  The TPU
// kernels ran a sequential (4 passes x row tiles) grid that carried the
// BatchNorm sums in VMEM from one grid step to the next, padded channels to
// 128 lanes and absorbed the split and the shuffle into placement matmuls.
// On the card blocks run in parallel and in no order, so each kernel here
// is a short fixed sequence of launches on one stream: a stage over tiles of
// 32 pixels writes per-tile partial sums, a finalising launch reduces them
// in a fixed order (no float atomics: two runs give the same bits), and the
// next stage reads the result.  The depthwise reads its 3x3 neighbours
// directly from the NCHW tensors (no halo), the split and the shuffle are
// index arithmetic on the channel (shuffle_unit.cuh), and everything is in
// true float32 (or float64), as the plain version computes on the card with
// TF32 off.
//
// Thread mapping: a block of 8 warps owns a tile of 32 consecutive pixels
// (flattened n * H * W + y * W + x); a lane is a pixel, so every load and
// store of one channel is coalesced along H * W, and a warp walks the
// channels.  The 1x1 products stage the tile's input channels in shared
// memory and give each warp 4 output channels at a time, the weights read as
// warp-uniform broadcasts.  The weight gradients are tiled products over
// pixel segments, reduced by a finalising launch.
//
// What bounds it on the H100: at the training path's largest map (256 x 58
// x 11 x 45 per half) a unit moves ~0.1-0.3 GB and does ~2 GFLOP per pass,
// ~0.03-0.1 ms at the card's peaks.  These first kernels are simple, not
// tiled for the tensor cores (FP32 has none) or for TMA: their times stand
// beside their bounds in PERF.md.
//
// Built by utils/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no fast-math flags.

#include <cuda_runtime.h>

#include "shuffle_unit.cuh"

namespace {

using namespace cdrl::unit;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int OT = 4;                 // output channels per warp and pass

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  // butterfly: every lane ends with the same bits (each step adds a pair in
  // both orders, and IEEE addition commutes)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Tile partials of one channel over the warp's lanes: the sum and the sum of
// squared deviations from the tile's mean; lane 0 writes them.
template <class T>
__device__ __forceinline__ void tile_stats(T z, bool valid, int cnt, T* sum, T* m2) {
  const T s = warp_sum(valid ? z : T(0));
  const T d = valid ? z - s / T(cnt) : T(0);
  const T q = warp_sum(d * d);
  if ((threadIdx.x & 31) == 0) {
    *sum = s;
    *m2 = q;
  }
}

template <class T>
__device__ __forceinline__ void tile_sum(T v, T* out) {
  const T s = warp_sum(v);
  if ((threadIdx.x & 31) == 0) *out = s;
}

struct Lane {
  int lane, warp;
  int64_t blk, q;
  bool valid;
  int cnt;
};

__device__ __forceinline__ Lane lane_of(const Geo& g) {
  Lane l;
  l.lane = threadIdx.x & 31;
  l.warp = threadIdx.x >> 5;
  l.blk = blockIdx.x;
  l.q = l.blk * TILE + l.lane;
  l.valid = l.q < g.p;
  l.cnt = tile_count(g.p, l.blk);
  return l;
}

// out[oo][lane] = sum_k w[oo * rs + k * cs] * s[k * TILE + lane] for the warp's
// OT channels oo = o0 .. o0 + OT - 1 (clamped reads past hc)
template <class T>
__device__ __forceinline__ void dot_tile(const T* w, int rs, int cs, const T* s, int hc,
                                         int o0, int lane, T* acc) {
  const T* wr[OT];
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    wr[j] = w + min(o0 + j, hc - 1) * rs;
    acc[j] = T(0);
  }
  for (int k = 0; k < hc; ++k) {
    const T v = s[k * TILE + lane];
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[j] += __ldg(wr[j] + k * cs) * v;
  }
}

template <class T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// ---------------------------------------------------------------------------
// stage kernels
// ---------------------------------------------------------------------------

// z1 = W1 . branch + b1.  Inference writes a1 = act(BN1(z1)) on the running
// statistics into z1; training writes z1 and its tile partials.
template <class T, bool kTrain>
__global__ void __launch_bounds__(kThreads) k_pw1(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  T* xs = smem<T>();
  for (int k = l.warp; k < hc; k += kWarps)
    xs[k * TILE + l.lane] = l.valid ? o.x[at(g, l.q, hc + k, g.c)] : T(0);
  __syncthreads();
  T* part = o.partial + l.blk * 2 * hc;
  for (int o0 = l.warp * OT; o0 < hc; o0 += kWarps * OT) {
    T acc[OT];
    dot_tile(o.w1, hc, 1, xs, hc, o0, l.lane, acc);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int oo = o0 + j;
      if (oo >= hc) break;
      const T z = acc[j] + o.b1[oo];
      const int64_t i = at(g, l.q, oo, hc);
      if (kTrain) {
        if (l.valid) o.z1[i] = z;
        tile_stats(z, l.valid, l.cnt, part + oo, part + hc + oo);
      } else if (l.valid) {
        o.z1[i] = act(bn(z, o.m1[oo], rstd(o.v1[oo], o.eps), o.g1[oo], o.be1[oo]), o.leak);
      }
    }
  }
}

// Inference after the first product: depthwise, BN2, W3, BN3, act, written
// to the branch's shuffled channels; the shortcut copied to its own.
template <class T>
__global__ void __launch_bounds__(kThreads) k_tail_infer(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  T* bs = smem<T>();
  for (int k = l.warp; k < hc; k += kWarps) {
    T v = T(0);
    if (l.valid) {
      const T z2 = depthwise(o, g, l.q, k, [&](int64_t nb) { return o.z1[at(g, nb, k, hc)]; });
      v = bn(z2, o.m2[k], rstd(o.v2[k], o.eps), o.g2[k], o.be2[k]);
      o.out[at(g, l.q, shuffle_dest(g.c, k), g.c)] = o.x[at(g, l.q, k, g.c)];
    }
    bs[k * TILE + l.lane] = v;
  }
  __syncthreads();
  for (int o0 = l.warp * OT; o0 < hc; o0 += kWarps * OT) {
    T acc[OT];
    dot_tile(o.w3, hc, 1, bs, hc, o0, l.lane, acc);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int oo = o0 + j;
      if (oo >= hc) break;
      if (l.valid) {
        const T y = act(bn(acc[j] + o.b3[oo], o.m3[oo], rstd(o.v3[oo], o.eps), o.g3[oo],
                           o.be3[oo]), o.leak);
        o.out[at(g, l.q, shuffle_dest(g.c, hc + oo), g.c)] = y;
      }
    }
  }
}

// Training: z2 = depthwise(act(BN1(z1))) + dwb on the batch statistics of
// BN1, saved, with its tile partials.
template <class T>
__global__ void __launch_bounds__(kThreads) k_dw_train(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  T* part = o.partial + l.blk * 2 * hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps);
    T z2 = T(0);
    if (l.valid) {
      z2 = depthwise(o, g, l.q, k, [&](int64_t nb) { return a1_at(o, g, nb, k, m1, r1); });
      o.z2[at(g, l.q, k, hc)] = z2;
    }
    tile_stats(z2, l.valid, l.cnt, part + k, part + hc + k);
  }
}

// Training: u = W3 . BN2(z2) + b3, saved, with its tile partials.
template <class T>
__global__ void __launch_bounds__(kThreads) k_pw3_train(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  T* bs = smem<T>();
  for (int k = l.warp; k < hc; k += kWarps)
    bs[k * TILE + l.lane] =
        l.valid ? b2n_at(o, g, l.q, k, o.m2[k], rstd(o.v2[k], o.eps)) : T(0);
  __syncthreads();
  T* part = o.partial + l.blk * 2 * hc;
  for (int o0 = l.warp * OT; o0 < hc; o0 += kWarps * OT) {
    T acc[OT];
    dot_tile(o.w3, hc, 1, bs, hc, o0, l.lane, acc);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int oo = o0 + j;
      if (oo >= hc) break;
      const T u = acc[j] + o.b3[oo];
      if (l.valid) o.u[at(g, l.q, oo, hc)] = u;
      tile_stats(u, l.valid, l.cnt, part + oo, part + hc + oo);
    }
  }
}

// Training: out = shuffle(concat(shortcut, act(BN3(u)))).
template <class T>
__global__ void __launch_bounds__(kThreads) k_out_train(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  if (!l.valid) return;
  const int hc = g.hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    const T u = o.u[at(g, l.q, k, hc)];
    o.out[at(g, l.q, shuffle_dest(g.c, hc + k), g.c)] =
        act(bn(u, o.m3[k], rstd(o.v3[k], o.eps), o.g3[k], o.be3[k]), o.leak);
    o.out[at(g, l.q, shuffle_dest(g.c, k), g.c)] = o.x[at(g, l.q, k, g.c)];
  }
}

// Mean and biased variance of each channel from the tile partials
// [tile][sum, m2][hc]; one warp per channel, lanes striding over the tiles,
// then the same two-step merge as shuffle_unit.cuh's `merge`.
template <class T>
__global__ void __launch_bounds__(kThreads) k_stats_final(UnitArgs a, T* mean, T* var) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= g.hc) return;
  const int64_t n_tiles = (g.p + TILE - 1) / TILE;
  const int64_t stride = 2 * g.hc;
  T s = T(0);
  for (int64_t b = lane; b < n_tiles; b += 32) s += o.partial[b * stride + k];
  const T m = warp_sum(s) / T(g.p);
  T m2 = T(0);
  for (int64_t b = lane; b < n_tiles; b += 32) {
    const T nb = T(tile_count(g.p, b));
    const T d = o.partial[b * stride + k] / nb - m;
    m2 += o.partial[b * stride + g.hc + k] + nb * d * d;
  }
  m2 = warp_sum(m2);
  if (lane == 0) {
    mean[k] = m;
    var[k] = m2 / T(g.p);
  }
}

// dst[r * rs + c * cs] = sum over b of src[b * stride + r * ncols + c], for
// r < nrows, c < ncols; one warp per entry, a fixed order.
template <class T>
__global__ void __launch_bounds__(kThreads) k_sum_final(const T* src, int64_t nb,
                                                        int64_t stride, int nrows, int ncols,
                                                        T* dst, int rs, int cs) {
  const int lane = threadIdx.x & 31;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (e >= static_cast<int64_t>(nrows) * ncols) return;
  T s = T(0);
  for (int64_t b = lane; b < nb; b += 32) s += src[b * stride + e];
  s = warp_sum(s);
  if (lane == 0) dst[(e / ncols) * rs + (e % ncols) * cs] = s;
}

// Backward 1: BN3's sums, partials [tile][sum g_a3 xh3, sum g_a3][hc].
template <class T>
__global__ void __launch_bounds__(kThreads) k_bn3_sums(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  T* part = o.partial + l.blk * 2 * hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    T ga = T(0), xh = T(0);
    if (l.valid) ga = ga3_at(o, g, l.q, k, o.m3[k], rstd(o.v3[k], o.eps), &xh);
    tile_sum(ga * xh, part + k);
    tile_sum(ga, part + hc + k);
  }
}

// Backward 2: g_u on the tile (and its sums, the bias gradient of W3's
// conv), g_b2n = W3^T g_u saved, BN2's sums; partials [tile][sum g_b2n xh2,
// sum g_b2n, sum g_u][hc].
template <class T>
__global__ void __launch_bounds__(kThreads) k_pw3_back(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  const T* s2 = o.dvec + D_G3 * hc;
  const T* s1 = o.dvec + D_BE3 * hc;
  T* gs = smem<T>();
  T* part = o.partial + l.blk * 3 * hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    T gu = T(0);
    if (l.valid) gu = gu_at(o, g, l.q, k, o.m3[k], rstd(o.v3[k], o.eps), s1[k], s2[k], inv_m);
    gs[k * TILE + l.lane] = gu;
    tile_sum(gu, part + 2 * hc + k);
  }
  __syncthreads();
  for (int o0 = l.warp * OT; o0 < hc; o0 += kWarps * OT) {
    T acc[OT];
    dot_tile(o.w3, 1, hc, gs, hc, o0, l.lane, acc);      // column o0 + j of W3
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int kk = o0 + j;
      if (kk >= hc) break;
      T xh2 = T(0);
      if (l.valid) {
        const int64_t i = at(g, l.q, kk, hc);
        o.gb2n[i] = acc[j];
        xh2 = (o.z2[i] - o.m2[kk]) * rstd(o.v2[kk], o.eps);
      }
      const T gb = l.valid ? acc[j] : T(0);
      tile_sum(gb * xh2, part + kk);
      tile_sum(gb, part + hc + kk);
    }
  }
}

// Backward 3: g_z2 through BN2, the depthwise transpose, the activation's
// gradient: g_pre1 saved; partials [tile][sum g_pre1 xh1, sum g_pre1,
// sum g_z2, sum_t g_z2 a1(tap t) for 9 taps][hc].
template <class T>
__global__ void __launch_bounds__(kThreads) k_dw_back(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  T* part = o.partial + l.blk * 12 * hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps);
    const T m2 = o.m2[k], r2 = rstd(o.v2[k], o.eps);
    const T t2 = o.dvec[D_G2 * hc + k], t1 = o.dvec[D_BE2 * hc + k];
    T gp = T(0), xh1 = T(0), gz = T(0);
    T gdw[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) gdw[t] = T(0);
    if (l.valid) {
      T ga1 = T(0);
      for (int t = 0; t < 9; ++t) {
        int64_t nb;
        if (tap(g, l.q, t, -1, &nb))
          ga1 += o.dw[k * 9 + t] * gz2_at(o, g, nb, k, m2, r2, t1, t2, inv_m);
      }
      const int64_t i = at(g, l.q, k, hc);
      xh1 = (o.z1[i] - m1) * r1;
      gp = ga1 * act_grad(affine_rn(o.g1[k], xh1, o.be1[k]), o.leak);
      o.gpre1[i] = gp;
      gz = gz2_at(o, g, l.q, k, m2, r2, t1, t2, inv_m);
      for (int t = 0; t < 9; ++t) {
        int64_t nb;
        if (tap(g, l.q, t, +1, &nb)) gdw[t] = gz * a1_at(o, g, nb, k, m1, r1);
      }
    }
    tile_sum(gp * xh1, part + k);
    tile_sum(gp, part + hc + k);
    tile_sum(gz, part + 2 * hc + k);
#pragma unroll
    for (int t = 0; t < 9; ++t) tile_sum(gdw[t], part + (3 + t) * hc + k);
  }
}

// Backward 4: g_z1 through BN1 (its sums: the bias gradient of W1's conv),
// gx = W1^T g_z1 on the branch channels and the unshuffled gradient on the
// shortcut channels; partials [tile][sum g_z1][hc].
template <class T>
__global__ void __launch_bounds__(kThreads) k_pw1_back(UnitArgs a) {
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const Lane l = lane_of(g);
  const int hc = g.hc;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  T* gs = smem<T>();
  T* part = o.partial + l.blk * hc;
  for (int k = l.warp; k < hc; k += kWarps) {
    T gz = T(0);
    if (l.valid) {
      gz = gz1_at(o, g, l.q, k, o.m1[k], rstd(o.v1[k], o.eps), o.dvec[D_BE1 * hc + k],
                  o.dvec[D_G1 * hc + k], inv_m);
      o.out[at(g, l.q, k, g.c)] = o.gout[at(g, l.q, shuffle_dest(g.c, k), g.c)];
    }
    gs[k * TILE + l.lane] = gz;
    tile_sum(gz, part + k);
  }
  __syncthreads();
  for (int o0 = l.warp * OT; o0 < hc; o0 += kWarps * OT) {
    T acc[OT];
    dot_tile(o.w1, 1, hc, gs, hc, o0, l.lane, acc);      // column o0 + j of W1
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int ii = o0 + j;
      if (ii >= hc) break;
      if (l.valid) o.out[at(g, l.q, hc + ii, g.c)] = acc[j];
    }
  }
}

// Weight gradient dW[o][k] = sum_q A(o, q) B(k, q) over segment blockIdx.z of
// the pixel tiles, for the 32 x 32 block (blockIdx.x, blockIdx.y) of (o, k);
// partials [segment][hc][hc].  kWhich 3: A = g_u, B = b2n; kWhich 1: A = g_z1,
// B = the branch input.
template <class T, int kWhich>
__global__ void __launch_bounds__(kThreads) k_wgrad(UnitArgs a) {
  __shared__ T as[TILE][TILE + 1];
  __shared__ T bs[TILE][TILE + 1];
  const Ops<T> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  const int o0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int64_t n_tiles = (g.p + TILE - 1) / TILE;
  const int64_t c0 = static_cast<int64_t>(blockIdx.z) * a.seg_chunks;
  const int64_t c1 = c0 + a.seg_chunks < n_tiles ? c0 + a.seg_chunks : n_tiles;
  const int tr = threadIdx.x / 8, tc = (threadIdx.x % 8) * 4;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int64_t c = c0; c < c1; ++c) {
    for (int e = threadIdx.x; e < TILE * TILE; e += kThreads) {
      const int row = e / TILE, col = e % TILE;
      const int64_t q = c * TILE + col;
      const int oo = o0 + row, kk = k0 + row;
      T av = T(0), bv = T(0);
      if (q < g.p) {
        if (kWhich == 3) {
          if (oo < hc)
            av = gu_at(o, g, q, oo, o.m3[oo], rstd(o.v3[oo], o.eps),
                       o.dvec[D_BE3 * hc + oo], o.dvec[D_G3 * hc + oo], inv_m);
          if (kk < hc) bv = b2n_at(o, g, q, kk, o.m2[kk], rstd(o.v2[kk], o.eps));
        } else {
          if (oo < hc)
            av = gz1_at(o, g, q, oo, o.m1[oo], rstd(o.v1[oo], o.eps),
                        o.dvec[D_BE1 * hc + oo], o.dvec[D_G1 * hc + oo], inv_m);
          if (kk < hc) bv = o.x[at(g, q, hc + kk, g.c)];
        }
      }
      as[row][col] = av;
      bs[row][col] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < TILE; ++p) {
      const T av = as[tr][p];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += av * bs[tc + j][p];
    }
    __syncthreads();
  }
  T* part = o.partial + static_cast<int64_t>(blockIdx.z) * hc * hc;
  const int oo = o0 + tr;
  if (oo < hc) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tc + j < hc) part[oo * hc + k0 + tc + j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// launch sequences
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB (float64 tiles at hc = 232) must be
// allowed per kernel before its launch.
template <class K>
void allow_smem(K* kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

template <class T>
int infer(const UnitArgs& a, cudaStream_t s) {
  const Geo g = geometry(a);
  const int tiles = static_cast<int>((g.p + TILE - 1) / TILE);
  const size_t sm = sizeof(T) * g.hc * TILE;
  allow_smem(k_pw1<T, false>, sm);
  allow_smem(k_tail_infer<T>, sm);
  k_pw1<T, false><<<tiles, kThreads, sm, s>>>(a);
  k_tail_infer<T><<<tiles, kThreads, sm, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int train_fwd(const UnitArgs& a, cudaStream_t s) {
  const Geo g = geometry(a);
  const int tiles = static_cast<int>((g.p + TILE - 1) / TILE);
  const int fin = (g.hc + kWarps - 1) / kWarps;
  const size_t sm = sizeof(T) * g.hc * TILE;
  T* st = static_cast<T*>(a.stats);
  allow_smem(k_pw1<T, true>, sm);
  allow_smem(k_pw3_train<T>, sm);
  k_pw1<T, true><<<tiles, kThreads, sm, s>>>(a);
  k_stats_final<T><<<fin, kThreads, 0, s>>>(a, st, st + g.hc);
  k_dw_train<T><<<tiles, kThreads, 0, s>>>(a);
  k_stats_final<T><<<fin, kThreads, 0, s>>>(a, st + 2 * g.hc, st + 3 * g.hc);
  k_pw3_train<T><<<tiles, kThreads, sm, s>>>(a);
  k_stats_final<T><<<fin, kThreads, 0, s>>>(a, st + 4 * g.hc, st + 5 * g.hc);
  k_out_train<T><<<tiles, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
void sum_final(const T* src, int64_t nb, int64_t stride, int nrows, int ncols, T* dst, int rs,
               int cs, cudaStream_t s) {
  const int64_t n = static_cast<int64_t>(nrows) * ncols;
  const int blocks = static_cast<int>((n + kWarps - 1) / kWarps);
  k_sum_final<T><<<blocks, kThreads, 0, s>>>(src, nb, stride, nrows, ncols, dst, rs, cs);
}

template <class T>
int train_bwd(const UnitArgs& a, cudaStream_t s) {
  const Geo g = geometry(a);
  const int hc = g.hc;
  const int tiles = static_cast<int>((g.p + TILE - 1) / TILE);
  const size_t sm = sizeof(T) * hc * TILE;
  const T* part = static_cast<const T*>(a.partial);
  T* dvec = static_cast<T*>(a.dvec);
  allow_smem(k_pw3_back<T>, sm);
  allow_smem(k_pw1_back<T>, sm);
  k_bn3_sums<T><<<tiles, kThreads, 0, s>>>(a);
  sum_final(part, tiles, 2 * hc, 2, hc, dvec + D_G3 * hc, hc, 1, s);
  k_pw3_back<T><<<tiles, kThreads, sm, s>>>(a);
  sum_final(part, tiles, 3 * hc, 3, hc, dvec + D_G2 * hc, hc, 1, s);
  k_dw_back<T><<<tiles, kThreads, 0, s>>>(a);
  sum_final(part, tiles, 12 * hc, 3, hc, dvec + D_G1 * hc, hc, 1, s);
  sum_final(part + 3 * hc, tiles, 12 * hc, 9, hc, static_cast<T*>(a.ddw), 1, 9, s);
  k_pw1_back<T><<<tiles, kThreads, sm, s>>>(a);
  sum_final(part, tiles, hc, 1, hc, dvec + D_B1 * hc, hc, 1, s);
  const dim3 grid((hc + TILE - 1) / TILE, (hc + TILE - 1) / TILE, a.n_seg);
  k_wgrad<T, 3><<<grid, kThreads, 0, s>>>(a);
  sum_final(part, a.n_seg, static_cast<int64_t>(hc) * hc, hc, hc, static_cast<T*>(a.dw3), hc,
            1, s);
  k_wgrad<T, 1><<<grid, kThreads, 0, s>>>(a);
  sum_final(part, a.n_seg, static_cast<int64_t>(hc) * hc, hc, hc, static_cast<T*>(a.dw1), hc,
            1, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: `args` is read on the host and passed to the kernels by
// value; dtype 0 is float32, 1 float64.  Each returns cudaGetLastError()
// after its launches (0 on success).
extern "C" int cdrl_unit_infer(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? infer<float>(*args, s) : infer<double>(*args, s);
}

extern "C" int cdrl_unit_train_fwd(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? train_fwd<float>(*args, s) : train_fwd<double>(*args, s);
}

extern "C" int cdrl_unit_train_bwd(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? train_bwd<float>(*args, s) : train_bwd<double>(*args, s);
}
