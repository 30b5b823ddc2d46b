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
// is a short fixed sequence of launches on one stream, one per stage that
// needs a batch statistic of the stage before it (inference: the whole
// image of a channel before its depthwise): inference 3 launches, the
// training forward 4, the backward 5.
//
// The stages:
//   * 1x1 products (`k_pw`): a block owns 64 output channels and walks a
//     run of 64-pixel tiles; its whole weight panel sits in shared memory,
//     the pixel operand streams through a double buffer in chunks of 32
//     channels (the next chunk's global loads, across tiles the next
//     tile's, in flight during this chunk's FMAs), each thread holds a
//     4 x 4 register tile.  The operand is transformed on its way into
//     shared memory (BN2 in the forward; g_u or g_z1 from the saved tensors
//     in the backward, which the first channel tile's blocks also write
//     out and sum); the output tile leaves through shared memory so that
//     its stores are coalesced.  Inference runs two of them (W1, then W3
//     with BN3 and the activation in the epilogue and the shuffled store).
//   * channel stages (depthwise in inference, forward and backward, BN3's
//     sums): a block owns one channel of a run of images and stages
//     zero-padded planes of its inputs in shared memory, so each neighbour
//     is read and transformed once.
//   * weight gradients (`k_wgrad`): dW3 and dW1 in one launch, 64 x 64
//     output tiles split over pixel segments (split-K), both operands
//     staged with cp.async in a three-deep ring, 4 x 4 register tiles.
// Every reduction is per block: a block keeps its channel sums or moments
// in registers, reduces across its lanes or warps once and writes one
// partial row; the last block to arrive (a ticket from atomicAdd after
// __threadfence, on counters of the call's own that its entry point zeroes
// first) merges the rows in block order: per channel in the
// channel stages, in two levels (groups of 16 blocks, then the groups) in
// the products and the weight gradients, each merge's loads issued
// together.  No float atomics and a fixed split (shuffle_unit.cuh `make_plan`):
// two runs give the same bits.  Everything is in true float32
// (or float64), as the plain version computes on the card with TF32 off.
// In bfloat16 (storage type S = bf16, compute type T = float; see
// shuffle_unit.cuh) x, out, the output gradient and gx are stored in bf16,
// W1 and W3 rounded to bf16 as the weight panel is loaded (no conversion
// launch); the statistics, the saved tensors and every other array stay
// float32.  The bf16 training kernels (`k_pw`'s four training modes and
// `k_wgrad`) run their products on the tensor cores with
// mma.sync.m16n8k16 (bf16 operands from shared memory by ldmatrix, float32
// sums in registers): the weight panel and the pixel operand sit in shared
// memory as bf16; an operand that the JAX function keeps in float32 enters
// as its exact split into three bf16 terms (shuffle_unit.cuh `split3`):
// g_u in W3^T g_u, g_z1 in dW1, and both operands of dW3 (six cross terms).
// The bf16 backward keeps g_u, b2n and g_z1 channel-major ([channel][pixel],
// `pixel_pitch`) and its first launch copies the branch input there, so that
// `k_wgrad` loads every operand by 16-byte cp.async.  Inference in bf16 is
// one launch (`k_infer_bf16`): a block per band of rows of an image keeps
// a1 (float32) and b2n (bf16) in shared memory, recomputes the halo rows'
// a1, and runs both products on the tensor cores; there is no statistic to
// merge, so nothing needs a second launch.
//
// What bounds it on the H100: the function moves ~0.1 GB and does ~1-4
// GFLOP per call at N = 256, 0.03-0.06 ms at the card's peaks in float32
// (operations at the two smaller maps, bytes at the largest; the float32
// products are CUDA-core FP32, for parity with the plain version); in bf16
// the products at the tensor-core rate leave the bytes as the bound,
// 0.003-0.026 ms.  The three-launch and training kernels move the saved and
// intermediate tensors the bound does not count; bf16 inference moves x
// (its halo rows twice) and out, and each block reads both weight panels
// from L2.  The times stand beside the bounds in PERF.md.
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

enum ChannelStage { CH_DW, CH_BN3B, CH_DWB };

// What a kernel reads: the caller's arguments and the plan of their shape.
struct Call : UnitArgs, Plan {};

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  // butterfly: every lane ends with the same bits (each step adds a pair in
  // both orders, and IEEE addition commutes)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <class T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// cp.async of one element into shared memory, zero-filled when !valid.
template <class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? int(sizeof(T)) : 0;
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// cp.async of 16 bytes into shared memory: the first `bytes` from src, the
// rest zeros (src and dst on 16 bytes).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 tiles of bf16 from shared memory: lanes 8i .. 8i + 7 give the
// addresses of tile i's rows (16 bytes each); kTrans transposes each tile.
// Register i holds tile i: lane l its row l / 4, columns 2 (l % 4) and the
// next (transposed: that column's two rows).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

// d += A . B on the tensor cores: A 16 x 16 (row-major fragment a), B
// 16 x 8 (column-major fragment b0, b1), bf16 operands, float32 sums.  d[0],
// d[1]: row l / 4, columns 2 (l % 4) and the next; d[2], d[3]: row l / 4 + 8.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values that are bf16 values as one bf16x2 word, a in the low
// half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

template <class T>
__device__ __forceinline__ Moments<T> shfl_down(const Moments<T>& m, int off, int width) {
  Moments<T> r;
  r.n = __shfl_down_sync(0xffffffffu, m.n, off, width);
  r.mean = __shfl_down_sync(0xffffffffu, m.mean, off, width);
  r.m2 = __shfl_down_sync(0xffffffffu, m.m2, off, width);
  return r;
}

// The block's moments (valid in thread 0): a shuffle tree in each warp,
// then the warps in order.
template <class T>
__device__ Moments<T> block_moments(Moments<T> m) {
  __shared__ T red[3 * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) m = chan(m, shfl_down(m, off, 32));
  if (lane == 0) {
    red[3 * warp] = m.n;
    red[3 * warp + 1] = m.mean;
    red[3 * warp + 2] = m.m2;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) m = chan(m, Moments<T>{red[3 * w], red[3 * w + 1], red[3 * w + 2]});
  return m;
}

// The block's sums of R values per thread, written by threads r < R to
// out[r * stride].
template <class T, int R>
__device__ void block_sums(T* v, T* out, int64_t stride) {
  __shared__ T red[R * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T s = warp_sum(v[r]);
    if (lane == 0) red[r * kWarps + warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x * kWarps + w];
    out[threadIdx.x * stride] = s;
  }
}

// True in every thread of the last of `nblocks` blocks to arrive; the
// partials written before the call are then visible to it.
__device__ bool last_block(int* counter, int nblocks) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == nblocks - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The moments of up to PGROUP consecutive blocks (rows n, mean, m2), their
// loads issued at once; padded with empty blocks, which add nothing.
template <class T>
__device__ __forceinline__ Moments<T> merge16(const T* n, const T* mean, const T* m2,
                                              int count) {
  T a[PGROUP], b[PGROUP], c[PGROUP];
#pragma unroll
  for (int i = 0; i < PGROUP; ++i) {
    const bool v = i < count;
    a[i] = v ? n[i] : T(0);
    b[i] = v ? mean[i] : T(0);
    c[i] = v ? m2[i] : T(0);
  }
  return merge_blocks(a, b, c, PGROUP);
}

// The sum of up to PGROUP consecutive values, in order, loaded at once.
template <class T>
__device__ __forceinline__ T sum16(const T* v, int count) {
  T a[PGROUP];
#pragma unroll
  for (int i = 0; i < PGROUP; ++i) a[i] = i < count ? v[i] : T(0);
  return range_sum(a, PGROUP);
}

// ---------------------------------------------------------------------------
// the 1x1 products
// ---------------------------------------------------------------------------

// PW1_*: z1 = W1 . branch + b1 (inference writes act(BN1(z1)) on the
// running statistics; training writes z1 and BN1's statistics).
// PW3_TRAIN: u = W3 . BN2(z2) + b3 and BN3's statistics.
// PW3_BACK: g_b2n = W3^T g_u, with g_u from u and the output gradient
// (written out, and summed: the gradient of b3); writes b2n and BN2's sums.
// PW1_BACK: the branch half of gx = W1^T g_z1, with g_z1 from g_pre1 and z1
// (written out, and summed: the gradient of b1).
// PW3_INFER: act(BN3(W3 . b2n + b3)) on the running statistics, written to
// the branch's shuffled output channels.  (PwMode, shuffle_unit.cuh.)

// A block owns output channels m0 .. m0 + 63 of the pixel tiles tb .. te - 1.
// Lanes: in the products thread (ty, tx) holds rows ty * 4 + i and pixels
// tx * 4 + j, a warp covering 4 x 8 of them (one shared wavefront per
// operand and step); the loader holds channels lr, lr + 16 of a chunk at
// pixels lc + 16 j; in the epilogue warp w owns rows w + 8 i, lane l
// pixels l and l + 32.  On the tensor cores (bf16 training) warp w owns
// rows (w % 4) * 16 .. + 15 and pixels (w / 4) * 32 .. + 31 as four 16 x 8
// fragments, the panel and the pixel operand are bf16 and load by ldmatrix
// with .trans (both are [k][...]), and PW3_BACK's g_u enters as three tiles,
// its split terms; g_u, b2n and g_z1 are written channel-major.
template <class T, class S, int kMode>
__global__ void __launch_bounds__(kThreads, 2) k_pw(Call a) {
  constexpr bool kW1 = kMode == PW1_INFER || kMode == PW1_TRAIN || kMode == PW1_BACK;
  constexpr bool kBack = kMode == PW3_BACK || kMode == PW1_BACK;
  constexpr bool kStats = kMode == PW1_TRAIN || kMode == PW3_TRAIN;
  constexpr bool kInfer = kMode == PW1_INFER || kMode == PW3_INFER;
  constexpr bool kTC = pw_tensor_cores<T, S>();
  constexpr int NT = kMode == PW3_BACK ? 3 : 1;   // tensor cores: tiles of the pixel operand
  static_assert(!kInfer || sizeof(S) == sizeof(T), "bf16 inference is k_infer_bf16");
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, hw = g.hw, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int lr = tid >> 4, lc = tid & 15;
  const int n_ot = (hc + PM - 1) / PM;
  const int ot = blockIdx.x % n_ot, pb = blockIdx.x / n_ot, m0 = ot * PM;
  const int kpad = (hc + PK - 1) / PK * PK, n_chunks = kpad / PK;
  const int64_t n_tiles = (g.p + PTILE - 1) / PTILE;
  const int64_t tb = static_cast<int64_t>(pb) * a.tpb;
  const int64_t te = tb + a.tpb < n_tiles ? tb + a.tpb : n_tiles;
  const bool side = kBack && ot == 0;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  const int64_t pp = pixel_pitch(g.p);

  T* panel = smem<T>();                    // [kpad][PMP]: A(m0 + m, k)
  T* bs = panel + kpad * PMP;              // [2][PK][PTILE]: the pixel operand
  bf16* hpanel = smem<bf16>();             // tensor cores: [kpad][PMH]
  bf16* hbs = hpanel + kpad * PMH;         // tensor cores: [2][NT][PK][PTH]
  T* ots = kTC ? reinterpret_cast<T*>(hbs + 2 * NT * PK * PTH)
               : bs + 2 * PK * PTILE;      // [PM][OTP]: the output tile
  T* prm = ots + PM * OTP;                 // [6][hc]: the operand's per-channel constants
  T* bsum = prm + 6 * hc;                  // [hc]: the operand's sums (backward)
  T* epi = bsum + hc;                      // [5][PM]: the epilogue's per-row constants
  int* cb = reinterpret_cast<int*>(epi + 5 * PM);   // [2][2][PTILE]: pixel offsets

  const T* wm = kW1 ? o.w1 : o.w3;
  // coalesced along the weights' rows: W^T's rows are the panel's (the
  // backward), W's are its columns
  for (int e = tid; e < kpad * PM; e += kThreads) {
    const int k = kBack ? e / PM : e % kpad, m = kBack ? e % PM : e / kpad, mm = m0 + m;
    if constexpr (kTC)
      hpanel[k * PMH + m] =
          narrow<S>(k < hc && mm < hc ? (kBack ? wm[k * hc + mm] : wm[mm * hc + k]) : T(0));
    else
      panel[k * PMP + m] =
          k < hc && mm < hc ? round_to<S>(kBack ? wm[k * hc + mm] : wm[mm * hc + k]) : T(0);
  }
  for (int k = tid; k < hc; k += kThreads) {
    bsum[k] = T(0);
    if (kMode == PW3_TRAIN || kBack) {
      const bool b3 = kMode == PW3_BACK;
      const T* mv = kMode == PW3_TRAIN ? o.m2 : (b3 ? o.m3 : o.m1);
      const T* vv = kMode == PW3_TRAIN ? o.v2 : (b3 ? o.v3 : o.v1);
      const T* gv = kMode == PW3_TRAIN ? o.g2 : (b3 ? o.g3 : o.g1);
      const T* bv = kMode == PW3_TRAIN ? o.be2 : (b3 ? o.be3 : o.be1);
      prm[k] = mv[k];
      prm[hc + k] = rstd(vv[k], o.eps);
      prm[2 * hc + k] = gv[k];
      prm[3 * hc + k] = bv[k];
      if (kBack) {   // BN3's sums (s1, s2) or BN1's (u1, u2)
        prm[4 * hc + k] = o.dvec[(b3 ? D_BE3 : D_BE1) * hc + k];
        prm[5 * hc + k] = o.dvec[(b3 ? D_G3 : D_G1) * hc + k];
      }
    }
  }
  for (int r = tid; r < PM; r += kThreads) {
    const int c = min(m0 + r, hc - 1);
    T e[5] = {T(0), T(0), T(0), T(0), T(0)};
    if (kMode == PW1_INFER) {
      e[0] = o.b1[c]; e[1] = o.m1[c]; e[2] = rstd(o.v1[c], o.eps); e[3] = o.g1[c];
      e[4] = o.be1[c];
    } else if (kMode == PW3_INFER) {
      e[0] = o.b3[c]; e[1] = o.m3[c]; e[2] = rstd(o.v3[c], o.eps); e[3] = o.g3[c];
      e[4] = o.be3[c];
    } else if (kMode == PW1_TRAIN) {
      e[0] = o.b1[c];
    } else if (kMode == PW3_TRAIN) {
      e[0] = o.b3[c];
    } else if (kMode == PW3_BACK) {
      e[0] = o.m2[c]; e[1] = rstd(o.v2[c], o.eps); e[2] = o.g2[c]; e[3] = o.be2[c];
    }
    for (int i = 0; i < 5; ++i) epi[i * PM + r] = e[i];
  }
  // the tile's pixel offsets in (N, hc, H, W) and (N, c, H, W) tensors, -1
  // past the last pixel
  auto fill_cb = [&](int64_t t, int buf) {
    const int64_t q = t * PTILE + tid;
    int oh = -1, oc = -1;
    if (q < g.p) {
      const int nn = static_cast<int>(q / hw), r = static_cast<int>(q - int64_t(nn) * hw);
      oh = nn * hc * hw + r;
      oc = nn * g.c * hw + r;
    }
    cb[(2 * buf) * PTILE + tid] = oh;
    cb[(2 * buf + 1) * PTILE + tid] = oc;
  };

  // the epilogue's running moments (this lane's count, the rows' means and
  // squared deviations) or sums of its 8 rows, per lane
  T cnt = T(0), mu[8], m2[8], s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mu[i] = m2[i] = s1[i] = s2[i] = T(0);

  // this thread's loader columns lc + 16 j of a tile: offsets in (N, hc,
  // H, W) tensors (-1 past the last pixel) and in (N, c, H, W) tensors
  struct Cols {
    int h[4], c[4];
  };
  auto cols_of = [&](int buf) {
    Cols r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r.h[j] = cb[2 * buf * PTILE + lc + 16 * j];
      r.c[j] = cb[(2 * buf + 1) * PTILE + lc + 16 * j];
    }
    return r;
  };
  T r0[2][4], r1[2][4];
  auto load_raw = [&](const Cols& cl, int chunk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = chunk * PK + lr + 16 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r0[h][j] = r1[h][j] = T(0);
        if (k < hc && cl.h[j] >= 0) {
          if (kW1 && !kBack) {
            r0[h][j] = wide(o.x[cl.c[j] + (hc + k) * hw]);
          } else if (kMode == PW3_INFER) {
            r0[h][j] = o.b2n[cl.h[j] + k * hw];
          } else if (kMode == PW3_TRAIN) {
            r0[h][j] = o.z2[cl.h[j] + k * hw];
          } else if (kMode == PW3_BACK) {
            r0[h][j] = o.u[cl.h[j] + k * hw];
            r1[h][j] = wide(o.gout[cl.c[j] + shuffle_dest(g.c, hc + k) * hw]);
          } else {
            r0[h][j] = o.gpre1[cl.h[j] + k * hw];
            r1[h][j] = o.z1[cl.h[j] + k * hw];
          }
        }
      }
    }
  };
  // chunk `chunk` of tile t into dst (tensor cores: into buffer `buf`)
  auto stage = [&](const Cols& cl, int chunk, T* dst, int buf, int64_t t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = chunk * PK + lr + 16 * h;
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = T(0);
        if (k < hc && cl.h[j] >= 0) {
          if ((kW1 && !kBack) || kMode == PW3_INFER) {
            v[j] = r0[h][j];
          } else if (kMode == PW3_TRAIN) {
            // b2n, rounded to S before the W3 product
            v[j] = round_to<S>(bn(r0[h][j], prm[k], prm[hc + k], prm[2 * hc + k], prm[3 * hc + k]));
          } else if (kMode == PW3_BACK) {
            v[j] = gu_v(r0[h][j], r1[h][j], prm[k], prm[hc + k], prm[2 * hc + k],
                        prm[3 * hc + k], prm[4 * hc + k], prm[5 * hc + k], inv_m, o.leak);
          } else {
            v[j] = gin_v(r0[h][j], r1[h][j], prm[k], prm[hc + k], prm[2 * hc + k],
                         prm[4 * hc + k], prm[5 * hc + k], inv_m);
          }
        }
      }
      if (side) {
        T* keep = kMode == PW3_BACK ? o.gu : o.gz1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k < hc && cl.h[j] >= 0) {
            if constexpr (kTC) keep[k * pp + t * PTILE + lc + 16 * j] = v[j];
            else keep[cl.h[j] + k * hw] = v[j];
          }
        T s = ((v[0] + v[1]) + v[2]) + v[3];
        for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off, 16);
        if (lc == 0 && k < hc) bsum[k] += s;
      }
      // g_z1 enters the gx product rounded to S; its saved copy and its sum
      // (dW1, db1) are not
      if constexpr (kTC) {
        // the other operands are bf16 values already; g_u as its split terms
        bf16* d = hbs + (buf * NT * PK + lr + 16 * h) * PTH + lc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kMode == PW3_BACK) {
            const Split3 y = split3(v[j]);
            d[16 * j] = narrow<S>(y.hi);
            d[PK * PTH + 16 * j] = narrow<S>(y.mid);
            d[2 * PK * PTH + 16 * j] = narrow<S>(y.lo);
          } else {
            d[16 * j] = narrow<S>(v[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[(lr + 16 * h) * PTILE + lc + 16 * j] = kMode == PW1_BACK ? round_to<S>(v[j]) : v[j];
      }
    }
  };
  // the tensor cores' lanes: ldmatrix row offsets of the panel (rows k) and
  // of the pixel operand (rows k), and the warp's rows and pixels
  const int l8 = lane >> 3, r8 = lane & 7;
  const int ak = r8 + (l8 >> 1) * 8, am = (l8 & 1) * 8;
  const int bk = r8 + (l8 & 1) * 8, bn = (l8 >> 1) * 8;
  const int wrow = (warp & 3) * 16, wpix = (warp >> 2) * 32;

  if (tid < PTILE) fill_cb(tb, 0);
  __syncthreads();
  Cols cur_cols = cols_of(0), next_cols = cur_cols;
  load_raw(cur_cols, 0);
  for (int64_t t = tb; t < te; ++t) {
    const int cur = static_cast<int>(t - tb) & 1;
    const int* cbh = cb + 2 * cur * PTILE;
    if (tid < PTILE && t + 1 < te) fill_cb(t + 1, cur ^ 1);
    stage(cur_cols, 0, bs, 0, t);
    __syncthreads();
    if (t + 1 < te) next_cols = cols_of(cur ^ 1);
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    for (int c = 0; c < n_chunks; ++c) {
      // the next chunk's loads (or the next tile's first) fly during this one
      if (c + 1 < n_chunks) load_raw(cur_cols, c + 1);
      else if (t + 1 < te) load_raw(next_cols, 0);
      if constexpr (kTC) {
        const bf16* A = hpanel + c * PK * PMH;
        const bf16* B = hbs + (c & 1) * NT * PK * PTH;
#pragma unroll
        for (int ks = 0; ks < PK; ks += 16) {
          uint32_t af[4];
          ldsm_x4<true>(af, A + (ks + ak) * PMH + wrow + am);
#pragma unroll
          for (int term = 0; term < NT; ++term) {
            uint32_t bf[2][4];
            const bf16* Bt = B + (term * PK + ks + bk) * PTH + wpix + bn;
            ldsm_x4<true>(bf[0], Bt);
            ldsm_x4<true>(bf[1], Bt + 16);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[j], af, bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
          }
        }
      } else {
        const T* A = panel + c * PK * PMP;
        const T* B = bs + (c & 1) * PK * PTILE;
#pragma unroll 8
        for (int kk = 0; kk < PK; ++kk) {
          T av[4], bv[4];
          load4(A + kk * PMP + ty * 4, av);
          load4(B + kk * PTILE + tx * 4, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
      if (c + 1 < n_chunks) stage(cur_cols, c + 1, bs + ((c + 1) & 1) * PK * PTILE, (c + 1) & 1, t);
      __syncthreads();
    }
    if constexpr (kTC) {
      const int row = wrow + (lane >> 2), col = wpix + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(ots + row * OTP + col + 8 * j) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(ots + (row + 8) * OTP + col + 8 * j) =
            make_float2(acc[j][2], acc[j][3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) store4(ots + (ty * 4 + i) * OTP + tx * 4, acc[i]);
    }
    __syncthreads();
    // epilogue: coalesced along the pixels.  Each lane's values of a row
    // (pixels lane, lane + 32; the second valid only with the first) join
    // its running moments as one batch (Chan et al.): one division per tile.
    const bool ok[2] = {cbh[lane] >= 0, cbh[lane + 32] >= 0};
    // tensor cores: PW3_BACK's z2 loaded together, before the stores (a load
    // after a store waits for it: the pointers may alias)
    T z2v[8][2];
    if constexpr (kTC && kMode == PW3_BACK) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oo = m0 + warp + 8 * i, col = lane + 32 * h;
          z2v[i][h] = oo < hc && ok[h] ? o.z2[cbh[col] + oo * hw] : T(0);
        }
    }
    const T nb2 = T(ok[0]) + T(ok[1]);
    const T f = kStats && ok[0] ? nb2 / (cnt + nb2) : T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i, oo = m0 + r;
      if (oo >= hc) continue;
      T v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h;
        v[h] = ots[r * OTP + col];
        if (!ok[h]) continue;
        const int ih = cbh[col] + oo * hw;
        if (kInfer) {
          const T y = bn_act(v[h] + epi[r], epi[PM + r], epi[2 * PM + r], epi[3 * PM + r],
                             epi[4 * PM + r], o.leak);
          if (kMode == PW1_INFER) o.z1[ih] = y;
          else o.out[cbh[PTILE + col] + shuffle_dest(g.c, hc + oo) * hw] = narrow<S>(y);
        } else if (kMode == PW1_TRAIN) {
          v[h] += epi[r];
          o.z1[ih] = v[h];
        } else if (kMode == PW3_TRAIN) {
          v[h] += epi[r];
          o.u[ih] = v[h];
        } else if (kMode == PW3_BACK) {
          o.gb2n[ih] = v[h];
          T z2i;
          if constexpr (kTC) z2i = z2v[i][h];
          else z2i = o.z2[ih];
          const T xh2 = (z2i - epi[r]) * epi[PM + r];
          if constexpr (kTC)
            o.b2n[oo * pp + t * PTILE + col] = epi[2 * PM + r] * xh2 + epi[3 * PM + r];
          else
            o.b2n[ih] = epi[2 * PM + r] * xh2 + epi[3 * PM + r];
          s1[i] += v[h];
          s2[i] += v[h] * xh2;
        } else {
          o.out[cbh[PTILE + col] + (hc + oo) * hw] = narrow<S>(v[h]);
        }
      }
      if (kStats && ok[0]) {
        const T d2 = v[0] - v[1];
        const T bm = ok[1] ? T(0.5) * (v[0] + v[1]) : v[0];
        const T bq = ok[1] ? T(0.5) * d2 * d2 : T(0);
        const T d = bm - mu[i];
        mu[i] += d * f;
        m2[i] += bq + d * d * cnt * f;
      }
    }
    cnt += nb2;
    cur_cols = next_cols;
    __syncthreads();   // the tile's offsets and output tile are free
  }
  if (kInfer) return;

  // one partial row per block: a row's pixels are one warp's
  T* part = o.partial;
  const int64_t nb = a.n_pb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int oo = m0 + warp + 8 * i;
    if (kStats) {
      Moments<T> m{cnt, mu[i], m2[i]};
      for (int off = 16; off > 0; off >>= 1) m = chan(m, shfl_down(m, off, 32));
      if (lane == 0 && oo < hc) {
        part[(0 * hc + oo) * nb + pb] = m.n;
        part[(1 * hc + oo) * nb + pb] = m.mean;
        part[(2 * hc + oo) * nb + pb] = m.m2;
      }
    } else if (kMode == PW3_BACK) {
      const T a1 = warp_sum(s1[i]), a2 = warp_sum(s2[i]);
      if (lane == 0 && oo < hc) {
        part[(0 * hc + oo) * nb + pb] = a2;
        part[(1 * hc + oo) * nb + pb] = a1;
      }
    }
  }
  if (side) {
    const int row = kMode == PW3_BACK ? 2 : 0;
    for (int k = tid; k < hc; k += kThreads) part[(row * hc + k) * nb + pb] = bsum[k];
  }
  // first level: the last block of each group of PGROUP pixel blocks
  // merges the group's rows; second level: the last group merges the groups
  constexpr int R = kMode == PW1_BACK ? 1 : 3;
  const int mi = kMode - PW1_TRAIN;
  const int ng = (a.n_pb + PGROUP - 1) / PGROUP, grp = pb / PGROUP;
  const int gb0 = grp * PGROUP, gb1 = min(gb0 + PGROUP, a.n_pb);
  if (!last_block(o.counters + C_PWG + 64 * mi + grp, (gb1 - gb0) * n_ot)) return;
  T* gpart = part + R * hc * nb;           // [R * hc][ng]
  if (kStats) {
    for (int k = tid; k < hc; k += kThreads) {
      const Moments<T> m = merge16(part + k * nb + gb0, part + (hc + k) * nb + gb0,
                                   part + (2 * hc + k) * nb + gb0, gb1 - gb0);
      gpart[k * ng + grp] = m.n;
      gpart[(hc + k) * ng + grp] = m.mean;
      gpart[(2 * hc + k) * ng + grp] = m.m2;
    }
  } else {
    for (int e = tid; e < R * hc; e += kThreads)
      gpart[e * ng + grp] = sum16(part + e * nb + gb0, gb1 - gb0);
  }
  if (!last_block(o.counters + C_PW + mi, ng)) return;
  if (kStats) {
    T* st = o.stats + (kMode == PW1_TRAIN ? 0 : 4 * hc);
    for (int k = tid; k < hc; k += kThreads) {
      const Moments<T> m =
          merge16(gpart + k * ng, gpart + (hc + k) * ng, gpart + (2 * hc + k) * ng, ng);
      st[k] = m.mean;
      st[hc + k] = m.m2 / T(g.p);
    }
  } else {
    // PW3_BACK rows: sum g_b2n xh2 (BN2 scale), sum g_b2n (BN2 bias), sum
    // g_u (b3); PW1_BACK: sum g_z1 (b1)
    for (int e = tid; e < R * hc; e += kThreads) {
      const int r = e / hc;
      const int row = kMode == PW1_BACK ? D_B1 : r == 0 ? D_G2 : r == 1 ? D_BE2 : D_B3;
      o.dvec[row * hc + e % hc] = sum16(gpart + e * ng, ng);
    }
  }
}

// ---------------------------------------------------------------------------
// the channel stages: a block per (image segment blockIdx.x, channel
// blockIdx.y); partial rows part[(r * hc + k) * n_s + s], merged per channel
// by the channel's last block
// ---------------------------------------------------------------------------

// A channel block's geometry, and its index maps in shared memory (the
// same for every pass, so the index arithmetic is done once): fo[e], the
// offset from the pass's first plane of padded pixel e, -1 on the padding;
// oc[e] and og[e], the padded and the plain offsets of output pixel e.
struct ChannelBlock {
  int k, s, n0, n1, pl, pitch, plane;
  const int *fo, *oc, *og;
};

__device__ __forceinline__ ChannelBlock channel_block(const Call& a, const Geo& g,
                                                      int* maps) {
  static_assert(CH_THREADS == kThreads, "a channel block is one block of kThreads");
  ChannelBlock b;
  b.k = blockIdx.y;
  b.s = blockIdx.x;
  b.n0 = b.s * a.ipb;
  b.n1 = min(g.n, b.n0 + a.ipb);
  b.pl = planes_per_pass(g.h, g.w, a.ipb);
  b.pitch = g.w + 2;
  b.plane = (g.h + 2) * b.pitch;
  int* fo = maps;
  int* oc = fo + b.pl * b.plane;
  int* og = oc + b.pl * g.hw;
  const int plane_stride = g.hc * g.hw;
  for (int e = threadIdx.x; e < b.pl * b.plane; e += kThreads) {
    const int pl = e / b.plane, r = e - pl * b.plane;
    const int y = r / b.pitch - 1, x = r % b.pitch - 1;
    fo[e] = y >= 0 && y < g.h && x >= 0 && x < g.w ? pl * plane_stride + y * g.w + x : -1;
  }
  for (int e = threadIdx.x; e < b.pl * g.hw; e += kThreads) {
    const int pl = e / g.hw, r = e - pl * g.hw, y = r / g.w, x = r - y * g.w;
    oc[e] = pl * b.plane + (y + 1) * b.pitch + x + 1;
    og[e] = pl * plane_stride + r;
  }
  b.fo = fo;
  b.oc = oc;
  b.og = og;
  return b;
}

// Training: z2 = depthwise(act(BN1(z1))) + dwb on BN1's batch statistics,
// saved, and BN2's statistics.
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_dw_train(Call a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  T* pad = smem<T>();
  const int planes = planes_per_pass(g.h, g.w, a.ipb) * (g.h + 2) * (g.w + 2);
  const ChannelBlock b = channel_block(a, g, reinterpret_cast<int*>(pad + planes));
  const int hc = g.hc, hw = g.hw, k = b.k, tid = threadIdx.x;
  const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps), g1 = o.g1[k], be1 = o.be1[k];
  T wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = o.dw[k * 9 + t];
  const T bias = o.dwb[k];
  Moments<T> mom{T(0), T(0), T(0)};
  for (int n = b.n0; n < b.n1; n += b.pl) {
    const int np = min(b.pl, b.n1 - n);
    const T* z1 = o.z1 + (static_cast<int64_t>(n) * hc + k) * hw;
    T* z2 = o.z2 + (static_cast<int64_t>(n) * hc + k) * hw;
    __syncthreads();   // the maps are written, the previous pass is done
#pragma unroll 4
    for (int e = tid; e < np * b.plane; e += kThreads) {
      const int f = b.fo[e];
      pad[e] = f >= 0 ? act(bn(z1[f], m1, r1, g1, be1), o.leak) : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < np * hw; e += kThreads) {
      const T z = dw3x3(wt, bias, pad + b.oc[e], b.pitch);
      z2[b.og[e]] = z;
      welford(&mom, z);
    }
  }
  mom = block_moments(mom);
  T* part = o.partial;
  const int64_t ns = a.n_s;
  if (tid == 0) {
    part[(0 * hc + k) * ns + b.s] = mom.n;
    part[(1 * hc + k) * ns + b.s] = mom.mean;
    part[(2 * hc + k) * ns + b.s] = mom.m2;
  }
  if (!last_block(o.counters + C_CH + 256 * CH_DW + k, gridDim.x)) return;
  if (tid == 0) {
    const Moments<T> m = merge16(part + k * ns, part + (hc + k) * ns, part + (2 * hc + k) * ns,
                                 a.n_s);
    o.stats[2 * hc + k] = m.mean;
    o.stats[3 * hc + k] = m.m2 / T(g.p);
  }
}

// Inference in float32 and float64: b2n = BN2(depthwise(a1) + dwb) on the
// running statistics, written over a1 (each plane of a1 is read only by its own block, into
// shared memory, before that block writes it), and the shortcut's channel
// k copied to its shuffled channel.
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_dw_infer(Call a) {
  static_assert(sizeof(S) == sizeof(T), "bf16 inference is k_infer_bf16");
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  T* pad = smem<T>();
  const int planes = planes_per_pass(g.h, g.w, a.ipb) * (g.h + 2) * (g.w + 2);
  const ChannelBlock b = channel_block(a, g, reinterpret_cast<int*>(pad + planes));
  const int hc = g.hc, hw = g.hw, k = b.k, tid = threadIdx.x;
  const T m2 = o.m2[k], r2 = rstd(o.v2[k], o.eps), g2 = o.g2[k], be2 = o.be2[k];
  T wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = o.dw[k * 9 + t];
  const T bias = o.dwb[k];
  const int64_t img = static_cast<int64_t>(g.c) * hw;
  for (int n = b.n0; n < b.n1; n += b.pl) {
    const int np = min(b.pl, b.n1 - n);
    const int64_t base = (static_cast<int64_t>(n) * hc + k) * hw;
    __syncthreads();   // the maps are written, the previous pass is done
#pragma unroll 4
    for (int e = tid; e < np * b.plane; e += kThreads) {
      const int f = b.fo[e];
      pad[e] = f >= 0 ? o.z1[base + f] : T(0);
    }
    // the pass's shortcut planes, their loads in flight with the fill's
    const S* src = o.x + n * img + static_cast<int64_t>(k) * hw;
    S* dst = o.out + n * img + static_cast<int64_t>(shuffle_dest(g.c, k)) * hw;
#pragma unroll 4
    for (int e = tid; e < np * hw; e += kThreads) {
      const int i = e / hw, r = e - i * hw;
      dst[i * img + r] = src[i * img + r];
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < np * hw; e += kThreads)
      o.b2n[base + b.og[e]] = dw_bn(wt, bias, pad + b.oc[e], b.pitch, m2, r2, g2, be2);
  }
}

// ---------------------------------------------------------------------------
// bf16 inference: one launch, a block per band of rows (k_infer_bf16)
// ---------------------------------------------------------------------------

// Row r's len(r) bf16 values from src(r) to dst(r) (generic pointers:
// shared memory to shared or device memory) for each of `rows` rows: a warp
// per row, lanes over its values, 2 bytes each (a row of a bf16 NCHW plane
// starts on 2 bytes only, in device memory as in the staging), U values a
// lane loaded before the first is stored.
template <class Row>
__device__ __forceinline__ void copy_values(int rows, Row row) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    const uint16_t* src;
    uint16_t* dst;
    int len;
    row(r, &src, &dst, &len);
    for (int v0 = lane; v0 < len; v0 += 32 * U) {
      uint16_t t[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < len) t[u] = src[v0 + 32 * u];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < len) dst[v0 + 32 * u] = t[u];
    }
  }
}

// Row r's len(r) <= maxlen bf16 values at src(r) into shared memory at
// dst(r) (on 16 bytes) by cp.async: the aligned 16-byte pieces of device
// memory that hold them, first to last, so that value p sits at dst(r) +
// (src(r) mod 16) + 2 p; every copy issued before the first lands.
template <class Row>
__device__ __forceinline__ void stage_rows(int rows, int maxlen, Row row) {
  const int pieces = (2 * maxlen + 15) / 16 + 1;
  for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
    const int r = e / pieces, i = e - r * pieces;
    const char* src;
    char* dst;
    int len;
    row(r, &src, &dst, &len);
    const uintptr_t g = reinterpret_cast<uintptr_t>(src), as = g & ~uintptr_t(15);
    if (i <= static_cast<int>((g + 2 * uintptr_t(len) - 1 - as) >> 4))
      cp_async16(dst + 16 * i, reinterpret_cast<const char*>(as) + 16 * i, 16);
  }
}

// A weight matrix (hc x hc float32, [out][in]) into a bf16 panel [m][k] of
// kpad rows of pitch ppitch, rounded to bf16 (JAX's operand is its bf16
// copy) and zero outside hc x hc.  The block's threads take the panel's
// runs of 4 values (k = 4 q), consecutive threads consecutive runs, U runs
// each with every load in flight together (16-byte loads where the rows
// allow them).
__device__ __forceinline__ void load_panel(bf16* panel, const float* wm, int hc, int kpad,
                                           int ppitch) {
  constexpr int U = 8;
  const int nt = blockDim.x, quads = kpad / 4, total = kpad * quads;
  const bool vec = hc % 4 == 0 && (reinterpret_cast<uintptr_t>(wm) & 15) == 0;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * nt) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nt, m = e / quads, k = 4 * (e - m * quads);
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e >= total || m >= hc || k >= hc) continue;
      const float* r = wm + static_cast<int64_t>(m) * hc + k;
      if (vec) {
        v[u] = *reinterpret_cast<const float4*>(r);
      } else {
        v[u].x = r[0];
        if (k + 1 < hc) v[u].y = r[1];
        if (k + 2 < hc) v[u].z = r[2];
        if (k + 3 < hc) v[u].w = r[3];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nt, m = e / quads, k = 4 * (e - m * quads);
      if (e >= total) continue;
      __nv_bfloat162 b[2] = {__floats2bfloat162_rn(v[u].x, v[u].y),
                             __floats2bfloat162_rn(v[u].z, v[u].w)};
      *reinterpret_cast<uint2*>(panel + m * ppitch + k) = *reinterpret_cast<const uint2*>(b);
    }
  }
}

// D = A . B on the tensor cores over the tiles of one block: A a bf16 panel
// [m][k] of pitch ap (ldmatrix), B bf16 [k][pixel] of pitch bp
// (ldmatrix.trans), kpad deep.  Warp w of nw takes the tiles w, w + nw, ... of
// mt x pt tiles of 16 rows and 32 pixels, four 16 x 8 fragments each, and
// hands each tile's sums to tile(row, col, acc): acc[j][0..1] at row `row`,
// pixels col + 8 j and the next; acc[j][2..3] at row + 8.
template <class Tile>
__device__ __forceinline__ void tc_tiles(const bf16* A, int ap, const bf16* B, int bp, int kpad,
                                         int mt, int pt, Tile tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int l8 = lane >> 3, r8 = lane & 7;
  const int ar = r8 + (l8 & 1) * 8, ac = (l8 >> 1) * 8;
  const int bk = r8 + (l8 & 1) * 8, bn = (l8 >> 1) * 8;
  for (int t = warp; t < mt * pt; t += nw) {
    const int m0 = (t % mt) * 16, p0 = (t / mt) * 32;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < kpad; ks += 16) {
      uint32_t af[4], bf[2][4];
      ldsm_x4<false>(af, A + (m0 + ar) * ap + ks + ac);
      const bf16* bt = B + (ks + bk) * bp + p0 + bn;
      ldsm_x4<true>(bf[0], bt);
      ldsm_x4<true>(bf[1], bt + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[j], af, bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
    }
    tile(m0 + (lane >> 2), p0 + 2 * (lane & 3), acc);
  }
}

// k_infer_bf16's per-channel constants, rows of its [UNIT_CONSTS][hc] table
// in shared memory (shuffle_unit.cuh `infer_layout`): the depthwise's 9
// taps, its bias, BN2's running mean, rstd, scale and bias; then for each
// 1x1 product (K_BN1: W1, K_BN3: W3) its bias and its BatchNorm's running
// mean, rstd, scale and bias.
enum UnitConst { K_DW = 0, K_DWB = 9, K_M2, K_R2, K_G2, K_BE2, K_BN1, K_BN3 = K_BN1 + 5 };

__device__ __forceinline__ float unit_const(const Ops<float, bf16>& o, int r, int k) {
  if (r < K_DWB) return o.dw[k * 9 + r];
  const bool w1 = r < K_BN3;
  switch (r < K_BN1 ? r : K_BN1 + (r - K_BN1) % 5) {
    case K_DWB: return o.dwb[k];
    case K_M2: return o.m2[k];
    case K_R2: return rstd(o.v2[k], o.eps);
    case K_G2: return o.g2[k];
    case K_BE2: return o.be2[k];
    case K_BN1: return w1 ? o.b1[k] : o.b3[k];
    case K_BN1 + 1: return w1 ? o.m1[k] : o.m3[k];
    case K_BN1 + 2: return rstd(w1 ? o.v1[k] : o.v3[k], o.eps);
    case K_BN1 + 3: return w1 ? o.g1[k] : o.g3[k];
    default: return w1 ? o.be1[k] : o.be3[k];
  }
}


// bf16 inference, the whole unit in one launch (row 4c: the JAX kernels
// with cd = bfloat16, `_make_infer_kernel` / `_make_infer_halo_kernel`).
// Block b owns band b % nb of image b / nb (rows [y0, y1), shuffle_unit.cuh
// `band_rows`, `infer_layout`; the whole image at the backbone's maps,
// bands of rows at taller ones, `infer_band`) and keeps z1, a1 and b2n in shared memory,
// as the TPU kernel keeps them in VMEM, so that only x and out cross device
// memory:
//   1. the branch input of the rows [e0, e1) and the band's shortcut half
//      staged in a1's region by cp.async (stage_rows: a bf16 NCHW plane
//      starts on 2 bytes only, hw x 2 bytes being 990, 276 or 72 at the
//      backbone's maps, so its rows go as the aligned 16-byte pieces that
//      hold them), and while they land the weight panels (W1, and W3 where
//      both fit; rounded to bf16 as they load) and the per-channel
//      constants; then x into place as bf16 [k][p] and the shortcut to its
//      shuffled channels (copy_values), and a1's region zeroed;
//   2. z1 = W1 . x on the tensor cores (mma.sync m16n8k16, bf16 operands
//      by ldmatrix, float32 sums; both operands are bf16 values, so every
//      product is exact), a1 = act(BN1(z1 + b1)) on the running statistics
//      into zero-padded float32 planes (the halo rows recomputed: (rb + 2)
//      / rb of the W1 product);
//   3. (W3 over W1's panel when only one fits) the depthwise on the CUDA
//      cores, b2n = BN2(z2) rounded to bf16 over the branch input;
//   4. u = W3 . b2n on the tensor cores, act(BN3(u + b3)) in bf16 into an
//      output tile in a1's region;
//   5. the tile to the branch's shuffled channels, rows of values in
//      consecutive lanes.
// A block is 512 threads (2 * kThreads), alone on its SM.
// Nothing crosses blocks, so two calls give the same bits.  What bounds it:
// x and out are the function's bytes (0.003-0.009 ms at N = 128 on the
// H100), but each block also reads both float32 weight panels from L2, and
// a block's stages wait on one another's latencies (PERF.md).
__global__ void __launch_bounds__(2 * kThreads) k_infer_bf16(Call a) {
  const Ops<float, bf16> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, w = g.w, hw = g.hw, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const InferLayout L = infer_layout(hc, g.h, w, a.rb, a.panels);
  const int n = blockIdx.x / a.nb;
  const Band b = band_rows(g.h, a.rb, blockIdx.x % a.nb);
  const int pe = (b.e1 - b.e0) * w, pb = (b.y1 - b.y0) * w;
  unsigned char* base = smem<unsigned char>();
  bf16* p1 = reinterpret_cast<bf16*>(base);
  bf16* p3 = a.panels == 2 ? p1 + L.kpad * L.ppitch : p1;
  bf16* xs = reinterpret_cast<bf16*>(base + L.x_off);
  float* a1 = reinterpret_cast<float*>(base + L.a_off);
  bf16* st = reinterpret_cast<bf16*>(base + L.a_off);   // the output tile, over a1
  float* cst = reinterpret_cast<float*>(base + L.c_off);
  int16_t* poff = reinterpret_cast<int16_t*>(base + L.t_off);
  int16_t* coff = poff + L.xcols;
  const int64_t img = static_cast<int64_t>(n) * g.c * hw, at0 = static_cast<int64_t>(b.y0) * w;
  const bf16* xn = o.x + img;
  bf16* on = o.out + img;

  // 1. loads: x's rows (r < hc) and the shortcut's (r >= hc) staged, then
  // copied into xs and into out's shortcut channels; the constants, the
  // pixel tables; a1's region zeroed (its padding) once the staging is read
  auto src_row = [&](int r, int* len) {
    *len = r < hc ? pe : pb;
    return r < hc ? xn + static_cast<int64_t>(hc + r) * hw + b.e0 * w
                  : xn + static_cast<int64_t>(r - hc) * hw + at0;
  };
  auto staged = [&](int r) {
    return base + L.a_off + (r < hc ? int64_t(r) * L.spx : int64_t(hc) * L.spx + (r - hc) * L.sps);
  };
  stage_rows(2 * hc, pe, [&](int r, const char** s, char** d, int* len) {
    *s = reinterpret_cast<const char*>(src_row(r, len));
    *d = reinterpret_cast<char*>(staged(r));
  });
  cp_commit();
  load_panel(p1, o.w1, hc, L.kpad, L.ppitch);
  if (a.panels == 2) load_panel(p3, o.w3, hc, L.kpad, L.ppitch);
  for (int e = tid; e < UNIT_CONSTS * hc; e += nt) {
    const int r = e / hc;
    cst[e] = unit_const(o, r, e - r * hc);
  }
  for (int e = tid; e < (L.kpad - hc) * L.xpitch / 8; e += nt)
    reinterpret_cast<uint4*>(xs + hc * L.xpitch)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int p = tid; p < L.xcols; p += nt)
    poff[p] = p < pe ? (p / w + b.e0 - b.y0 + 1) * L.apitch + p % w + 1 : -1;
  for (int p = tid; p < pb; p += nt) coff[p] = (p / w + 1) * L.apitch + p % w + 1;
  cp_wait<0>();
  __syncthreads();
  copy_values(2 * hc, [&](int r, const uint16_t** s, uint16_t** d, int* len) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(src_row(r, len));
    *s = reinterpret_cast<const uint16_t*>(staged(r) + (at & 15));
    *d = reinterpret_cast<uint16_t*>(
        r < hc ? xs + r * L.xpitch
               : on + static_cast<int64_t>(shuffle_dest(g.c, r - hc)) * hw + at0);
  });
  __syncthreads();
  for (int64_t e = tid; e < (L.c_off - L.a_off) / 16; e += nt)
    reinterpret_cast<uint4*>(base + L.a_off)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // 2. a1 = act(BN1(W1 . x + b1))
  const int mt = L.kpad / 16;
  tc_tiles(p1, L.ppitch, xs, L.xpitch, L.kpad, mt, (pe + 31) / 32,
           [&](int row, int col, float (&acc)[4][4]) {
#pragma unroll
             for (int h = 0; h < 2; ++h) {
               const int m = row + 8 * h;
               if (m >= hc) continue;
               const float* c = cst + K_BN1 * hc + m;   // b1, m1, rstd1, g1, be1
#pragma unroll
               for (int j = 0; j < 4; ++j)
#pragma unroll
                 for (int i = 0; i < 2; ++i) {
                   const int p = col + 8 * j + i;
                   if (p < pe)
                     a1[m * L.aplane + poff[p]] = bn_act(acc[j][2 * h + i] + c[0], c[hc],
                                                         c[2 * hc], c[3 * hc], c[4 * hc], o.leak);
                 }
             }
           });
  __syncthreads();

  // 3. b2n = BN2(depthwise(a1) + dwb) rounded to bf16, over x
  if (a.panels == 1) load_panel(p3, o.w3, hc, L.kpad, L.ppitch);
  for (int k = warp; k < hc; k += nw) {
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = cst[(K_DW + t) * hc + k];
    const float bias = cst[K_DWB * hc + k], m2 = cst[K_M2 * hc + k], r2 = cst[K_R2 * hc + k],
                g2 = cst[K_G2 * hc + k], be2 = cst[K_BE2 * hc + k];
    const float* plane = a1 + k * L.aplane;
    bf16* dst = xs + k * L.xpitch;
    constexpr int U = 4;   // pixels a lane computes before it stores
    for (int p0 = lane; p0 < pb; p0 += 32 * U) {
      bf16 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p0 + 32 * u < pb)
          v[u] = narrow<bf16>(dw_bn(wt, bias, plane + coff[p0 + 32 * u], L.apitch, m2, r2, g2,
                                    be2));
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p0 + 32 * u < pb) dst[p0 + 32 * u] = v[u];
    }
  }
  __syncthreads();

  // 4. act(BN3(W3 . b2n + b3)) into the output tile
  tc_tiles(p3, L.ppitch, xs, L.xpitch, L.kpad, mt, (pb + 31) / 32,
           [&](int row, int col, float (&acc)[4][4]) {
#pragma unroll
             for (int h = 0; h < 2; ++h) {
               const int m = row + 8 * h;
               if (m >= hc) continue;
               const float* c = cst + K_BN3 * hc + m;   // b3, m3, rstd3, g3, be3
               bf16* dst = st + m * L.spitch;
#pragma unroll
               for (int j = 0; j < 4; ++j)
#pragma unroll
                 for (int i = 0; i < 2; ++i) {
                   const int p = col + 8 * j + i;
                   if (p < pb)
                     dst[p] = narrow<bf16>(bn_act(acc[j][2 * h + i] + c[0], c[hc], c[2 * hc],
                                                  c[3 * hc], c[4 * hc], o.leak));
                 }
             }
           });
  __syncthreads();

  // 5. the tile to out
  copy_values(hc, [&](int m, const uint16_t** s, uint16_t** d, int* len) {
    *s = reinterpret_cast<const uint16_t*>(st + m * L.spitch);
    *d = reinterpret_cast<uint16_t*>(on + static_cast<int64_t>(shuffle_dest(g.c, hc + m)) * hw +
                                     at0);
    *len = pb;
  });
}

// Training: out = shuffle(concat(shortcut, act(BN3(u)))).
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_out_train(Call a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, hw = g.hw;
  T* cm = smem<T>();     // [4][hc]: m3, rstd3, g3, be3
  for (int k = threadIdx.x; k < hc; k += kThreads) {
    cm[k] = o.m3[k];
    cm[hc + k] = rstd(o.v3[k], o.eps);
    cm[2 * hc + k] = o.g3[k];
    cm[3 * hc + k] = o.be3[k];
  }
  __syncthreads();
  const int64_t total = static_cast<int64_t>(g.n) * hc * hw;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t plane = e / hw;
    const int r = static_cast<int>(e - plane * hw);
    const int nn = static_cast<int>(plane / hc), k = static_cast<int>(plane - int64_t(nn) * hc);
    const int64_t base = static_cast<int64_t>(nn) * g.c * hw + r;
    o.out[base + shuffle_dest(g.c, hc + k) * hw] =
        narrow<S>(act(bn(o.u[e], cm[k], cm[hc + k], cm[2 * hc + k], cm[3 * hc + k]), o.leak));
    o.out[base + shuffle_dest(g.c, k) * hw] = o.x[base + k * hw];
  }
}

// Backward 1: BN3's sums (sum g_a3 xh3, sum g_a3), and the shortcut half of
// gx, the unshuffled output gradient; in bf16 also the branch input copied
// channel-major (xb) for k_wgrad's 16-byte loads.
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_bn3_back(Call a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, hw = g.hw, k = blockIdx.y;
  const int n0 = blockIdx.x * a.ipb, n1 = min(g.n, n0 + a.ipb);
  const int dk = shuffle_dest(g.c, hc + k), ds = shuffle_dest(g.c, k);
  const T m3 = o.m3[k], r3 = rstd(o.v3[k], o.eps), g3 = o.g3[k], be3 = o.be3[k];
  T s[2] = {T(0), T(0)};
  // pixel (nn, r) of the run, advanced by kThreads without a division
  int nn = n0 + static_cast<int>(threadIdx.x) / hw, r = static_cast<int>(threadIdx.x) % hw;
  while (nn < n1) {
    const int64_t base = static_cast<int64_t>(nn) * g.c * hw + r;
    // the branch input, loaded with the other loads (a load after the
    // stores below would wait for them: the pointers may alias)
    S xv = S();
    if constexpr (sizeof(S) < sizeof(T)) xv = o.x[base + (hc + k) * hw];
    T xh;
    const T ga = ga3_v(o.u[(static_cast<int64_t>(nn) * hc + k) * hw + r],
                       T(wide(o.gout[base + dk * hw])), m3, r3, g3, be3, o.leak, &xh);
    s[0] += ga * xh;
    s[1] += ga;
    o.out[base + k * hw] = o.gout[base + ds * hw];
    if constexpr (sizeof(S) < sizeof(T))
      o.xb[k * pixel_pitch(g.p) + static_cast<int64_t>(nn) * hw + r] = xv;
    for (r += kThreads; r >= hw; r -= hw) ++nn;
  }
  const int64_t ns = a.n_s;
  T* part = o.partial;
  block_sums<T, 2>(s, part + static_cast<int64_t>(k) * ns + blockIdx.x, hc * ns);
  if (!last_block(o.counters + C_CH + 256 * CH_BN3B + k, gridDim.x)) return;
  // rows: sum g_a3 xh3 (BN3 scale), sum g_a3 (BN3 bias)
  if (threadIdx.x < 2)
    o.dvec[(threadIdx.x == 0 ? D_G3 : D_BE3) * hc + k] =
        sum16(part + (threadIdx.x * hc + k) * ns, a.n_s);
}

// Backward 3: g_z2 through BN2, the depthwise transpose, the activation's
// gradient: g_pre1 saved; the sums of g_pre1 xh1, g_pre1, g_z2 and
// g_z2 a1(tap t) for the 9 taps.
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_dw_back(Call a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int planes = planes_per_pass(g.h, g.w, a.ipb) * (g.h + 2) * (g.w + 2);
  T* gz = smem<T>();                  // padded planes of g_z2
  T* a1 = gz + planes;                // padded planes of a1
  T* z1s = a1 + planes;               // padded planes of z1
  const ChannelBlock b = channel_block(a, g, reinterpret_cast<int*>(z1s + planes));
  const int hc = g.hc, hw = g.hw, k = b.k, tid = threadIdx.x;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps), g1 = o.g1[k], be1 = o.be1[k];
  const T m2 = o.m2[k], r2 = rstd(o.v2[k], o.eps), g2 = o.g2[k];
  const T t1 = o.dvec[D_BE2 * hc + k], t2 = o.dvec[D_G2 * hc + k];
  T wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = o.dw[k * 9 + t];
  T s[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) s[r] = T(0);
  for (int n = b.n0; n < b.n1; n += b.pl) {
    const int np = min(b.pl, b.n1 - n);
    const int64_t base = (static_cast<int64_t>(n) * hc + k) * hw;
    __syncthreads();   // the maps are written, the previous pass is done
#pragma unroll 2
    for (int e = tid; e < np * b.plane; e += kThreads) {
      const int f = b.fo[e];
      T vg = T(0), va = T(0), vz = T(0);
      if (f >= 0) {
        vg = gin_v(o.gb2n[base + f], o.z2[base + f], m2, r2, g2, t1, t2, inv_m);
        vz = o.z1[base + f];
        va = act(bn(vz, m1, r1, g1, be1), o.leak);
      }
      gz[e] = vg;
      a1[e] = va;
      z1s[e] = vz;
    }
    __syncthreads();
    for (int e = tid; e < np * hw; e += kThreads) {
      const int c = b.oc[e];
      const T ga1 = dw3x3_t(wt, gz + c, b.pitch);
      const T xh1 = (z1s[c] - m1) * r1;
      const T gp = ga1 * act_grad(affine_rn(g1, xh1, be1), o.leak);
      o.gpre1[base + b.og[e]] = gp;
      s[0] += gp * xh1;
      s[1] += gp;
      const T gzc = gz[c];
      s[2] += gzc;
#pragma unroll
      for (int t = 0; t < 9; ++t) s[3 + t] += gzc * a1[c + (t / 3 - 1) * b.pitch + t % 3 - 1];
    }
  }
  const int64_t ns = a.n_s;
  T* part = o.partial;
  block_sums<T, 12>(s, part + static_cast<int64_t>(k) * ns + b.s, hc * ns);
  if (!last_block(o.counters + C_CH + 256 * CH_DWB + k, gridDim.x)) return;
  // rows: sum g_pre1 xh1 (BN1 scale), sum g_pre1 (BN1 bias), sum g_z2 (dwb),
  // then the 9 taps of ddw
  if (tid < 12) {
    const T v = sum16(part + (tid * hc + k) * ns, a.n_s);
    if (tid < 3)
      o.dvec[(tid == 0 ? D_G1 : tid == 1 ? D_BE1 : D_DWB) * hc + k] = v;
    else
      o.ddw[k * 9 + tid - 3] = v;
  }
}

// ---------------------------------------------------------------------------
// the weight gradients
// ---------------------------------------------------------------------------

// The bf16 weight gradients' partial 64 x 64 tile of one pixel segment on
// the tensor cores.  A (g_u or g_z1) and, for dW3, B (b2n) arrive
// channel-major in float32 by 16-byte cp.async in a WS-deep ring; dW1's B,
// the branch input, arrives channel-major in bf16.  While the products of
// chunk c run, chunk c + 1 is split into the other of two buffers of bf16
// tiles (split3: three of A, three of B; dW1's B copied as it is), so each
// chunk takes one barrier.  dW1 = g_z1 . x takes A's three terms against
// B; dW3 = g_u . b2n the six cross terms of add_product.  Warp w owns rows
// (w % 4) * 16 .. + 15 and columns (w / 4) * 32 .. + 31.
__device__ void wgrad_tc(const Ops<float, bf16>& o, const Geo& g, int which, int o0, int k0,
                         int64_t c0, int64_t c1, float* mine) {
  const int hc = g.hc, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t pp = pixel_pitch(g.p);
  const float* A = which == 0 ? o.gu : o.gz1;
  constexpr int RS = WTILE * WCHUNK;   // a float32 tile of the ring
  constexpr int TS = WTILE * WP;       // a bf16 tile of the split terms
  float* ring = smem<float>();                                     // [WS][2][WTILE][WCHUNK]
  bf16* terms = reinterpret_cast<bf16*>(ring + WS * 2 * RS);       // [2][6][WTILE][WP]
  // the pixels of a 16-byte piece at q of chunk c that lie before p (0-n)
  auto count = [&](int64_t c, int q, int n) {
    const int64_t left = g.p - c * WCHUNK - q;
    return static_cast<int>(left < 0 ? 0 : left < n ? left : n);
  };
  auto issue = [&](int64_t c, int st) {
    float* as = ring + st * 2 * RS;
    const int64_t q0 = c * WCHUNK;
#pragma unroll
    for (int u = 0; u < 2; ++u) {     // 64 rows x 8 pieces of 4 pixels
      const int e = tid + u * kThreads, row = e >> 3, q = 4 * (e & 7);
      const int na = o0 + row < hc ? count(c, q, 4) : 0;
      cp_async16(as + row * WCHUNK + q, na ? A + (o0 + row) * pp + q0 + q : A, 4 * na);
      if (which == 0) {
        const int nb = k0 + row < hc ? count(c, q, 4) : 0;
        cp_async16(as + RS + row * WCHUNK + q, nb ? o.b2n + (k0 + row) * pp + q0 + q : o.b2n,
                   4 * nb);
      }
    }
    if (which == 1) {                 // 64 rows x 4 pieces of 8 pixels
      const int row = tid >> 2, q = 8 * (tid & 3);
      const int nb = k0 + row < hc ? count(c, q, 8) : 0;
      bf16* bs = reinterpret_cast<bf16*>(as + RS);
      cp_async16(bs + row * WCHUNK + q, nb ? o.xb + (k0 + row) * pp + q0 + q : o.xb, 2 * nb);
    }
  };
  // a float32 tile's split into three bf16 tiles at dst, dst + TS, dst + 2 TS
  auto split_tile = [&](const float* src, bf16* dst) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + u * kThreads, row = e >> 3, q = 4 * (e & 7);
      const float4 v = *reinterpret_cast<const float4*>(src + row * WCHUNK + q);
      const Split3 x = split3(v.x), y = split3(v.y), z = split3(v.z), w = split3(v.w);
      bf16* d = dst + row * WP + q;
      *reinterpret_cast<uint2*>(d) = make_uint2(pack_bf16(x.hi, y.hi), pack_bf16(z.hi, w.hi));
      *reinterpret_cast<uint2*>(d + TS) =
          make_uint2(pack_bf16(x.mid, y.mid), pack_bf16(z.mid, w.mid));
      *reinterpret_cast<uint2*>(d + 2 * TS) =
          make_uint2(pack_bf16(x.lo, y.lo), pack_bf16(z.lo, w.lo));
    }
  };
  // ring slot st's chunk into term buffer buf
  auto split = [&](int st, int buf) {
    const float* as = ring + st * 2 * RS;
    bf16* dst = terms + buf * 6 * TS;
    split_tile(as, dst);
    if (which == 0) {
      split_tile(as + RS, dst + 3 * TS);
    } else {
      const int row = tid >> 2, q = 8 * (tid & 3);
      const bf16* bs = reinterpret_cast<const bf16*>(as + RS);
      *reinterpret_cast<uint4*>(dst + 3 * TS + row * WP + q) =
          *reinterpret_cast<const uint4*>(bs + row * WCHUNK + q);
    }
  };
  // ldmatrix row offsets of A (rows o) and B (rows k), both [row][pixel]
  const int l8 = lane >> 3, r8 = lane & 7;
  const int ar = r8 + (l8 & 1) * 8, ac = (l8 >> 1) * 8;
  const int br = r8 + (l8 >> 1) * 8, bc = (l8 & 1) * 8;
  const int wrow = (warp & 3) * 16, wcol = (warp >> 2) * 32;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  // acc += A term . B term over the warp's four 16 x 8 fragments
  auto prod = [&](const uint32_t* af, const uint32_t (*bf)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_bf16(acc[j], af, bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
  };
  // the products of the chunk in term buffer buf
  auto products = [&](int buf) {
    const bf16* at = terms + buf * 6 * TS;
    const bf16* bt = at + 3 * TS;
#pragma unroll
    for (int ks = 0; ks < WCHUNK; ks += 16) {
      uint32_t af[3][4], bf[3][2][4];
#pragma unroll
      for (int tm = 0; tm < 3; ++tm)
        ldsm_x4<false>(af[tm], at + tm * TS + (wrow + ar) * WP + ks + ac);
      if (which == 0) {
#pragma unroll
        for (int tm = 0; tm < 3; ++tm)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            ldsm_x4<false>(bf[tm][hf], bt + tm * TS + (wcol + 16 * hf + br) * WP + ks + bc);
        prod(af[0], bf[0]);   // hi * hi
        prod(af[0], bf[1]);   // hi * mid
        prod(af[1], bf[0]);   // mid * hi
        prod(af[0], bf[2]);   // hi * lo
        prod(af[1], bf[1]);   // mid * mid
        prod(af[2], bf[0]);   // lo * hi
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          ldsm_x4<false>(bf[0][hf], bt + (wcol + 16 * hf + br) * WP + ks + bc);
        prod(af[0], bf[0]);
        prod(af[1], bf[0]);
        prod(af[2], bf[0]);
      }
    }
  };

  // chunks c0 .. c0 + WS - 1 in flight, chunk c0 split into buffer 0
#pragma unroll
  for (int st = 0; st < WS; ++st) {
    if (c0 + st < c1) issue(c0 + st, st);
    cp_commit();
  }
  cp_wait<WS - 1>();
  __syncthreads();
  if (c0 < c1) split(0, 0);
  for (int64_t c = c0; c < c1; ++c) {
    const int i = static_cast<int>(c - c0);
    cp_wait<WS - 2>();
    // chunk c + 1 has landed, chunk c is split, chunk c - 1's products are
    // done; chunk c's ring slot is free
    __syncthreads();
    if (c + WS < c1) issue(c + WS, i % WS);
    cp_commit();
    if (c + 1 < c1) split((i + 1) % WS, (i + 1) & 1);
    products(i & 1);
  }
  cp_wait<0>();
  const int row = wrow + (lane >> 2), col = wcol + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float2*>(mine + row * WTILE + col + 8 * j) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(mine + (row + 8) * WTILE + col + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// dW[o][k] = sum_p A[o][p] B[k][p]: dW3 (A = g_u, B = b2n) and dW1 (A = g_z1,
// B = the branch input), block = (product, segment, 64 x 64 tile), tile
// fastest so that the blocks of one pixel segment run together.  Partials
// part[((w * tiles + tile) * nseg + seg) * 4096 + e]; the last block of each
// group of gsz segments adds its group's in order, and the last group of a
// tile adds the groups' in order into dW, rounded to S.  In float32 and
// float64 both operands go by cp.async and each thread holds a 4 x 4
// register tile; in bf16 the tensor cores compute the partial (wgrad_tc).
template <class T, class S>
__global__ void __launch_bounds__(kThreads) k_wgrad(Call a) {
  constexpr bool kTC = sizeof(S) < sizeof(T);
  constexpr int TT = WTILE * WTILE;
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, hw = g.hw, tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nt = (hc + WTILE - 1) / WTILE, tiles = nt * nt;
  const int tile = blockIdx.x % tiles, rest = blockIdx.x / tiles;
  const int seg = rest % a.nseg, which = rest / a.nseg;
  const int o0 = (tile / nt) * WTILE, k0 = (tile % nt) * WTILE;
  const T* A = which == 0 ? o.gu : o.gz1;
  const T* B = which == 0 ? o.b2n : reinterpret_cast<const T*>(o.x);   // S = T for o.x
  const int bch = which == 0 ? hc : g.c, boff = which == 0 ? 0 : hc;
  const int64_t n_chunks = (g.p + WCHUNK - 1) / WCHUNK;
  const int64_t c0 = static_cast<int64_t>(seg) * a.cps;
  const int64_t c1 = c0 + a.cps < n_chunks ? c0 + a.cps : n_chunks;
  T* as = smem<T>();                 // [WS][WTILE][WL]
  T* bs = as + WS * WTILE * WL;      // [WS][WTILE][WL]
  const int lp = tid & 31, lr = tid >> 5;

  auto issue = [&](int64_t c, int st) {
    const int64_t q = c * WCHUNK + lp;
    const bool v = q < g.p;
    const int nn = v ? static_cast<int>(q / hw) : 0;
    const int r = v ? static_cast<int>(q - int64_t(nn) * hw) : 0;
    const T* pa = A + static_cast<int64_t>(nn) * hc * hw + r;
    const int64_t ob = (static_cast<int64_t>(nn) * bch + boff) * hw + r;
    const T* pb = B + ob;
#pragma unroll
    for (int i = 0; i < WTILE / kWarps; ++i) {
      const int row = lr + kWarps * i;
      const bool va = v && o0 + row < hc, vb = v && k0 + row < hc;
      cp_async(as + (st * WTILE + row) * WL + lp, va ? pa + (o0 + row) * hw : A, va);
      cp_async(bs + (st * WTILE + row) * WL + lp, vb ? pb + (k0 + row) * hw : B, vb);
    }
  };

  T acc[4][4];
  if constexpr (!kTC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll
    for (int s = 0; s < WS - 1; ++s) {
      if (c0 + s < c1) issue(c0 + s, s);
      cp_commit();
    }
    for (int64_t c = c0; c < c1; ++c) {
      const int i = static_cast<int>(c - c0);
      cp_wait<WS - 2>();
      __syncthreads();
      if (c + WS - 1 < c1) issue(c + WS - 1, (i + WS - 1) % WS);
      cp_commit();
      const T* sa = as + (i % WS) * WTILE * WL;
      const T* sb = bs + (i % WS) * WTILE * WL;
#pragma unroll
      for (int kk = 0; kk < WCHUNK; kk += 4) {
        T av[4][4], bv[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) load4(sa + (ty + 16 * ii) * WL + kk, av[ii]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) load4(sb + (tx + 16 * jj) * WL + kk, bv[jj]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += av[ii][u] * bv[jj][u];
      }
    }
    cp_wait<0>();
  }

  T* part = o.partial;
  const int64_t ts = static_cast<int64_t>(which) * tiles + tile;
  T* mine = part + (ts * a.nseg + seg) * TT;
  if constexpr (kTC) {
    wgrad_tc(o, g, which, o0, k0, c0, c1, mine);
  } else {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) mine[(ty + 16 * ii) * WTILE + tx + 16 * jj] = acc[ii][jj];
  }

  const int ngroups = (a.nseg + a.gsz - 1) / a.gsz, grp = seg / a.gsz;
  const int s0 = grp * a.gsz, s1 = min(s0 + a.gsz, a.nseg);
  int* cnt = o.counters + C_WG;
  if (!last_block(cnt + ts * ngroups + grp, s1 - s0)) return;
  // each thread's TT / kThreads entries, the segments in order (the
  // entries' loads are independent)
  constexpr int E = TT / kThreads;
  T s[E];
#pragma unroll
  for (int i = 0; i < E; ++i) s[i] = T(0);
  for (int sg = s0; sg < s1; sg += 4) {   // 4 segments' loads in flight, added in order
    T v[4][E];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < E; ++i)
        v[u][i] = sg + u < s1 ? part[(ts * a.nseg + sg + u) * TT + tid + i * kThreads] : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < E; ++i) s[i] += v[u][i];
  }
  T* gpart = part + static_cast<int64_t>(2) * tiles * a.nseg * TT;
#pragma unroll
  for (int i = 0; i < E; ++i) gpart[(ts * ngroups + grp) * TT + tid + i * kThreads] = s[i];
  if (!last_block(cnt + 2 * tiles * ngroups + ts, ngroups)) return;
#pragma unroll
  for (int i = 0; i < E; ++i) s[i] = T(0);
  for (int gr = 0; gr < ngroups; gr += 4) {
    T v[4][E];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < E; ++i)
        v[u][i] = gr + u < ngroups ? gpart[(ts * ngroups + gr + u) * TT + tid + i * kThreads]
                                   : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < E; ++i) s[i] += v[u][i];
  }
  T* dst = which == 0 ? o.dw3 : o.dw1;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = tid + i * kThreads, oo = o0 + e / WTILE, kk = k0 + e % WTILE;
    if (oo < hc && kk < hc) dst[oo * hc + kk] = round_to<S>(s[i]);
  }
}

// ---------------------------------------------------------------------------
// launch sequences
// ---------------------------------------------------------------------------

// The first error of a launch sequence: each launch is checked right after
// it is made.
struct Errors {
  cudaError_t first = cudaSuccess;
  void operator()() {
    const cudaError_t e = cudaGetLastError();
    if (first == cudaSuccess) first = e;
  }
};

// Launch `kernel` with `smem` bytes of dynamic shared memory (allowed above
// the 48 KB default first) and record its error.
template <class... P, class... A>
void launch(Errors& err, void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t s,
            A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess && err.first == cudaSuccess) err.first = e;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  err();
}

int pw_grid(const Call& a) { return (a.c / 2 + PM - 1) / PM * a.n_pb; }

template <class T, class S>
int infer(const Call& a, cudaStream_t s) {
  const Geo g = geometry(a);
  Errors err;
  launch(err, k_pw<T, S, PW1_INFER>, pw_grid(a), pw_smem_bytes(g.hc, sizeof(T)), s, a);
  Call d = a;   // the depthwise stage's own split of the images
  d.ipb = a.ipi;
  d.n_s = a.n_si;
  launch(err, k_dw_infer<T, S>, dim3(d.n_s, g.hc),
         channel_smem_bytes(g.h, g.w, d.ipb, 1, sizeof(T)), s, d);
  launch(err, k_pw<T, S, PW3_INFER>, pw_grid(a), pw_smem_bytes(g.hc, sizeof(T)), s, a);
  return static_cast<int>(err.first);
}

// bf16 inference: one launch of k_infer_bf16 (PLAN_BAND when no band of the
// map fits a block's shared memory).
int infer_bf16(const Call& a, cudaStream_t s) {
  if (a.rb == 0) return -PLAN_BAND;
  Errors err;
  err.first = cudaFuncSetAttribute(k_infer_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   a.ismem);
  k_infer_bf16<<<a.n * a.nb, 2 * kThreads, a.ismem, s>>>(a);
  err();
  return static_cast<int>(err.first);
}

template <class T, class S>
int train_fwd(const Call& a, cudaStream_t s) {
  const Geo g = geometry(a);
  const dim3 cgrid(a.n_s, g.hc);
  const int64_t total = static_cast<int64_t>(g.n) * g.hc * g.hw;
  const int64_t ogrid = (total + kThreads - 1) / kThreads;
  Errors err;
  launch(err, k_pw<T, S, PW1_TRAIN>, pw_grid(a), pw_launch_smem<T, S>(g.hc, PW1_TRAIN), s, a);
  launch(err, k_dw_train<T, S>, cgrid, channel_smem_bytes(g.h, g.w, a.ipb, 1, sizeof(T)), s, a);
  launch(err, k_pw<T, S, PW3_TRAIN>, pw_grid(a), pw_launch_smem<T, S>(g.hc, PW3_TRAIN), s, a);
  launch(err, k_out_train<T, S>, static_cast<int>(ogrid < 2048 ? ogrid : 2048),
         4 * g.hc * sizeof(T), s, a);
  return static_cast<int>(err.first);
}

template <class T, class S>
int train_bwd(const Call& a, cudaStream_t s) {
  const Geo g = geometry(a);
  const dim3 cgrid(a.n_s, g.hc);
  const int nt = (g.hc + WTILE - 1) / WTILE;
  Errors err;
  launch(err, k_bn3_back<T, S>, cgrid, 0, s, a);
  launch(err, k_pw<T, S, PW3_BACK>, pw_grid(a), pw_launch_smem<T, S>(g.hc, PW3_BACK), s, a);
  launch(err, k_dw_back<T, S>, cgrid, channel_smem_bytes(g.h, g.w, a.ipb, 3, sizeof(T)), s, a);
  launch(err, k_pw<T, S, PW1_BACK>, pw_grid(a), pw_launch_smem<T, S>(g.hc, PW1_BACK), s, a);
  launch(err, k_wgrad<T, S>, 2 * nt * nt * a.nseg, wgrad_smem_bytes<T, S>(), s, a);
  return static_cast<int>(err.first);
}

// The call's plan on the current device, with its counters zeroed on `s`;
// a negative PlanError when the plan refuses the shape.
int prepare(const UnitArgs* args, cudaStream_t s, Call* call) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static_cast<UnitArgs&>(*call) = *args;
  const int refused = make_plan(args->n, args->c, args->h, args->w, sms, call);
  if (refused) return -refused;
  if (args->counters)
    e = cudaMemsetAsync(args->counters, 0, sizeof(int) * call->n_counters, s);
  return static_cast<int>(e);
}

int run(int (*stages)(const Call&, cudaStream_t), const UnitArgs* args, cudaStream_t s) {
  Call call;
  const int err = prepare(args, s, &call);
  return err ? err : stages(call, s);
}

}  // namespace

// The plan of a unit of c channels at n x h x w on CUDA device `device`
// (the wrapper sizes a call's scratch and counters from it): 0, the
// PlanError that refuses the shape, or -1 when the device has no SM count.
extern "C" int cdrl_unit_plan(int device, int n, int c, int h, int w, Plan* out) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return make_plan(n, c, h, w, sms, out);
}

// Entry points: `args` is read on the host and passed to the kernels by
// value; dtype 0 is float32, 1 float64, 2 bfloat16 storage with float32
// compute.  Each zeroes the call's ticket counters and returns the first
// CUDA error of its launches (0 on success), or a negative PlanError for a
// shape the kernels do not take.
extern "C" int cdrl_unit_infer(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? run(infer<float, float>, args, s)
         : dtype == 1 ? run(infer<double, double>, args, s)
                      : run(infer_bf16, args, s);
}

extern "C" int cdrl_unit_train_fwd(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? run(train_fwd<float, float>, args, s)
         : dtype == 1 ? run(train_fwd<double, double>, args, s)
                      : run(train_fwd<float, bf16>, args, s);
}

extern "C" int cdrl_unit_train_bwd(const UnitArgs* args, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? run(train_bwd<float, float>, args, s)
         : dtype == 1 ? run(train_bwd<double, double>, args, s)
                      : run(train_bwd<float, bf16>, args, s);
}
