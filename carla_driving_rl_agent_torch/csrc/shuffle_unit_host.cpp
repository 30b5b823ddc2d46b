// Host build of the fused ShuffleNet-unit kernels' arithmetic
// (shuffle_unit.cuh), compiled with g++ so that the CPU tests can hold the
// CUDA kernels' math against the plain PyTorch version and the JAX package
// on a machine without a GPU.  Same argument layout and the same stages as
// shuffle_unit.cu: the per-pixel functions, the blocks' moments of the
// batch statistics and their block-order merge, the BatchNorm backward sums
// and the weight-gradient definitions are the kernels'; only the order of
// the parallel sums differs (sequential here).  Also the bfloat16 unit
// (dtype 2): bf16 storage and float32 compute, rounded at the kernels'
// points, its products summed over the split terms that the kernels'
// tensor cores take (shuffle_unit.cuh `add_product`).  Inference walks the
// bands of rows of k_infer_bf16, the halo rows' a1 recomputed (in float32
// and float64 a band is the whole image).

#include <algorithm>
#include <vector>

#include "shuffle_unit.cuh"

namespace {

using namespace cdrl::unit;

// Mean and biased variance of p values v(i): Welford over blocks of
// `per_block` consecutive values (the last one ragged), then the blocks'
// moments merged in block order, as the card reduces a channel.
template <class T, class V>
void block_stats(int64_t p, int64_t per_block, V v, T* mean, T* var) {
  const int64_t nb = (p + per_block - 1) / per_block;
  std::vector<T> n(nb), mu(nb), m2(nb);
  for (int64_t b = 0; b < nb; ++b) {
    Moments<T> m{T(0), T(0), T(0)};
    for (int64_t i = b * per_block; i < p && i < (b + 1) * per_block; ++i) welford(&m, v(i));
    n[b] = m.n;
    mu[b] = m.mean;
    m2[b] = m.m2;
  }
  merge(n.data(), mu.data(), m2.data(), nb, p, mean, var);
}

// Batch mean and biased variance of channel k of an (N, hc, H, W) tensor,
// in blocks of one image each (a channel stage's blocks hold whole images).
template <class T>
void channel_stats(const Geo& g, const T* t, int k, T* mean, T* var) {
  block_stats(g.p, g.hw, [&](int64_t q) { return t[at(g, q, k, g.hc)]; }, mean, var);
}

// u[o] = sum_k w[o][k] v[k] with w rounded to the storage type S (in bf16
// over v's split terms)
template <class S, class T>
T dot_row(const T* w, const T* v, int hc, int o) {
  T s = T(0);
  for (int k = 0; k < hc; ++k) s = add_product<S>(s, round_to<S>(w[o * hc + k]), v[k]);
  return s;
}

template <class T, class S>
void branch_of(const Ops<T, S>& o, const Geo& g, int64_t q, std::vector<T>* v) {
  for (int k = 0; k < g.hc; ++k) (*v)[k] = wide(o.x[at(g, q, g.hc + k, g.c)]);
}

// Inference band by band (rb rows, shuffle_unit.cuh `band_rows`): a1 =
// act(BN1(W1 . branch + b1)) on the band's rows and its halo rows inside the
// image, into zero-padded planes of rb + 2 rows; b2n = BN2(depthwise(a1) +
// dwb) rounded to S on the band's rows; act(BN3(W3 . b2n + b3)) to the
// branch's shuffled channels and the shortcut's copy.  Needs no scratch.
// In bf16 the bands are k_infer_bf16's; in float32 and float64 one band is
// the whole image, and each value is computed as the three-launch kernels
// compute it.
template <class T, class S>
void infer(const UnitArgs& a, int rb) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc, w = g.w, ap = w + 2, plane = (rb + 2) * ap;
  std::vector<T> a1(static_cast<size_t>(hc) * plane), b2n(static_cast<size_t>(hc) * rb * w),
      v(hc);
  for (int n = 0; n < g.n; ++n)
    for (int band = 0; band < cdiv(g.h, rb); ++band) {
      const Band b = band_rows(g.h, rb, band);
      std::fill(a1.begin(), a1.end(), T(0));
      for (int y = b.e0; y < b.e1; ++y)
        for (int x = 0; x < w; ++x) {
          branch_of(o, g, static_cast<int64_t>(n) * g.hw + y * w + x, &v);
          for (int k = 0; k < hc; ++k)
            a1[k * plane + (y - b.y0 + 1) * ap + x + 1] =
                bn_act(dot_row<S>(o.w1, v.data(), hc, k) + o.b1[k], o.m1[k],
                       rstd(o.v1[k], o.eps), o.g1[k], o.be1[k], o.leak);
        }
      const int pb = (b.y1 - b.y0) * w;
      for (int k = 0; k < hc; ++k) {
        const T r2 = rstd(o.v2[k], o.eps);
        for (int p = 0; p < pb; ++p)
          b2n[k * pb + p] = round_to<S>(dw_bn(o.dw + k * 9, o.dwb[k],
                                              a1.data() + k * plane + (p / w + 1) * ap + p % w + 1,
                                              ap, o.m2[k], r2, o.g2[k], o.be2[k]));
      }
      for (int p = 0; p < pb; ++p) {
        const int64_t q = static_cast<int64_t>(n) * g.hw + b.y0 * w + p;
        for (int k = 0; k < hc; ++k) v[k] = b2n[k * pb + p];
        for (int k = 0; k < hc; ++k) {
          o.out[at(g, q, shuffle_dest(g.c, hc + k), g.c)] =
              narrow<S>(bn_act(dot_row<S>(o.w3, v.data(), hc, k) + o.b3[k], o.m3[k],
                               rstd(o.v3[k], o.eps), o.g3[k], o.be3[k], o.leak));
          o.out[at(g, q, shuffle_dest(g.c, k), g.c)] = o.x[at(g, q, k, g.c)];
        }
      }
    }
}

template <class T, class S>
void train_fwd(const UnitArgs& a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc;
  T* st = o.stats;
  std::vector<T> v(hc);
  for (int64_t q = 0; q < g.p; ++q) {
    branch_of(o, g, q, &v);
    for (int k = 0; k < hc; ++k)
      o.z1[at(g, q, k, hc)] = dot_row<S>(o.w1, v.data(), hc, k) + o.b1[k];
  }
  for (int k = 0; k < hc; ++k) channel_stats(g, o.z1, k, st + k, st + hc + k);
  for (int64_t q = 0; q < g.p; ++q)
    for (int k = 0; k < hc; ++k) {
      const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps);
      o.z2[at(g, q, k, hc)] =
          depthwise(o, g, q, k, [&](int64_t nb) { return a1_at(o, g, nb, k, m1, r1); });
    }
  for (int k = 0; k < hc; ++k) channel_stats(g, o.z2, k, st + 2 * hc + k, st + 3 * hc + k);
  for (int64_t q = 0; q < g.p; ++q) {
    for (int k = 0; k < hc; ++k)
      v[k] = round_to<S>(b2n_at(o, g, q, k, o.m2[k], rstd(o.v2[k], o.eps)));
    for (int k = 0; k < hc; ++k)
      o.u[at(g, q, k, hc)] = dot_row<S>(o.w3, v.data(), hc, k) + o.b3[k];
  }
  for (int k = 0; k < hc; ++k) channel_stats(g, o.u, k, st + 4 * hc + k, st + 5 * hc + k);
  for (int64_t q = 0; q < g.p; ++q)
    for (int k = 0; k < hc; ++k) {
      o.out[at(g, q, shuffle_dest(g.c, hc + k), g.c)] = narrow<S>(
          act(bn(o.u[at(g, q, k, hc)], o.m3[k], rstd(o.v3[k], o.eps), o.g3[k], o.be3[k]),
              o.leak));
      o.out[at(g, q, shuffle_dest(g.c, k), g.c)] = o.x[at(g, q, k, g.c)];
    }
}

template <class T, class S>
void train_bwd(const UnitArgs& a) {
  const Ops<T, S> o(a);
  const Geo g = geometry(a);
  const int hc = g.hc;
  const T inv_m = T(1.0 / static_cast<double>(g.p));
  T* dv = o.dvec;
  for (int i = 0; i < N_DVEC * hc; ++i) dv[i] = T(0);
  for (int i = 0; i < hc * hc; ++i) o.dw1[i] = o.dw3[i] = T(0);
  for (int i = 0; i < hc * 9; ++i) o.ddw[i] = T(0);
  // BN3's sums
  for (int64_t q = 0; q < g.p; ++q)
    for (int k = 0; k < hc; ++k) {
      T xh;
      const T ga = ga3_at(o, g, q, k, o.m3[k], rstd(o.v3[k], o.eps), &xh);
      dv[D_G3 * hc + k] += ga * xh;
      dv[D_BE3 * hc + k] += ga;
    }
  // g_u, its sums and dW3; g_b2n = W3^T g_u and BN2's sums
  std::vector<T> gu(hc), b2n(hc);
  for (int64_t q = 0; q < g.p; ++q) {
    for (int k = 0; k < hc; ++k) {
      gu[k] = gu_at(o, g, q, k, o.m3[k], rstd(o.v3[k], o.eps), dv[D_BE3 * hc + k],
                    dv[D_G3 * hc + k], inv_m);
      b2n[k] = b2n_at(o, g, q, k, o.m2[k], rstd(o.v2[k], o.eps));
      dv[D_B3 * hc + k] += gu[k];
    }
    for (int oo = 0; oo < hc; ++oo)
      for (int k = 0; k < hc; ++k)
        o.dw3[oo * hc + k] = add_product<S, T, true>(o.dw3[oo * hc + k], gu[oo], b2n[k]);
    for (int k = 0; k < hc; ++k) {
      T s = T(0);
      for (int oo = 0; oo < hc; ++oo) s = add_product<S>(s, round_to<S>(o.w3[oo * hc + k]), gu[oo]);
      const int64_t i = at(g, q, k, hc);
      o.gb2n[i] = s;
      dv[D_G2 * hc + k] += s * (o.z2[i] - o.m2[k]) * rstd(o.v2[k], o.eps);
      dv[D_BE2 * hc + k] += s;
    }
  }
  // g_z2, the depthwise transpose, g_pre1, BN1's sums, ddw, ddwb
  for (int64_t q = 0; q < g.p; ++q)
    for (int k = 0; k < hc; ++k) {
      const T m1 = o.m1[k], r1 = rstd(o.v1[k], o.eps);
      const T m2 = o.m2[k], r2 = rstd(o.v2[k], o.eps);
      const T t2 = dv[D_G2 * hc + k], t1 = dv[D_BE2 * hc + k];
      T ga1 = T(0);
      for (int t = 0; t < 9; ++t) {
        int64_t nb;
        if (tap(g, q, t, -1, &nb)) ga1 += o.dw[k * 9 + t] * gz2_at(o, g, nb, k, m2, r2, t1, t2, inv_m);
      }
      const int64_t i = at(g, q, k, hc);
      const T xh1 = (o.z1[i] - m1) * r1;
      const T gp = ga1 * act_grad(affine_rn(o.g1[k], xh1, o.be1[k]), o.leak);
      o.gpre1[i] = gp;
      dv[D_G1 * hc + k] += gp * xh1;
      dv[D_BE1 * hc + k] += gp;
      const T gz = gz2_at(o, g, q, k, m2, r2, t1, t2, inv_m);
      dv[D_DWB * hc + k] += gz;
      for (int t = 0; t < 9; ++t) {
        int64_t nb;
        if (tap(g, q, t, +1, &nb)) o.ddw[k * 9 + t] += gz * a1_at(o, g, nb, k, m1, r1);
      }
    }
  // g_z1, its sums and dW1; gx
  std::vector<T> gz1(hc), v(hc);
  for (int64_t q = 0; q < g.p; ++q) {
    branch_of(o, g, q, &v);
    for (int k = 0; k < hc; ++k) {
      gz1[k] = gz1_at(o, g, q, k, o.m1[k], rstd(o.v1[k], o.eps), dv[D_BE1 * hc + k],
                      dv[D_G1 * hc + k], inv_m);
      dv[D_B1 * hc + k] += gz1[k];
      o.out[at(g, q, k, g.c)] = o.gout[at(g, q, shuffle_dest(g.c, k), g.c)];
    }
    for (int oo = 0; oo < hc; ++oo)
      for (int i = 0; i < hc; ++i)
        o.dw1[oo * hc + i] = add_product<S>(o.dw1[oo * hc + i], v[i], gz1[oo]);
    // g_z1 enters the gx product rounded to S; dW1 and db1 take it unrounded
    for (int i = 0; i < hc; ++i) {
      T s = T(0);
      for (int oo = 0; oo < hc; ++oo)
        s = add_product<S>(s, round_to<S>(o.w1[oo * hc + i]), round_to<S>(gz1[oo]));
      o.out[at(g, q, hc + i, g.c)] = narrow<S>(s);
    }
  }
  for (int i = 0; i < hc * hc; ++i) {
    o.dw1[i] = round_to<S>(o.dw1[i]);
    o.dw3[i] = round_to<S>(o.dw3[i]);
  }
}

// dtype 0 float32, 1 float64, 2 bfloat16 storage with float32 compute
template <template <class, class> class F>
void dispatch(const UnitArgs* args, int dtype) {
  if (dtype == 0) F<float, float>::run(*args);
  else if (dtype == 1) F<double, double>::run(*args);
  else F<float, bf16>::run(*args);
}

// bf16 inference in the plan's bands (a shape no band fits runs nothing:
// the kernel refuses it), float32 and float64 in one band per image
template <class T, class S>
struct Infer {
  static void run(const UnitArgs& a) {
    Plan pl;
    infer_band(a.c / 2, a.h, a.w, &pl);
    const int rb = sizeof(S) < sizeof(T) ? pl.rb : a.h;
    if (rb > 0) infer<T, S>(a, rb);
  }
};
template <class T, class S>
struct TrainFwd {
  static void run(const UnitArgs& a) { train_fwd<T, S>(a); }
};
template <class T, class S>
struct TrainBwd {
  static void run(const UnitArgs& a) { train_bwd<T, S>(a); }
};

}  // namespace

extern "C" void cdrl_unit_infer_host(const UnitArgs* args, int dtype) {
  dispatch<Infer>(args, dtype);
}

// bf16 inference in bands of `rb` rows, whatever the plan's band (a band
// taller than the image is the whole image).
extern "C" void cdrl_unit_infer_bands_host(const UnitArgs* args, int rb) {
  infer<float, bf16>(*args, rb);
}

extern "C" void cdrl_unit_train_fwd_host(const UnitArgs* args, int dtype) {
  dispatch<TrainFwd>(args, dtype);
}

extern "C" void cdrl_unit_train_bwd_host(const UnitArgs* args, int dtype) {
  dispatch<TrainBwd>(args, dtype);
}

// The reduction of the batch statistics alone: mean and biased variance of
// v[0..p) from blocks of `per_block` values merged in block order.
extern "C" void cdrl_unit_merge_host(const void* v, int64_t p, int64_t per_block, int dtype,
                                     void* mean, void* var) {
  if (dtype == 0) {
    const float* f = static_cast<const float*>(v);
    block_stats(p, per_block, [&](int64_t i) { return f[i]; }, static_cast<float*>(mean),
                static_cast<float*>(var));
  } else {
    const double* d = static_cast<const double*>(v);
    block_stats(p, per_block, [&](int64_t i) { return d[i]; }, static_cast<double*>(mean),
                static_cast<double*>(var));
  }
}

// The kernels' work split of a unit of c channels at n x h x w on a card of
// `sms` SMs (make_plan): 0, or the PlanError that refuses the shape.
extern "C" int cdrl_unit_plan_host(int n, int c, int h, int w, int sms, Plan* out) {
  return make_plan(n, c, h, w, sms, out);
}

// The inference stages' launches of a unit of c channels at n x h x w on a
// card of `sms` SMs, as shuffle_unit.cu's `infer` makes them, for values of
// `tsize` bytes: out = {blocks of each 1x1 product, blocks of the depthwise
// stage, a product block's and a depthwise block's dynamic shared memory in
// bytes}.  Returns 0, or the PlanError that refuses the shape.
extern "C" int cdrl_unit_infer_launch_host(int n, int c, int h, int w, int sms, int tsize,
                                           int64_t* out) {
  Plan pl;
  const int err = make_plan(n, c, h, w, sms, &pl);
  if (err) return err;
  const int hc = c / 2;
  out[0] = int64_t(cdiv(hc, PM)) * pl.n_pb;
  out[1] = int64_t(pl.n_si) * hc;
  out[2] = pw_smem_bytes(hc, tsize);
  out[3] = channel_smem_bytes(h, w, pl.ipi, 1, tsize);
  return 0;
}

// bf16 inference's launch of a unit of c channels at n x h x w on a card of
// `sms` SMs, as shuffle_unit.cu's `infer_bf16` makes it: out = {blocks,
// rows per band, bands per image, weight panels resident together, a
// block's dynamic shared memory in bytes} (a block is 512 threads).  Returns 0, or
// the PlanError that refuses the shape (PLAN_BAND when no band fits).
extern "C" int cdrl_unit_infer_bf16_launch_host(int n, int c, int h, int w, int sms,
                                                int64_t* out) {
  Plan pl;
  const int err = make_plan(n, c, h, w, sms, &pl);
  if (err) return err;
  if (pl.rb == 0) return PLAN_BAND;
  out[0] = int64_t(n) * pl.nb;
  out[1] = pl.rb;
  out[2] = pl.nb;
  out[3] = pl.panels;
  out[4] = pl.ismem;
  return 0;
}

// The training stages' launches of a unit of c channels at n x h x w on a
// card of `sms` SMs, as shuffle_unit.cu's `train_fwd` and `train_bwd` make
// them, for dtype 0 float32, 1 float64, 2 bfloat16: out = {blocks of each
// 1x1 product, blocks of each channel stage, the dynamic shared memory in
// bytes of PW1_TRAIN, PW3_TRAIN, PW3_BACK and PW1_BACK's blocks, of the
// forward's and the backward's depthwise blocks, blocks of the weight
// gradients, a weight-gradient block's dynamic shared memory}.  Returns 0,
// or the PlanError that refuses the shape.
extern "C" int cdrl_unit_train_launch_host(int n, int c, int h, int w, int sms, int dtype,
                                           int64_t* out) {
  Plan pl;
  const int err = make_plan(n, c, h, w, sms, &pl);
  if (err) return err;
  const int hc = c / 2, nt = cdiv(hc, WTILE);
  const int64_t tsize = dtype == 1 ? 8 : 4;
  out[0] = int64_t(cdiv(hc, PM)) * pl.n_pb;
  out[1] = int64_t(pl.n_s) * hc;
  for (int m = PW1_TRAIN; m <= PW1_BACK; ++m)
    out[2 + m - PW1_TRAIN] = dtype == 0   ? pw_launch_smem<float, float>(hc, m)
                             : dtype == 1 ? pw_launch_smem<double, double>(hc, m)
                                          : pw_launch_smem<float, bf16>(hc, m);
  out[6] = channel_smem_bytes(h, w, pl.ipb, 1, tsize);
  out[7] = channel_smem_bytes(h, w, pl.ipb, 3, tsize);
  out[8] = 2 * int64_t(nt) * nt * pl.nseg;
  out[9] = dtype == 0   ? wgrad_smem_bytes<float, float>()
           : dtype == 1 ? wgrad_smem_bytes<double, double>()
                        : wgrad_smem_bytes<float, bf16>();
  return 0;
}

// v[i] as hi[i] + mid[i] + lo[i] (split3), i < count.
extern "C" void cdrl_unit_split_host(const float* v, int64_t count, float* hi, float* mid,
                                     float* lo) {
  for (int64_t i = 0; i < count; ++i) {
    const Split3 t = split3(v[i]);
    hi[i] = t.hi;
    mid[i] = t.mid;
    lo[i] = t.lo;
  }
}

// out[i] = s[i] + a[i] * b[i] as the bf16 tensor-core products take it
// (add_product with S = bf16; `both`: a float32 too), i < count.
extern "C" void cdrl_unit_product_host(const float* s, const float* a, const float* b,
                                       int64_t count, int both, float* out) {
  for (int64_t i = 0; i < count; ++i)
    out[i] = both ? add_product<bf16, float, true>(s[i], a[i], b[i])
                  : add_product<bf16, float>(s[i], a[i], b[i]);
}
