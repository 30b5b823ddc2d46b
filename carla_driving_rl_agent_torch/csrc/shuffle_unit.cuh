// Per-pixel and per-channel arithmetic of the fused stride-1 ShuffleNet-V2
// unit, shared by the CUDA kernels (shuffle_unit.cu, nvcc) and a host build
// (shuffle_unit_host.cpp, g++) that the CPU tests run against the plain
// PyTorch version and the JAX package.
//
// The unit, on x of shape (N, C, H, W) with hc = C / 2 (NCHW, the port's
// backbone layout):
//   shortcut = x[:, :hc], branch = x[:, hc:]
//   z1 = W1 . branch + b1                 (1x1 conv, W1 (hc, hc))
//   a1 = act(BN1(z1))                     (leaky ReLU6)
//   z2 = dw3x3(a1) + dwb                  (depthwise, SAME, zero outside)
//   b2n = BN2(z2)
//   u  = W3 . b2n + b3                    (1x1 conv, W3 (hc, hc))
//   y  = act(BN3(u))
//   out = channel_shuffle(concat(shortcut, y), groups=2)
// The shuffle puts concat channel i at (i % 2) * hc + i / 2, so shortcut
// channel s lands at dest(s) and branch channel b at dest(hc + b).
//
// BatchNorm in training uses the batch mean and the BIASED variance over
// all N*H*W pixels, eps 1e-3.  A pixel tile's partial statistics are its
// sum and its sum of squared deviations from its own mean; `merge` combines
// tiles (Chan et al.), which keeps the variance free of the cancellation of
// E[z^2] - m^2.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define CDRL_HD __host__ __device__ __forceinline__
#else
#define CDRL_HD inline
#endif

namespace cdrl {
namespace unit {

constexpr int TILE = 32;   // pixels per tile: one warp's lanes on the card

// Everything one call reads and writes.  Pointers are to contiguous arrays
// of the unit's dtype (float or double) on the device (or the host for the
// g++ build).  ops/shuffle_unit.py fills the same layout with ctypes
// (pointers first, then doubles, then ints).
struct UnitArgs {
  // operands: x (N, C, H, W); W1, W3 (hc, hc) as [out][in]; dw (hc, 9) as
  // [channel][tap], taps row-major over (dh, dw) in {-1, 0, 1}^2; the rest
  // (hc,)
  const void* x;
  const void* w1;
  const void* b1;
  const void* g1;
  const void* be1;
  const void* dw;
  const void* dwb;
  const void* g2;
  const void* be2;
  const void* w3;
  const void* b3;
  const void* g3;
  const void* be3;
  // BN statistics (hc,) each: the running ones in inference, the batch ones
  // (rows of the forward's stats output) in the backward pass
  const void* m1;
  const void* v1;
  const void* m2;
  const void* v2;
  const void* m3;
  const void* v3;
  const void* gout;   // backward: gradient of out, (N, C, H, W)
  void* out;          // inference / forward: out; backward: gx
  void* stats;        // forward: (6, hc) rows m1 v1 m2 v2 m3 v3
  void* z1;           // forward: saved z1; inference: a1 scratch; backward: in
  void* z2;           // forward: saved z2; backward: in
  void* u;            // forward: saved u; backward: in
  void* gb2n;         // backward scratch (N, hc, H, W): gradient of b2n
  void* gpre1;        // backward scratch (N, hc, H, W): gradient of BN1's output
  void* dw1;          // backward: (hc, hc)
  void* ddw;          // backward: (hc, 9)
  void* dw3;          // backward: (hc, hc)
  void* dvec;         // backward: (9, hc) rows, see DVec
  void* partial;      // scratch for the two-level reductions
  double eps;
  double leak;
  int n, c, h, w;
  int seg_chunks;     // weight gradients: tiles of TILE pixels per segment
  int n_seg;          // weight gradients: number of pixel segments
};

// Rows of the backward's vector-gradient output `dvec`.
enum DVec { D_B1, D_G1, D_BE1, D_DWB, D_G2, D_BE2, D_B3, D_G3, D_BE3, N_DVEC };

struct Geo {
  int n, c, hc, h, w, hw;
  int64_t p;          // pixels N * H * W
};

CDRL_HD Geo geometry(const UnitArgs& a) {
  Geo g;
  g.n = a.n; g.c = a.c; g.hc = a.c / 2; g.h = a.h; g.w = a.w; g.hw = a.h * a.w;
  g.p = static_cast<int64_t>(a.n) * g.hw;
  return g;
}

// Offset of (pixel q = n * hw + y * w + x, channel ch) in an NCHW tensor of
// `nch` channels.
CDRL_HD int64_t at(const Geo& g, int64_t q, int ch, int nch) {
  const int64_t n = q / g.hw;
  return (n * nch + ch) * g.hw + (q - n * g.hw);
}

// Channel of concat channel i after channel_shuffle(groups=2) over c channels.
CDRL_HD int shuffle_dest(int c, int i) { return (i % 2) * (c / 2) + i / 2; }

// Tap t of the 3x3 window: dh = t / 3 - 1, dw = t % 3 - 1.  The neighbour
// of pixel q at tap t (sign +1) or the pixel that reads q through tap t
// (sign -1); false where it lies outside the image (SAME zero padding).
CDRL_HD bool tap(const Geo& g, int64_t q, int t, int sign, int64_t* nb) {
  const int dh = sign * (t / 3 - 1), dx = sign * (t % 3 - 1);
  const int64_t r = q % g.hw;
  const int y = static_cast<int>(r / g.w) + dh, x = static_cast<int>(r % g.w) + dx;
  if (y < 0 || y >= g.h || x < 0 || x >= g.w) return false;
  *nb = q + dh * g.w + dx;
  return true;
}

// leaky ReLU6 of the ShuffleNet blocks: min(where(x >= 0, x, leak x), 6)
template <class T>
CDRL_HD T act(T x, T leak) {
  const T y = x >= T(0) ? x : leak * x;
  return y < T(6) ? y : T(6);
}

// its gradient: leak below 0, 1 on [0, 6], 0 above (as autograd through the
// plain version passes it, and as the JAX kernel's _act_grad)
template <class T>
CDRL_HD T act_grad(T x, T leak) {
  return x < T(0) ? leak : (x <= T(6) ? T(1) : T(0));
}

template <class T>
CDRL_HD T rstd(T var, T eps) {
  using std::sqrt;
  return T(1) / sqrt(var + eps);
}

// BatchNorm's affine output from the normalised value
template <class T>
CDRL_HD T bn(T z, T mean, T r, T gamma, T beta) { return gamma * ((z - mean) * r) + beta; }

// gamma * xh + beta rounded as two operations, never as a fused
// multiply-add: the activation's gradient is a step at 0 and 6, and the
// backward kernel must take the same step as its plain version (one
// PyTorch operation each) on the same saved tensors
CDRL_HD float affine_rn(float gamma, float xh, float beta) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(__fmul_rn(gamma, xh), beta);
#else
  return gamma * xh + beta;
#endif
}

CDRL_HD double affine_rn(double gamma, double xh, double beta) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(__dmul_rn(gamma, xh), beta);
#else
  return gamma * xh + beta;
#endif
}

// BatchNorm backward to its input, from the gradient g of its output, the
// normalised value xh and the batch sums s1 = sum g, s2 = sum g xh
template <class T>
CDRL_HD T bn_back(T g, T xh, T s1, T s2, T gamma, T r, T inv_m) {
  return gamma * r * (g - (s1 + xh * s2) * inv_m);
}

// Pixels in tile b of p pixels.
CDRL_HD int tile_count(int64_t p, int64_t b) {
  const int64_t left = p - b * TILE;
  return static_cast<int>(left < TILE ? left : TILE);
}

// Mean and biased variance over p pixels from per-tile partials: sums[b] and
// m2s[b] (squared deviations from tile b's mean), read with stride `stride`.
// Sequential over the tiles (the host build; the card merges in a warp).
template <class T>
CDRL_HD void merge(const T* sums, const T* m2s, int64_t n_tiles, int64_t stride,
                   int64_t p, T* mean, T* var) {
  T s = T(0);
  for (int64_t b = 0; b < n_tiles; ++b) s += sums[b * stride];
  const T m = s / T(p);
  T m2 = T(0);
  for (int64_t b = 0; b < n_tiles; ++b) {
    const T nb = T(tile_count(p, b));
    const T d = sums[b * stride] / nb - m;
    m2 += m2s[b * stride] + nb * d * d;
  }
  *mean = m;
  *var = m2 / T(p);
}

// The typed view of UnitArgs.
template <class T>
struct Ops {
  const T *x, *w1, *b1, *g1, *be1, *dw, *dwb, *g2, *be2, *w3, *b3, *g3, *be3;
  const T *m1, *v1, *m2, *v2, *m3, *v3, *gout;
  T *out, *stats, *z1, *z2, *u, *gb2n, *gpre1, *dw1, *ddw, *dw3, *dvec, *partial;
  T eps, leak;

  CDRL_HD explicit Ops(const UnitArgs& a)
      : x((const T*)a.x), w1((const T*)a.w1), b1((const T*)a.b1), g1((const T*)a.g1),
        be1((const T*)a.be1), dw((const T*)a.dw), dwb((const T*)a.dwb),
        g2((const T*)a.g2), be2((const T*)a.be2), w3((const T*)a.w3), b3((const T*)a.b3),
        g3((const T*)a.g3), be3((const T*)a.be3), m1((const T*)a.m1), v1((const T*)a.v1),
        m2((const T*)a.m2), v2((const T*)a.v2), m3((const T*)a.m3), v3((const T*)a.v3),
        gout((const T*)a.gout), out((T*)a.out), stats((T*)a.stats), z1((T*)a.z1),
        z2((T*)a.z2), u((T*)a.u), gb2n((T*)a.gb2n), gpre1((T*)a.gpre1), dw1((T*)a.dw1),
        ddw((T*)a.ddw), dw3((T*)a.dw3), dvec((T*)a.dvec), partial((T*)a.partial),
        eps(T(a.eps)), leak(T(a.leak)) {}
};

// a1 = act(BN1(z1)) at channel k of pixel q, from the saved z1
template <class T>
CDRL_HD T a1_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r) {
  return act(bn(o.z1[at(g, q, k, g.hc)], m, r, o.g1[k], o.be1[k]), o.leak);
}

// z2 at channel k of pixel q: the 9-tap SAME depthwise over `a1(nb)` plus
// its bias (`a1` is a device lambda in the kernels, a host one on the CPU)
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class T, class A1>
CDRL_HD T depthwise(const Ops<T>& o, const Geo& g, int64_t q, int k, A1 a1) {
  T z = o.dwb[k];
  for (int t = 0; t < 9; ++t) {
    int64_t nb;
    if (tap(g, q, t, +1, &nb)) z += o.dw[k * 9 + t] * a1(nb);
  }
  return z;
}

// Gradient of BN2's input z2 at channel k of pixel q (backward), from the
// gradient of b2n and the BN2 sums t1 = sum g_b2n, t2 = sum g_b2n xh2.
template <class T>
CDRL_HD T gz2_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r, T t1, T t2,
                 T inv_m) {
  const int64_t i = at(g, q, k, g.hc);
  return bn_back(o.gb2n[i], (o.z2[i] - m) * r, t1, t2, o.g2[k], r, inv_m);
}

// Gradient of act(BN3(u)) at branch channel k of pixel q, before BN3's
// backward: the shuffled gradient times the activation's gradient.
template <class T>
CDRL_HD T ga3_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r, T* xh) {
  const T xh3 = (o.u[at(g, q, k, g.hc)] - m) * r;
  *xh = xh3;
  const T pre3 = affine_rn(o.g3[k], xh3, o.be3[k]);
  return o.gout[at(g, q, shuffle_dest(g.c, g.hc + k), g.c)] * act_grad(pre3, o.leak);
}

// Gradient of u (BN3's input) at channel k of pixel q, from the BN3 sums
// s1 = sum g_a3, s2 = sum g_a3 xh3.
template <class T>
CDRL_HD T gu_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r, T s1, T s2,
                T inv_m) {
  T xh;
  const T ga = ga3_at(o, g, q, k, m, r, &xh);
  return bn_back(ga, xh, s1, s2, o.g3[k], r, inv_m);
}

// Gradient of z1 (BN1's input) at channel k of pixel q, from the saved
// gradient of BN1's output and the BN1 sums u1 = sum g_pre1, u2 = sum
// g_pre1 xh1.
template <class T>
CDRL_HD T gz1_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r, T u1, T u2,
                 T inv_m) {
  const int64_t i = at(g, q, k, g.hc);
  return bn_back(o.gpre1[i], (o.z1[i] - m) * r, u1, u2, o.g1[k], r, inv_m);
}

// b2n = BN2(z2) at channel k of pixel q, from the saved z2
template <class T>
CDRL_HD T b2n_at(const Ops<T>& o, const Geo& g, int64_t q, int k, T m, T r) {
  return bn(o.z2[at(g, q, k, g.hc)], m, r, o.g2[k], o.be2[k]);
}

}  // namespace unit
}  // namespace cdrl
