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
// all N*H*W pixels, eps 1e-3.  A block of the card (or a block of pixels of
// the host build) keeps its moments of a channel: count, mean and the sum of
// squared deviations from its mean (Welford, one value at a time; two are
// combined with Chan et al.'s formula).  `merge` combines the blocks'
// moments in block order, which keeps the variance free of the cancellation
// of E[z^2] - m^2 and gives the same bits on every run.
//
// Storage and compute types.  The kernels are templated on the compute
// type T (float or double) and the storage type S of x, out, the output
// gradient and gx: S = T, or S = bf16 with T = float (the JAX kernels with
// cd = bfloat16 and f32 MXU passes).  In bf16 everything else stays
// float32: the parameters, the BN statistics, the saved z1, z2 and u, the
// scratch, the vector gradients and every product's accumulation.  Rounded
// to bf16, at the JAX kernels' points (ops/shuffle_unit_pallas.py): W1 and
// W3 as the products load them (JAX's operands are their bf16 copies), BN2's
// output b2n before the W3 product, the output, the gradient of z1 before
// the gx product, gx, and dW1 and dW3.
//
// Every bf16 kernel takes its 1x1 products and weight gradients on the
// tensor cores (bf16 operands, float32 sums).  In inference both operands
// are bf16 values already (x and W1; b2n and W3).  An operand that the JAX
// function keeps in float32 (g_u in W3^T g_u, g_z1 in dW1, both of dW3)
// enters as its split into three bf16 terms, hi + mid + lo, which is exact
// (`split3`); each product of two bf16 values is exact in float32, so the
// products differ from float32 ones only in the order of their sums (and,
// for dW3, in the three smallest cross terms, below 2^-23 of the product:
// `add_product`).  The host build sums the same terms.  bf16 inference is
// one launch over bands of rows (`infer_layout`, `band_rows`); the host
// build walks the same bands.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#define CDRL_HD __host__ __device__ __forceinline__
#else
#define CDRL_HD inline
#endif

namespace cdrl {
namespace unit {

// bfloat16 storage: the card's type under nvcc, its bits under g++; the
// conversions round to nearest even, as __float2bfloat16_rn does.
#ifdef __CUDACC__
using bf16 = __nv_bfloat16;
#else
struct bf16 {
  uint16_t bits;
};
#endif

CDRL_HD float bf16_bits_to_float(uint16_t b) {
  const uint32_t u = uint32_t(b) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// The bits of float32 u rounded to bfloat16 (to nearest even), as float32
// bits; a value that rounds past the largest finite one becomes infinite.
CDRL_HD uint32_t bf16_rn_bits(uint32_t u) { return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u; }

CDRL_HD uint16_t float_to_bf16_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return uint16_t((u >> 16) | 0x40u);   // NaN stays NaN
  return uint16_t(bf16_rn_bits(u) >> 16);
}

CDRL_HD float wide(float v) { return v; }
CDRL_HD double wide(double v) { return v; }
CDRL_HD float wide(bf16 v) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(v);
#else
  uint16_t b;
  memcpy(&b, &v, 2);
  return bf16_bits_to_float(b);
#endif
}

// A compute-type value stored as S (a no-op for S = T).
template <class S, class T>
struct Narrow {
  CDRL_HD static S of(T v) { return v; }
};
template <>
struct Narrow<bf16, float> {
  CDRL_HD static bf16 of(float v) {
#ifdef __CUDA_ARCH__
    return __float2bfloat16_rn(v);
#else
    const uint16_t b = float_to_bf16_bits(v);
    bf16 r;
    memcpy(&r, &b, 2);
    return r;
#endif
  }
};

template <class S, class T>
CDRL_HD S narrow(T v) { return Narrow<S, T>::of(v); }

// v rounded to S and back: a rounding point of the bf16 unit, exact for S = T
template <class S, class T>
CDRL_HD T round_to(T v) { return wide(narrow<S>(v)); }

CDRL_HD float float_of_bits(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// v rounded to bfloat16 (to nearest even) and back, except that a finite v
// whose rounding would overflow is truncated toward zero instead (the
// largest finite float32 value rounds up to infinity).
CDRL_HD float bf16_part(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  uint32_t r = bf16_rn_bits(u);
  if ((r & 0x7f800000u) == 0x7f800000u && (u & 0x7f800000u) != 0x7f800000u) r = u & 0xffff0000u;
  return float_of_bits(r);
}

// A float32 value as the sum of three bfloat16 values.
struct Split3 {
  float hi, mid, lo;
};

// v = hi + mid + lo exactly, each term a bfloat16 value: hi = bf16(v), mid =
// bf16(v - hi), lo = v - hi - mid (both differences are exact in float32:
// each term keeps the next 8 significant bits).  Exact for v = 0 and |v| >=
// 2^-110; below that lo falls under bf16's subnormal spacing (2^-133).
// |mid| <= 2^-8 |v| and |lo| <= 2^-16 |v| (2^-7 and 2^-15 where hi was
// truncated).
CDRL_HD Split3 split3(float v) {
  Split3 t;
  t.hi = bf16_part(v);
  const float r = v - t.hi;
  uint32_t u;
  memcpy(&u, &r, 4);
  t.mid = float_of_bits(bf16_rn_bits(u));   // |r| <= 2^-7 |v|: no overflow
  t.lo = r - t.mid;
  return t;
}

// s + a * b as the products of the bf16 unit's tensor cores take it: for S =
// T the plain s + a * b; for S = bf16 with a bfloat16 a, b enters as its
// split and the three products (each exact in float32) are added to s in
// turn, hi, mid, lo; with `both` a is float32 too and split as well, and the
// six largest of the nine cross products are added, hi*hi, hi*mid, mid*hi,
// hi*lo, mid*mid, lo*hi (the three left out come to about 2^-23 |a b|).
template <class S, class T, bool both = false>
CDRL_HD T add_product(T s, T a, T b) {
  if constexpr (sizeof(S) == sizeof(T)) {
    return s + a * b;
  } else {
    const Split3 y = split3(b);
    if constexpr (!both) {
      s += a * y.hi;
      s += a * y.mid;
      return s + a * y.lo;
    } else {
      const Split3 x = split3(a);
      s += x.hi * y.hi;
      s += x.hi * y.mid;
      s += x.mid * y.hi;
      s += x.hi * y.lo;
      s += x.mid * y.mid;
      return s + x.lo * y.hi;
    }
  }
}

constexpr int PTILE = 64;  // pixels per tile of the 1x1 products
constexpr int PM = 64;     // output channels per block of the 1x1 products
constexpr int WCHUNK = 32; // pixels per chunk of the weight gradients' split-K
constexpr int WTILE = 64;  // output rows and columns of a weight-gradient tile
constexpr int PGROUP = 16; // the most blocks one merge reads

// Everything one call reads and writes.  Pointers are to contiguous arrays
// of the unit's dtype (float or double) on the device (or the host for the
// g++ build), `counters` to int32.  ops/shuffle_unit.py fills the same
// layout with ctypes (pointers first, then doubles, then ints).
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
  void* z1;           // forward: saved z1; float32 / float64 inference: a1
                      // scratch, then b2n in place (z1 and b2n the same
                      // buffer); backward: in
  void* z2;           // forward: saved z2; backward: in
  void* u;            // forward: saved u; backward: in
  void* gb2n;         // backward scratch (N, hc, H, W): gradient of b2n
  void* gpre1;        // backward scratch (N, hc, H, W): gradient of BN1's output
  void* gu;           // backward scratch (N, hc, H, W): gradient of u
  void* b2n;          // backward scratch (N, hc, H, W): BN2's output; float32 /
                      // float64 inference: z1
  void* gz1;          // backward scratch (N, hc, H, W): gradient of z1 (gu, b2n
                      // and gz1 channel-major in bf16, as xb)
  void* xb;           // bf16 backward scratch (hc, pixel_pitch(P)): the branch input
  void* dw1;          // backward: (hc, hc)
  void* ddw;          // backward: (hc, 9)
  void* dw3;          // backward: (hc, hc)
  void* dvec;         // backward: (9, hc) rows, see DVec
  void* partial;      // scratch: the blocks' partials of every reduction
  void* counters;     // the call's own ticket counters (Plan::n_counters),
                      // zeroed by the entry point before its first launch
  double eps;
  double leak;
  int n, c, h, w;
};

// The reductions' ticket counters: the products' second-level tickets by
// stage, their first-level tickets (64 groups per stage), the channel
// stages' tickets (one per channel, 256 per stage), the weight gradients'.
enum Slot { C_PW = 0, C_PWG = 64, C_CH = 1024, C_WG = 2048, N_COUNTERS = 4096 };

// How a call's work splits into blocks.  It is fixed by the shape and the
// card's SM count alone, so two calls on one card reduce in the same order.
struct Plan {
  int tpb;            // products: pixel tiles of PTILE per block
  int n_pb;           // products: pixel blocks (at most PGROUP^2)
  int ipb;            // channel stages: images per block
  int n_s;            // channel stages: image segments per channel (at most PGROUP)
  int ipi;            // inference's depthwise stage: images per block
  int n_si;           // inference's depthwise stage: image segments per channel
  int cps;            // weight gradients: chunks of WCHUNK pixels per segment
  int nseg;           // weight gradients: segments
  int gsz;            // weight gradients: segments per first-level merge
  int n_counters;     // int32 ticket counters a call needs
  int64_t partial;    // elements of the scratch that holds every stage's partials
  int rb;             // bf16 inference: rows per band (0: no band fits the shared memory)
  int nb;             // bf16 inference: bands per image
  int panels;         // bf16 inference: weight panels resident together (1: W3 replaces W1)
  int ismem;          // bf16 inference: a block's dynamic shared memory in bytes
};

// Why make_plan refuses a shape (0: it does not); PLAN_BAND refuses bf16
// inference alone.
enum PlanError { PLAN_OK, PLAN_EMPTY, PLAN_INDEX, PLAN_MAP, PLAN_COUNTERS, PLAN_BAND };

constexpr int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// A channel stage's pass over its images: at most CH_OWN output pixels and
// CH_FILL zero-padded pixels for each of the block's CH_THREADS threads.
constexpr int CH_THREADS = 256;
constexpr int CH_OWN = 8;
constexpr int CH_FILL = 12;

// Images per pass of a channel stage's zero-padded shared planes (0 when
// one image does not fit).
CDRL_HD int planes_per_pass(int h, int w, int ipb) {
  const int a = CH_OWN * CH_THREADS / (h * w), b = CH_FILL * CH_THREADS / ((h + 2) * (w + 2));
  const int pl = a < b ? a : b;
  return pl < ipb ? pl : ipb;
}

constexpr int64_t SMEM_LIMIT = 232448;   // the dynamic shared memory a block may opt into

// bf16 inference (shuffle_unit.cu k_infer_bf16): a block owns rows [y0, y1)
// of one image, band b of rb rows (an image's last band may be shorter, and
// a band as tall as the image has no halo), and computes a1 on the rows
// [e0, e1): its own and the halo row above and below where they lie inside
// the image.
struct Band {
  int y0, y1, e0, e1;
};

CDRL_HD Band band_rows(int h, int rb, int b) {
  Band r;
  r.y0 = b * rb;
  r.y1 = r.y0 + rb < h ? r.y0 + rb : h;
  r.e0 = r.y0 > 0 ? r.y0 - 1 : 0;
  r.e1 = r.y1 < h ? r.y1 + 1 : h;
  return r;
}

// A row pitch in bf16 values of at least v: a multiple of 8 (ldmatrix reads
// rows of 16 bytes, on 16 bytes) whose eighth is odd, so that the eight rows
// of one ldmatrix read fall in distinct banks.
CDRL_HD int ldsm_pitch(int v) {
  const int e = (v + 7) / 8;
  return 8 * (e % 2 ? e : e + 1);
}

CDRL_HD int64_t align16(int64_t v) { return (v + 15) / 16 * 16; }

// The dynamic shared memory of a k_infer_bf16 block of rb-row bands, in
// bytes from its start, each region on 16 bytes:
//   * panels: `panels` bf16 weight panels [m][k] of kpad x ppitch, W1 and
//     W3 (with one, W3 replaces W1 after the W1 product);
//   * xs at x_off: bf16 [k][pixel], kpad x xpitch: the branch input of the
//     rows [e0, e1) (xcols pixel columns, a multiple of 8), then b2n of the
//     band: the products' pixel operand, rows hc .. kpad - 1 zero (the
//     products' 32-pixel tiles may read past a row's columns, into the next
//     row or a1's region: only pixels past the band's come from there);
//   * a1 at a_off: first the staging of x's rows [e0, e1) (hc rows of spx
//     bytes) and of the band's shortcut rows (hc rows of sps bytes), the
//     aligned 16-byte pieces of device memory that hold them; then float32,
//     hc zero-padded planes of (rb + 2) x apitch, a1 of the rows y0 - 1 ..
//     y0 + rb (zero outside the image); then the output tile in bf16, hc
//     rows of spitch;
//   * constants at c_off: float32 [UNIT_CONSTS][hc], per channel the
//     depthwise's 9 taps, dwb, m2, rstd2, g2, be2, then b1, m1, rstd1, g1,
//     be1 and b3, m3, rstd3, g3, be3 (the epilogues');
//   * tables at t_off: the a1 offset of each pixel column of xs (xcols
//     int16), the depthwise centre of each band pixel (rb * w int16; a
//     plane of a1 holds at most (h + 2) (w + 2) <= 3072 values, make_plan's
//     PLAN_MAP).
constexpr int UNIT_CONSTS = 24;

struct InferLayout {
  int kpad, ppitch, xcols, xpitch, apitch, aplane, spitch, spx, sps;
  int64_t x_off, a_off, c_off, t_off, bytes;
};

CDRL_HD InferLayout infer_layout(int hc, int h, int w, int rb, int panels) {
  InferLayout l;
  const int ext = rb + 2 < h ? rb + 2 : h;   // the most rows of a1 a band computes
  l.kpad = (hc + 15) / 16 * 16;
  l.ppitch = ldsm_pitch(l.kpad);
  l.xcols = (ext * w + 7) / 8 * 8;
  l.xpitch = ldsm_pitch(l.xcols);
  l.apitch = w + 2;
  l.aplane = (rb + 2) * l.apitch;
  l.spitch = rb * w;
  l.spx = static_cast<int>(align16(2 * ext * w + 31));   // the pieces of ext * w values
  l.sps = static_cast<int>(align16(2 * rb * w + 31));
  l.x_off = align16(int64_t(panels) * l.kpad * l.ppitch * 2);
  l.a_off = align16(l.x_off + int64_t(l.kpad) * l.xpitch * 2);
  const int64_t planes = int64_t(hc) * l.aplane * 4, staged = int64_t(hc) * (l.spx + l.sps);
  l.c_off = align16(l.a_off + (planes > staged ? planes : staged));
  l.t_off = l.c_off + 4 * int64_t(UNIT_CONSTS) * hc;
  l.bytes = l.t_off + 2 * (int64_t(l.xcols) + int64_t(rb) * w);
  return l;
}

// bf16 inference's bands, a block of 512 threads each: the whole image
// where it fits (no halo to recompute: the backbone's three maps), else the
// tallest band that fits (a taller map); both weight panels resident where
// they fit, else one; rb = 0 when not even a band of one row fits.
inline void infer_band(int hc, int h, int w, Plan* pl) {
  for (int whole = 1; whole >= 0; --whole)
    for (int panels = 2; panels >= 1; --panels)
      for (int rb = h; rb >= (whole ? h : 1); --rb) {
        const int64_t bytes = infer_layout(hc, h, w, rb, panels).bytes;
        if (bytes <= SMEM_LIMIT) {
          pl->rb = rb;
          pl->nb = cdiv(h, rb);
          pl->panels = panels;
          pl->ismem = static_cast<int>(bytes);
          return;
        }
      }
  pl->rb = pl->nb = pl->panels = pl->ismem = 0;
}

// The plan of a unit of c channels at n x h x w on a card of `sms` SMs:
//   * products: n_pb blocks of tpb 64-pixel tiles for each 64-channel
//     tile, about two blocks per SM, and never more blocks than one
//     two-level merge reads (PGROUP groups of PGROUP);
//   * channel stages: n_s runs of ipb images per channel, 32 images (the
//     fastest of 8-128 at the backbone's maps on the H100), at most PGROUP
//     runs; inference's depthwise stage, which merges no statistic, two
//     passes of images per block (the fastest of one, two and 32 images'
//     worth at the backbone's maps on the H100);
//   * weight gradients: nseg segments of cps 32-pixel chunks for each
//     64 x 64 output tile of the two gradients, at most two blocks per SM
//     (one wave: the kernel holds 2 blocks per SM), merged in groups of gsz
//     segments, then across the groups.
//   * bf16 inference: n x nb blocks of rb-row bands (`infer_band`).
inline int make_plan(int n, int c, int h, int w, int sms, Plan* pl) {
  const int hc = c / 2;
  if (n <= 0 || hc <= 0 || h <= 0 || w <= 0) return PLAN_EMPTY;
  if (static_cast<int64_t>(n) * c * h * w >= (int64_t(1) << 31)) return PLAN_INDEX;
  if (h * w > CH_OWN * CH_THREADS || (h + 2) * (w + 2) > CH_FILL * CH_THREADS) return PLAN_MAP;
  const int64_t p = static_cast<int64_t>(n) * h * w;
  const int tiles = cdiv(p, PTILE);
  const int split = cdiv(static_cast<int64_t>(tiles) * cdiv(hc, PM), 2 * sms);
  const int reach = cdiv(tiles, PGROUP * PGROUP);
  pl->tpb = split > reach ? split : reach;
  pl->tpb = pl->tpb > 1 ? pl->tpb : 1;
  pl->n_pb = cdiv(tiles, pl->tpb);
  const int runs = cdiv(n, PGROUP);
  pl->ipb = runs > 32 ? runs : 32;
  pl->ipb = pl->ipb < n ? pl->ipb : n;
  pl->n_s = cdiv(n, pl->ipb);
  pl->ipi = 2 * planes_per_pass(h, w, n);
  pl->ipi = pl->ipi < n ? pl->ipi : n;
  pl->n_si = cdiv(n, pl->ipi);
  const int chunks = cdiv(p, WCHUNK), wtiles = cdiv(hc, WTILE) * cdiv(hc, WTILE);
  int segs = sms / wtiles;
  segs = segs < chunks ? segs : chunks;
  pl->cps = cdiv(chunks, segs > 1 ? segs : 1);
  pl->nseg = cdiv(chunks, pl->cps);
  int r = 0;   // floor(sqrt(nseg - 1))
  while ((r + 1) * (r + 1) <= pl->nseg - 1) ++r;
  pl->gsz = r + 1;
  const int groups = cdiv(pl->nseg, pl->gsz);
  if (hc > 256 || C_WG + 2 * wtiles * (groups + 1) > N_COUNTERS) return PLAN_COUNTERS;
  pl->n_counters = N_COUNTERS;
  const int64_t pw = 3 * int64_t(hc) * (pl->n_pb + cdiv(pl->n_pb, PGROUP));
  const int64_t ch = 12 * int64_t(hc) * pl->n_s;
  const int64_t wg = 2 * int64_t(wtiles) * (pl->nseg + groups) * WTILE * WTILE;
  pl->partial = pw > ch ? (pw > wg ? pw : wg) : (ch > wg ? ch : wg);
  infer_band(hc, h, w, pl);
  return PLAN_OK;
}

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

// act(BN(z)): the epilogues of inference's two 1x1 products (a1 from z1,
// BN1; the branch output from u, BN3), on the running statistics
template <class T>
CDRL_HD T bn_act(T z, T mean, T r, T gamma, T beta, T leak) {
  return act(bn(z, mean, r, gamma, beta), leak);
}

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

// Gradient of act(BN3(u)) before BN3's backward, from u and the shuffled
// output gradient go of its channel; *xh gets BN3's normalised value.
template <class T>
CDRL_HD T ga3_v(T u, T go, T m, T r, T gamma, T beta, T leak, T* xh) {
  const T xh3 = (u - m) * r;
  *xh = xh3;
  return go * act_grad(affine_rn(gamma, xh3, beta), leak);
}

// Gradient of u (BN3's input) from u, go and the BN3 sums s1 = sum g_a3,
// s2 = sum g_a3 xh3.
template <class T>
CDRL_HD T gu_v(T u, T go, T m, T r, T gamma, T beta, T s1, T s2, T inv_m, T leak) {
  T xh;
  const T ga = ga3_v(u, go, m, r, gamma, beta, leak, &xh);
  return bn_back(ga, xh, s1, s2, gamma, r, inv_m);
}

// Gradient of a BatchNorm's input z from the gradient g of its output and
// its sums s1 = sum g, s2 = sum g xh (BN2: g_b2n, z2; BN1: g_pre1, z1).
template <class T>
CDRL_HD T gin_v(T g, T z, T m, T r, T gamma, T s1, T s2, T inv_m) {
  return bn_back(g, (z - m) * r, s1, s2, gamma, r, inv_m);
}

// The 3x3 depthwise at the centre `c` of a zero-padded plane of row pitch
// `pitch`: bias + sum_t w[t] c[dh, dw], taps row-major (the card's shared
// planes).
template <class T>
CDRL_HD T dw3x3(const T* w, T bias, const T* c, int pitch) {
  T z = bias;
  for (int t = 0; t < 9; ++t) z += w[t] * c[(t / 3 - 1) * pitch + t % 3 - 1];
  return z;
}

// Inference's b2n = BN2(z2) at the centre `c` of a zero-padded plane of a1,
// BN2 on the running statistics.
template <class T>
CDRL_HD T dw_bn(const T* w, T bias, const T* c, int pitch, T mean, T r, T gamma, T beta) {
  return bn(dw3x3(w, bias, c, pitch), mean, r, gamma, beta);
}

// The 3x3 depthwise transpose at `c`: sum_t w[t] c[-dh, -dw].
template <class T>
CDRL_HD T dw3x3_t(const T* w, const T* c, int pitch) {
  T z = T(0);
  for (int t = 0; t < 9; ++t) z += w[t] * c[-((t / 3 - 1) * pitch + t % 3 - 1)];
  return z;
}

// A block's moments of one channel.
template <class T>
struct Moments {
  T n, mean, m2;
};

template <class T>
CDRL_HD void welford(Moments<T>* a, T v) {
  a->n += T(1);
  const T d = v - a->mean;
  a->mean += d / a->n;
  a->m2 += d * (v - a->mean);
}

// The moments of the union of two disjoint sets (Chan et al.).
template <class T>
CDRL_HD Moments<T> chan(const Moments<T>& a, const Moments<T>& b) {
  if (b.n == T(0)) return a;
  if (a.n == T(0)) return b;
  const T n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  Moments<T> r;
  r.n = n;
  r.mean = a.mean + d * f;
  r.m2 = a.m2 + b.m2 + d * d * a.n * f;
  return r;
}

// Sum of v[0 .. nb), in order.
template <class T>
CDRL_HD T range_sum(const T* v, int64_t nb) {
  T s = T(0);
  for (int64_t b = 0; b < nb; ++b) s += v[b];
  return s;
}

// The moments of the union of blocks 0 .. nb-1 from their rows n, mean, m2,
// in block order and in two passes: the merged mean mu = sum n_b mean_b /
// sum n_b, then the squared deviations sum m2_b + n_b (mean_b - mu)^2 (Chan
// et al.).  Empty blocks add nothing.
template <class T>
CDRL_HD Moments<T> merge_blocks(const T* n, const T* mean, const T* m2, int64_t nb) {
  T cnt = T(0), s = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    cnt += n[b];
    s += n[b] * mean[b];
  }
  Moments<T> r;
  r.n = cnt;
  r.mean = cnt > T(0) ? s / cnt : T(0);
  r.m2 = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    const T d = mean[b] - r.mean;
    r.m2 += m2[b] + n[b] * d * d;
  }
  return r;
}

// Mean and biased variance over p values from the moments of nb blocks.
// The card merges the same way, in two levels for its 1x1 products: groups
// of blocks, then the groups.
template <class T>
CDRL_HD void merge(const T* n, const T* mean, const T* m2, int64_t nb, int64_t p, T* out_mean,
                   T* out_var) {
  const Moments<T> r = merge_blocks(n, mean, m2, nb);
  *out_mean = r.mean;
  *out_var = r.m2 / T(p);
}

constexpr int PK = 32;           // 1x1 products: channels per chunk of the pixel operand
constexpr int OTP = PTILE + 4;   // 1x1 products: row pitch of the output tile
constexpr int PMP = PM + 4;      // 1x1 products: row pitch of the weight panel
// the bf16 tensor-core products: row pitches (in bf16 values) of the weight
// panel and of the pixel operand, 16 bytes past a multiple of 128 so that
// the eight rows of an ldmatrix read fall in distinct banks
constexpr int PMH = PM + 8;
constexpr int PTH = PTILE + 8;
constexpr int WL = WCHUNK + 4;   // weight gradients: shared row pitch
constexpr int WS = 3;            // weight gradients: cp.async ring depth
constexpr int WP = WCHUNK + 8;   // bf16 weight gradients: row pitch of the split terms' tiles

// The 1x1 products' modes (shuffle_unit.cu k_pw).
enum PwMode { PW1_INFER, PW1_TRAIN, PW3_TRAIN, PW3_BACK, PW1_BACK, PW3_INFER };

// Dynamic shared memory of a 1x1-product block of hc channels of `tsize`
// bytes: the weight panel, the operand's double buffer, the output tile,
// the per-channel and per-row constants and the pixel offsets.  With
// `terms` > 0 the bf16 tensor-core layout: the panel and `terms` tiles of
// the pixel operand (its split terms) in bf16, the rest in float32.
inline int64_t pw_smem_bytes(int hc, int64_t tsize, int terms = 0) {
  const int kpad = (hc + PK - 1) / PK * PK;
  const int64_t rest = PM * OTP + 7 * hc + 5 * PM;
  if (terms > 0)
    return 2 * (int64_t(kpad) * PMH + 2 * terms * PK * PTH) + 4 * rest +
           4 * PTILE * int64_t(sizeof(int));
  return tsize * (int64_t(kpad) * PMP + 2 * PK * PTILE + rest) +
         4 * PTILE * int64_t(sizeof(int));
}

// Whether k_pw of storage S over compute T runs on the tensor cores: in
// bf16 (its training modes; bf16 inference is k_infer_bf16).
template <class T, class S>
CDRL_HD constexpr bool pw_tensor_cores() {
  return sizeof(S) < sizeof(T);
}

// A k_pw launch's dynamic shared memory (the pixel operand of PW3_BACK, g_u,
// enters as three split terms).
template <class T, class S>
inline int64_t pw_launch_smem(int hc, int mode) {
  if (pw_tensor_cores<T, S>()) return pw_smem_bytes(hc, sizeof(T), mode == PW3_BACK ? 3 : 1);
  return pw_smem_bytes(hc, sizeof(T));
}

// A k_wgrad launch's dynamic shared memory: the cp.async ring of both
// operands; in bf16 its float32 tiles (pitch WCHUNK) and two buffers of the
// split terms' bf16 tiles (pitch WP), three of each operand.
template <class T, class S>
inline int64_t wgrad_smem_bytes() {
  if (sizeof(S) < sizeof(T)) return 4 * 2 * WS * WTILE * WCHUNK + 2 * 2 * 6 * WTILE * WP;
  return sizeof(T) * 2 * WS * WTILE * WL;
}

// Row pitch, in pixels, of the bf16 backward's channel-major scratch (g_u,
// b2n, g_z1 and the branch input as [channel][pixel]): a multiple of 8, so
// that every row starts on 16 bytes.
CDRL_HD int64_t pixel_pitch(int64_t p) { return (p + 7) / 8 * 8; }

// Dynamic shared memory of a channel stage: `arrays` padded planes of
// `tsize` bytes per image of a pass, then the index maps.
inline int64_t channel_smem_bytes(int h, int w, int ipb, int arrays, int64_t tsize) {
  const int pl = planes_per_pass(h, w, ipb), plane = (h + 2) * (w + 2);
  return tsize * arrays * pl * plane + int64_t(sizeof(int)) * pl * (plane + 2 * h * w);
}

// The typed view of UnitArgs: x, the output gradient and out (or gx) in
// the storage type S, everything else in the compute type T.
template <class T, class S = T>
struct Ops {
  const S *x, *gout;
  const T *w1, *w3, *b1, *g1, *be1, *dw, *dwb, *g2, *be2, *b3, *g3, *be3;
  const T *m1, *v1, *m2, *v2, *m3, *v3;
  S* out;
  S* xb;
  T *stats, *z1, *z2, *u, *gb2n, *gpre1, *gu, *b2n, *gz1, *dw1, *ddw, *dw3, *dvec, *partial;
  int* counters;
  T eps, leak;

  CDRL_HD explicit Ops(const UnitArgs& a)
      : x((const S*)a.x), gout((const S*)a.gout), w1((const T*)a.w1), w3((const T*)a.w3),
        b1((const T*)a.b1), g1((const T*)a.g1),
        be1((const T*)a.be1), dw((const T*)a.dw), dwb((const T*)a.dwb),
        g2((const T*)a.g2), be2((const T*)a.be2), b3((const T*)a.b3),
        g3((const T*)a.g3), be3((const T*)a.be3), m1((const T*)a.m1), v1((const T*)a.v1),
        m2((const T*)a.m2), v2((const T*)a.v2), m3((const T*)a.m3), v3((const T*)a.v3),
        out((S*)a.out), xb((S*)a.xb), stats((T*)a.stats), z1((T*)a.z1),
        z2((T*)a.z2), u((T*)a.u), gb2n((T*)a.gb2n), gpre1((T*)a.gpre1), gu((T*)a.gu),
        b2n((T*)a.b2n), gz1((T*)a.gz1), dw1((T*)a.dw1), ddw((T*)a.ddw), dw3((T*)a.dw3),
        dvec((T*)a.dvec), partial((T*)a.partial), counters((int*)a.counters),
        eps(T(a.eps)), leak(T(a.leak)) {}
};

// a1 = act(BN1(z1)) at channel k of pixel q, from the saved z1
template <class T, class S>
CDRL_HD T a1_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r) {
  return act(bn(o.z1[at(g, q, k, g.hc)], m, r, o.g1[k], o.be1[k]), o.leak);
}

// z2 at channel k of pixel q: the 9-tap SAME depthwise over `a1(nb)` plus
// its bias (`a1` is a device lambda in the kernels, a host one on the CPU)
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class T, class S, class A1>
CDRL_HD T depthwise(const Ops<T, S>& o, const Geo& g, int64_t q, int k, A1 a1) {
  T z = o.dwb[k];
  for (int t = 0; t < 9; ++t) {
    int64_t nb;
    if (tap(g, q, t, +1, &nb)) z += o.dw[k * 9 + t] * a1(nb);
  }
  return z;
}

// Gradient of BN2's input z2 at channel k of pixel q (backward), from the
// gradient of b2n and the BN2 sums t1 = sum g_b2n, t2 = sum g_b2n xh2.
template <class T, class S>
CDRL_HD T gz2_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r, T t1, T t2,
                 T inv_m) {
  const int64_t i = at(g, q, k, g.hc);
  return gin_v(o.gb2n[i], o.z2[i], m, r, o.g2[k], t1, t2, inv_m);
}

// Gradient of act(BN3(u)) at branch channel k of pixel q, before BN3's
// backward: the shuffled gradient times the activation's gradient.
template <class T, class S>
CDRL_HD T ga3_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r, T* xh) {
  const T go = wide(o.gout[at(g, q, shuffle_dest(g.c, g.hc + k), g.c)]);
  return ga3_v(o.u[at(g, q, k, g.hc)], go, m, r, o.g3[k], o.be3[k], o.leak, xh);
}

// Gradient of u (BN3's input) at channel k of pixel q, from the BN3 sums
// s1 = sum g_a3, s2 = sum g_a3 xh3.
template <class T, class S>
CDRL_HD T gu_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r, T s1, T s2,
                T inv_m) {
  const T go = wide(o.gout[at(g, q, shuffle_dest(g.c, g.hc + k), g.c)]);
  return gu_v(o.u[at(g, q, k, g.hc)], go, m, r, o.g3[k], o.be3[k], s1, s2, inv_m, o.leak);
}

// Gradient of z1 (BN1's input) at channel k of pixel q, from the saved
// gradient of BN1's output and the BN1 sums u1 = sum g_pre1, u2 = sum
// g_pre1 xh1.
template <class T, class S>
CDRL_HD T gz1_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r, T u1, T u2,
                 T inv_m) {
  const int64_t i = at(g, q, k, g.hc);
  return gin_v(o.gpre1[i], o.z1[i], m, r, o.g1[k], u1, u2, inv_m);
}

// b2n = BN2(z2) at channel k of pixel q, from the saved z2
template <class T, class S>
CDRL_HD T b2n_at(const Ops<T, S>& o, const Geo& g, int64_t q, int k, T m, T r) {
  return bn(o.z2[at(g, q, k, g.hc)], m, r, o.g2[k], o.be2[k]);
}

}  // namespace unit
}  // namespace cdrl
