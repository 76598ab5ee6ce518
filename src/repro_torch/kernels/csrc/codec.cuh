// Device functions shared by the codec kernels (wire.cu, stage.cu).
//
// Numerics follow the JAX reference exactly (and the plain PyTorch
// version in repro_torch/core): IEEE division (__fdiv_rn), round half to
// even (rintf), NaN-propagating min/max written by hand, scale and zero
// rounded to the meta dtype before use, NaN codes -> 0, and dequantize as
// two roundings (__fmul_rn, __fadd_rn) so no FMA contraction changes a
// value. A NaN converted to bf16/fp16 keeps the bits jnp.astype keeps
// (bf16: its sign; fp16: its sign and top 9 payload bits, quieted); a NaN
// scale, which the codec makes by arithmetic, is written canonical.
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace fc {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool isnan_(float a) { return a != a; }

__device__ __forceinline__ float inf_() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float canonical_nan(float a) {
  return isnan_(a) ? __int_as_float(0x7fc00000) : a;
}

// float32 -> bf16 bits, round to nearest even; NaN -> sign | 0x7FC0
__device__ __forceinline__ unsigned short f2bf(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)(((u >> 16) & 0x8000u) | 0x7fc0u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}

// float32 -> fp16 bits, round to nearest even; NaN -> sign | 0x7E00 | mant >> 13
__device__ __forceinline__ unsigned short f2h(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return (unsigned short)(((u >> 16) & 0x8000u) | 0x7e00u | ((u >> 13) & 0x1ffu));
  return __half_as_ushort(__float2half_rn(f));
}

__device__ __forceinline__ unsigned short to_meta(float f, int f16) {
  return f16 ? f2h(f) : f2bf(f);
}

__device__ __forceinline__ float from_meta(unsigned short b, int f16) {
  return f16 ? __half2float(__ushort_as_half(b)) : __uint_as_float((unsigned)b << 16);
}

// out: 0 f32, 1 bf16, 2 f16
__device__ __forceinline__ void store_out(void* out, long long i, float v, int kind) {
  if (kind == 0) reinterpret_cast<float*>(out)[i] = v;
  else if (kind == 1) reinterpret_cast<unsigned short*>(out)[i] = f2bf(v);
  else reinterpret_cast<unsigned short*>(out)[i] = f2h(v);
}

// ---- reductions over the W lanes that share a group (W divides 32) ------

template <int W>
__device__ __forceinline__ float seg_nan_min(float v) {
  for (int o = W / 2; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ float seg_nan_max(float v) {
  for (int o = W / 2; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ int seg_min_int(int v) {
  for (int o = W / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The value at in-group position ``at``, on every lane of the group.
template <int NV, int W>
__device__ __forceinline__ float seg_value_at(const float (&v)[NV], const int (&pos)[NV], int at) {
  float c = 0.f;
  int have = 0;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (pos[k] == at) {
      c = v[k];
      have = 1;
    }
  for (int o = W / 2; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(kFull, c, o);
    const int oh = __shfl_xor_sync(kFull, have, o);
    if (!have && oh) {
      c = oc;
      have = 1;
    }
  }
  return c;
}

// ---- group range: plain RTN, or spike reserving -------------------------

struct Range {
  float vmin, vmax;    // NaN-propagating group min and max (the spikes)
  float mn, mx;        // the range that is quantized
  int imin, imax;      // spike slots (G when not spiking)
};

// The NV values v[k] at in-group positions pos[k] of this lane, over the
// W lanes that hold one group of G values. In a group holding NaN, min
// and max are its first NaN with that element's bits (the reduction alone
// would keep whichever NaN its order meets first). With spike, the
// election of repro_torch/core/spike.py: the first position equal to the
// min, the
// first (or, if it is the min's, the second) equal to the max; in a
// group holding NaN the NaNs are the matches, and a group with exactly
// one NaN forfeits the max slot. The range is then the min without the
// min slot and the max without the max slot, NaNs ignored; all-NaN
// remainders give NaN.
template <int NV, int W>
__device__ __forceinline__ Range group_range(const float (&v)[NV], const int (&pos)[NV], int G,
                                             bool spike) {
  float vmin = inf_(), vmax = -inf_();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    vmin = nan_min(vmin, v[k]);
    vmax = nan_max(vmax, v[k]);
  }
  Range r;
  r.vmin = seg_nan_min<W>(vmin);
  r.vmax = seg_nan_max<W>(vmax);
  const bool has_nan = isnan_(r.vmin);
  if (__any_sync(kFull, has_nan)) {
    // a group holding NaN: min and max are its first NaN, bits and all
    int first = G;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (isnan_(v[k])) first = min(first, pos[k]);
    first = seg_min_int<W>(first);
    const float fv = seg_value_at<NV, W>(v, pos, first);
    if (has_nan) r.vmin = r.vmax = fv;
  }
  r.mn = r.vmin;
  r.mx = r.vmax;
  r.imin = r.imax = G;
  if (!spike) return r;

  int pmin = G, t1 = G;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const bool em = has_nan ? isnan_(v[k]) : v[k] == r.vmin;
    const bool ex = has_nan ? isnan_(v[k]) : v[k] == r.vmax;
    if (em) pmin = min(pmin, pos[k]);
    if (ex) t1 = min(t1, pos[k]);
  }
  r.imin = seg_min_int<W>(pmin);
  t1 = seg_min_int<W>(t1);
  int t2 = G;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const bool ex = has_nan ? isnan_(v[k]) : v[k] == r.vmax;
    if (ex && pos[k] != t1) t2 = min(t2, pos[k]);
  }
  t2 = seg_min_int<W>(t2);
  r.imax = (t1 == r.imin) ? t2 : t1;
  if (r.imax == G) r.imax = r.imin;               // single-NaN forfeit
  float lo = inf_(), hi = -inf_();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!isnan_(v[k])) {
      if (pos[k] != r.imin) lo = fminf(lo, v[k]);
      if (pos[k] != r.imax) hi = fmaxf(hi, v[k]);
    }
  }
  lo = seg_nan_min<W>(lo);
  hi = seg_nan_max<W>(hi);
  if (isinf(lo) && lo > 0.f && isinf(hi) && hi < 0.f) {
    lo = __int_as_float(0x7fc00000);
    hi = lo;
  }
  r.mn = lo;
  r.mx = hi;
  return r;
}

// ---- RTN ------------------------------------------------------------------

struct Meta {
  unsigned short sbits, zbits;   // scale and zero in the meta dtype
  float s, z;                    // the same, as the codes use them
};

__device__ __forceinline__ Meta rtn_meta(float mn, float mx, float qmax, float eps, int f16) {
  const float scale = __fdiv_rn(__fsub_rn(mx, mn), qmax);
  Meta m;
  m.sbits = to_meta(canonical_nan(nan_max(scale, eps)), f16);
  m.zbits = to_meta(mn, f16);
  m.s = from_meta(m.sbits, f16);
  m.z = from_meta(m.zbits, f16);
  return m;
}

__device__ __forceinline__ unsigned char quant_code(float v, float z, float s, float qmax) {
  float t = rintf(__fdiv_rn(__fsub_rn(v, z), s));
  t = nan_min(nan_max(t, 0.f), qmax);
  return isnan_(t) ? (unsigned char)0 : (unsigned char)t;
}

__device__ __forceinline__ float dequant(unsigned code, float s, float z) {
  return __fadd_rn(__fmul_rn((float)code, s), z);
}

// ---- bit planes (core/wordpack.py's order: LSB first, index order) ------

// Eight consecutive codes (byte j of codes8 is code j) -> the u bytes of
// their unit-u field at bit ``shift``, as one little-endian word: value j
// sits at bit j * u.
__device__ __forceinline__ unsigned long long pack8(unsigned long long codes8, int u, int shift) {
  const unsigned long long mask = (1ull << u) - 1ull;
  unsigned long long word = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) word |= (((codes8 >> (8 * j)) >> shift) & mask) << (j * u);
  return word;
}

// Code bits of element e from one unit-u plane, shifted into place.
__device__ __forceinline__ unsigned plane_field(const uint8_t* plane, long long e, int u, int shift) {
  const int per = 8 / u;
  const unsigned byte = plane[(e * u) / 8];
  return ((byte >> ((int)(e % per) * u)) & ((1u << u) - 1u)) << shift;
}

}  // namespace fc
