// Device functions shared by the codec kernels (wire.cu, stage.cu,
// rdma.cu, allreduce.cu): the group quantizer, and the wire format's
// per-group encode and decode, eight values a thread (quantize8 / bytes8
// / put8 / fetch8 / finish8: fc_quant_pack, fc_spike_pack,
// fc_encode_wire, fc_decode_wire, fc_decode_reduce, fc_ar, fc_a2a), so
// that every kernel that quantizes, or writes or reads a wire row, does
// it with the same arithmetic and bytes.
//
// Numerics follow the JAX reference exactly (and the plain PyTorch
// version in repro_torch/core): IEEE division's quotient (__fdiv_rn, or
// the group's reciprocal with Markstein's correction, which rounds the
// same: quant_fast), round half to even, NaN-propagating min/max, scale
// and zero rounded to the meta dtype before use, NaN codes -> 0, and
// dequantize as two roundings (__fmul_rn, __fadd_rn) so no FMA
// contraction changes a value. Min and max order -0.0 below +0.0, as
// XLA's minimum and maximum do (so a group of mixed signed zeros keeps
// the zero JAX keeps). A NaN converted to bf16/fp16 keeps the bits
// jnp.astype keeps (bf16: its sign; fp16: its sign and top 9 payload
// bits, quieted); a NaN scale, which the codec makes by arithmetic, is
// written canonical.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace fc {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool isnan_(float a) { return a != a; }

__device__ __forceinline__ float inf_() { return __int_as_float(0x7f800000); }

// max of two numbers (no NaN) with -0.0 < +0.0: equal operands differ at
// most in the sign of a zero, which AND of the bits settles
__device__ __forceinline__ float zmax(float a, float b) {
  return a == b ? __int_as_float(__float_as_int(a) & __float_as_int(b)) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : zmax(a, b));
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

// ---- reductions over the W lanes that share a group (W divides 32) ------

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

// The group's range: its NaN-propagating min and max (the spikes), the
// range that is quantized, and the spike slots (G when not spiking).
struct Range {
  float vmin, vmax;
  float mn, mx;
  int imin, imax;
};

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

// Loads of a wire row: plain, or through L2 only (ld.global.cg) for a
// row that other SMs or peers wrote, so no stale L1 line is read.
struct LoadPlain {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* a) const { return *a; }
};

struct LoadL2 {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* a) const { return __ldcg(a); }
};

// ---- the wire format: one row's layout and codec parameters ---------------

constexpr int kMaxTheta = 20;

struct WireParams {
  long long rows, n, wb, groups;          // groups per row
  int group, bits, n_planes;
  int unit[3];
  long long plane_off[3];
  long long scale_off, zero_off, sv_off, si_off;
  int spike, scale_int, theta, meta_f16, out_kind;   // out: 0 f32 1 bf16 2 f16
  int rotation;
  unsigned sign_seed;                     // rotation: the sign hash's seed
  float hscale;                           // rotation: 1 / sqrt(group) in f32
  int n_thr;
  int theta_off, theta_q0;                // exp2_div_theta: a multiple of theta >= 128, / theta
  unsigned thr[kMaxTheta];
  float frac[kMaxTheta];
  float eps, mag_min;
};

// params: int64 array in the order below (repro_torch/kernels/wire.py
// _params); thr: theta thresholds (uint32), frac: 2^(r/theta) table, f:
// {eps, mag_min, hscale}.
inline WireParams fill_params(const long long* a, const unsigned* thr, const float* frac,
                              const float* f) {
  WireParams p;
  p.rows = a[0]; p.n = a[1]; p.wb = a[2]; p.group = (int)a[3]; p.bits = (int)a[4];
  p.groups = p.n / p.group;
  p.n_planes = (int)a[5];
  for (int i = 0; i < 3; ++i) { p.unit[i] = (int)a[6 + i]; p.plane_off[i] = a[9 + i]; }
  p.scale_off = a[12]; p.zero_off = a[13]; p.sv_off = a[14]; p.si_off = a[15];
  p.spike = (int)a[16]; p.scale_int = (int)a[17]; p.theta = (int)a[18];
  p.meta_f16 = (int)a[19]; p.out_kind = (int)a[20];
  p.rotation = (int)a[21]; p.sign_seed = (unsigned)a[22];
  p.n_thr = p.theta - 1;
  p.theta_off = ((128 + p.theta - 1) / p.theta) * p.theta;
  p.theta_q0 = p.theta_off / p.theta;
  for (int k = 0; k < kMaxTheta; ++k) {
    p.thr[k] = k < p.n_thr ? thr[k] : 0xffffffffu;
    p.frac[k] = k < p.theta ? frac[k] : 0.f;
  }
  p.eps = f[0];
  p.mag_min = f[1];
  p.hscale = f[2];
  return p;
}

// ---- Eq. 1 integer-log codec (exponent arithmetic, no log2/exp2) --------

__device__ __forceinline__ int floor_log2_theta(float s, const WireParams& p) {
  unsigned u = __float_as_uint(s);
  int e = (int)(u >> 23) - 127;
  unsigned mant = u & 0x7fffffu;
  int r = 0;
  for (int k = 0; k < p.n_thr; ++k) r += (mant >= p.thr[k]) ? 1 : 0;
  return e * p.theta + r;
}

// 2^(v / theta) for a code v >= -128: one unsigned division (w >= 0).
__device__ __forceinline__ float exp2_div_theta(int v, const WireParams& p) {
  const unsigned w = (unsigned)(v + p.theta_off);
  const unsigned wq = w / (unsigned)p.theta;
  const int q = (int)wq - p.theta_q0;
  const int r = (int)(w - wq * (unsigned)p.theta);
  return __fmul_rn(p.frac[r], __int_as_float((q + 127) << 23));
}

__device__ __forceinline__ unsigned char encode_scale(float s, const WireParams& p) {
  s = isnan_(s) ? s : fmaxf(s, p.mag_min);
  int c = floor_log2_theta(s, p);
  c = c < -128 ? -128 : (c > 127 ? 127 : c);
  return (unsigned char)(signed char)c;
}

__device__ __forceinline__ unsigned char encode_signed(float z, const WireParams& p) {
  unsigned sign = z < 0.f ? 1u : 0u;
  float mag = fabsf(z);
  mag = isnan_(mag) ? mag : fmaxf(mag, p.mag_min);
  int ic = floor_log2_theta(mag, p) + 64;
  int c = ic < 1 ? 0 : (ic > 127 ? 127 : ic);
  return (unsigned char)((sign << 7) | (unsigned)c);
}

__device__ __forceinline__ float decode_scale(unsigned char b, const WireParams& p) {
  return exp2_div_theta((int)(signed char)b, p);
}

__device__ __forceinline__ float decode_signed(unsigned char b, const WireParams& p) {
  int mc = b & 0x7f;
  float mag = mc == 0 ? 0.f : exp2_div_theta(mc - 64, p);
  return (b >> 7) ? -mag : mag;
}

// ---- rotation -------------------------------------------------------------

// The fixed sign of in-group position j (repro_torch/core/rotation.py).
__device__ __forceinline__ float rot_sign(int j, unsigned seed) {
  unsigned u = (unsigned)j + seed;
  u = (u ^ (u >> 16)) * 0x7feb352du;
  u = (u ^ (u >> 15)) * 0x846ca68bu;
  u ^= u >> 16;
  return (u & 1u) ? -1.f : 1.f;
}

// ---- eight values a thread (the stage packs, the wire kernels, fc_ar, fc_a2a)
//
// Thread t of a block owns 8 consecutive values of a row, elements
// e0 .. e0 + 7 with e0 a multiple of 8, so its codes fill exactly u whole
// bytes of each unit-u plane (plane_off + e0 / 8 * u): one store (or
// load) a plane, and no byte shared with another thread. A group of G
// values lies on W = G / 8 neighbouring lanes (4, 8 or 16); lt is the
// thread's lane within its group, and in-group position lt * 8 + k holds
// value k. Group min/max and the spike election are shuffles and
// ballots over those W lanes; the meta is written (and read) by the
// group's first four lanes, one section each. Block sizes are multiples of 32,
// and every lane of a warp calls these functions (a lane past the end
// of a row computes on zeros and stores nothing), since they shuffle.

constexpr int kPer = 8;

// nbytes (1, 2, 4 or 8) little-endian bytes of word at dst: one store
// where dst is nbytes-aligned, else byte by byte (a wire row's stride
// need not be a multiple of 8).
__device__ __forceinline__ void store_le(uint8_t* dst, unsigned long long word, int nbytes) {
  if (((uintptr_t)dst & (uintptr_t)(nbytes - 1)) == 0) {
    switch (nbytes) {
      case 8: *reinterpret_cast<unsigned long long*>(dst) = word; return;
      case 4: *reinterpret_cast<unsigned*>(dst) = (unsigned)word; return;
      case 2: *reinterpret_cast<unsigned short*>(dst) = (unsigned short)word; return;
      default: *dst = (uint8_t)word; return;
    }
  }
  for (int b = 0; b < nbytes; ++b) dst[b] = (uint8_t)(word >> (8 * b));
}

// The inverse, with loader Ld.
template <typename Ld>
__device__ __forceinline__ unsigned long long load_le(const uint8_t* src, int nbytes) {
  const Ld ld{};
  if (((uintptr_t)src & (uintptr_t)(nbytes - 1)) == 0) {
    switch (nbytes) {
      case 8: return ld(reinterpret_cast<const unsigned long long*>(src));
      case 4: return ld(reinterpret_cast<const unsigned*>(src));
      case 2: return ld(reinterpret_cast<const unsigned short*>(src));
      default: return ld(src);
    }
  }
  unsigned long long w = 0;
  for (int b = 0; b < nbytes; ++b) w |= (unsigned long long)ld(src + b) << (8 * b);
  return w;
}

// Eight f32 values at src (zeros for an inactive thread): two 16-byte
// loads where src is 16-byte aligned.
__device__ __forceinline__ void load8(const float* __restrict__ src, bool active, float (&v)[kPer]) {
  if (!active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = 0.f;
  } else if (((uintptr_t)src & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = src[k];
  }
}

// Eight bf16 values at src as f32, each cast exactly (its bits above 16
// zero bits, NaN payloads kept, as torch's .to(float32)), zeros for an
// inactive thread: one 16-byte load where src is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src, bool active,
                                     float (&v)[kPer]) {
  if (!active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = 0.f;
  } else if (((uintptr_t)src & 15) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const unsigned w[kPer / 2] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);             // the low half: value 2j
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = __uint_as_float((unsigned)s[k] << 16);
  }
}

// Eight f32 values to dst, 16-byte aligned (an output the wrapper
// allocated): two 16-byte stores.
__device__ __forceinline__ void store8(float* __restrict__ dst, const float (&v)[kPer]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight values as out kind OUT (0 f32, 1 bf16, 2 fp16) at element i of
// out: one or two 16-byte stores where that address is 16-byte aligned,
// else one store a value. The 16-bit kinds convert two values an
// instruction (round to nearest even, f2bf's and f2h's bits for every
// number); a thread holding a NaN converts with f2bf / f2h instead, whose
// NaN bits the paired conversion does not keep.
template <int OUT>
__device__ __forceinline__ void store8_out(void* out, long long i, const float (&v)[kPer]) {
  if (OUT == 0) {
    float* dst = reinterpret_cast<float*>(out) + i;
    if (((uintptr_t)dst & 15) == 0) {
      store8(dst, v);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[k] = v[k];
    }
    return;
  }
  bool nan = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) nan |= isnan_(v[k]);
  unsigned w[kPer / 2];
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    const float a = v[2 * j], b = v[2 * j + 1];
    if (nan) {
      w[j] = OUT == 1 ? f2bf(a) | ((unsigned)f2bf(b) << 16) : f2h(a) | ((unsigned)f2h(b) << 16);
    } else if (OUT == 1) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);     // .x = a: the low half
      w[j] = *reinterpret_cast<const unsigned*>(&t);
    } else {
      const __half2 t = __floats2half2_rn(a, b);
      w[j] = *reinterpret_cast<const unsigned*>(&t);
    }
  }
  unsigned* dst = reinterpret_cast<unsigned*>(reinterpret_cast<unsigned short*>(out) + i);
  if (((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      d16[2 * j] = (unsigned short)w[j];
      d16[2 * j + 1] = (unsigned short)(w[j] >> 16);
    }
  }
}

// The rotation over the group's W lanes, in repro_torch/core/rotation.py's
// order: out_j = sum_i x_i * H[i][j], i increasing, from +0.0, each
// product rounded before its add (H is symmetric, so the same sum is the
// rotation and its transpose). Value i is broadcast from lane i / 8 of the
// group (its value i % 8). With i = 8 l + kk and j = 8 lt + k, the sign
// of H[i][j] (the parity of popcount(i & j)) is parity(l & lt) xor
// parity(kk & k), the second a constant of the unrolled loops; and
// x * (-h) rounds to -(x * h). So each x_i is multiplied once, and each
// output adds or subtracts it: the bits of the plain sums (a NaN comes
// out of the adds canonical either way).
template <int W>
__device__ __forceinline__ void hadamard8(float (&v)[kPer], int lt, float h) {
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  for (int l = 0; l < W; ++l) {
    const bool flip = __popc(l & lt) & 1;
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      float xh = __fmul_rn(__shfl_sync(kFull, v[kk], l, W), h);
      if (flip) xh = -xh;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        acc[k] = (__popc(kk & k) & 1) ? __fsub_rn(acc[k], xh) : __fadd_rn(acc[k], xh);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = acc[k];
}

template <int W>
__device__ __forceinline__ void rotate8(float (&v)[kPer], int lt, const WireParams& p) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = __fmul_rn(v[k], rot_sign(lt * kPer + k, p.sign_seed));
  hadamard8<W>(v, lt, p.hscale);
}

template <int W>
__device__ __forceinline__ void unrotate8(float (&v)[kPer], int lt, const WireParams& p) {
  hadamard8<W>(v, lt, p.hscale);
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = __fmul_rn(v[k], rot_sign(lt * kPer + k, p.sign_seed));
}

// A thread's part of a quantized group: its eight codes (byte k is value
// k's) and the group's meta and range.
struct Code8 {
  unsigned long long codes;
  Meta m;
  Range r;
};

// A float's bits as an int that orders like the float, -0.0 below +0.0
// (zmax's order; NaNs apart). The map is its own inverse.
__device__ __forceinline__ int order_key(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// Min and max of a group without spikes, eight values a thread: integer
// min / max of order keys (one instruction a value), then, in a group
// holding NaN, its first NaN, bits and all (the reduction alone would
// keep whichever NaN its order meets first), found by one ballot.
template <int W>
__device__ __forceinline__ Range plain_range8(const float (&v)[kPer], int lt, int G) {
  int kmin = 0x7fffffff, kmax = (int)0x80000000;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int key = order_key(__float_as_int(v[k]));
    kmin = min(kmin, key);
    kmax = max(kmax, key);
    nan |= isnan_(v[k]);
  }
  for (int o = W / 2; o > 0; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(kFull, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(kFull, kmax, o));
  }
  Range r;
  r.vmin = __int_as_float(order_key(kmin));
  r.vmax = __int_as_float(order_key(kmax));
  const unsigned nans = __ballot_sync(kFull, nan);
  if (nans) {                            // uniform: some group of the warp holds NaN
    const int base = (threadIdx.x & 31) & ~(W - 1);
    int pos[kPer];
    int first = G;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      pos[k] = lt * kPer + k;
      if (isnan_(v[k])) first = min(first, pos[k]);
    }
    first = seg_min_int<W>(first);
    const float fv = seg_value_at<kPer, W>(v, pos, first);
    if ((nans >> base) & ((1u << W) - 1u)) r.vmin = r.vmax = fv;
  }
  r.mn = r.vmin;
  r.mx = r.vmax;
  r.imin = r.imax = G;
  return r;
}

// Order keys as unsigned numbers with every NaN above every number:
// lo_key ascends from -inf, hi_key ascends from +inf down. A number's keys
// are at most kKeyTop.
constexpr unsigned kKeyNegInf = 0x807fffffu;          // order_key(-inf)
constexpr unsigned kKeyPosInf = 0x7f800000u;          // order_key(+inf)
constexpr unsigned kKeyTop = kKeyPosInf - kKeyNegInf;

__device__ __forceinline__ unsigned lo_key(float f) {
  return (unsigned)order_key(__float_as_int(f)) - kKeyNegInf;
}
__device__ __forceinline__ unsigned hi_key(float f) {
  return kKeyPosInf - (unsigned)order_key(__float_as_int(f));
}
__device__ __forceinline__ float lo_value(unsigned k) {
  return __int_as_float(order_key((int)(k + kKeyNegInf)));
}
__device__ __forceinline__ float hi_value(unsigned k) {
  return __int_as_float(order_key((int)(kKeyPosInf - k)));
}

// The two least keys of a multiset, a <= b (duplicates count): x joins.
__device__ __forceinline__ void keep2(unsigned& a, unsigned& b, unsigned x) {
  b = min(b, max(a, x));
  a = min(a, x);
}

// (a1, a2) and (b1, b2), the two least keys of two multisets: their union's.
__device__ __forceinline__ void merge2(unsigned& a1, unsigned& a2, unsigned b1, unsigned b2) {
  a2 = min(min(a2, b2), max(a1, b1));
  a1 = min(a1, b1);
}

// The election by its rule, for a warp with a group holding NaN, or a
// zero at or next to its min or max, or whose min equals its max: the
// slots are the first position equal (==) to the min, and the first
// equal to the max but the min's (in a group holding NaN, the NaNs; a
// group with exactly one NaN forfeits the max slot, both slots on its
// NaN); the shrunk range is the least lo_key and hi_key but the slots'
// (NaNs lie above every number, so they drop out). Each slot is elected
// by one ballot over the lanes holding a match and one shuffle of the
// first such lane's first position.
template <int W>
__device__ __forceinline__ void spike_rule8(const float (&v)[kPer], int lt, Range& r, float& lo,
                                            float& hi) {
  const unsigned group_lanes = ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
  unsigned l1 = ~0u, l2 = ~0u, h1 = ~0u, h2 = ~0u;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    keep2(l1, l2, lo_key(v[k]));
    keep2(h1, h2, hi_key(v[k]));
    nan |= isnan_(v[k]);
  }
  const bool has_nan = __ballot_sync(kFull, nan) & group_lanes;
  for (int o = W / 2; o > 0; o >>= 1) {
    const unsigned a1 = __shfl_xor_sync(kFull, l1, o), a2 = __shfl_xor_sync(kFull, l2, o);
    const unsigned b1 = __shfl_xor_sync(kFull, h1, o), b2 = __shfl_xor_sync(kFull, h2, o);
    merge2(l1, l2, a1, a2);
    merge2(h1, h2, b1, b2);
  }
  r.vmin = lo_value(l1);
  r.vmax = hi_value(h1);
  unsigned em = 0, ex = 0;               // this lane's matches of the min and the max
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    em |= (unsigned)(has_nan ? isnan_(v[k]) : v[k] == r.vmin) << k;
    ex |= (unsigned)(has_nan ? isnan_(v[k]) : v[k] == r.vmax) << k;
  }
  const int lmin = __ffs(__ballot_sync(kFull, em != 0) & group_lanes) - 1;
  r.imin = __shfl_sync(kFull, lt * kPer + __ffs(em) - 1, lmin);
  if ((r.imin >> 3) == lt) ex &= ~(1u << (r.imin & 7));
  const unsigned xs = __ballot_sync(kFull, ex != 0) & group_lanes;
  const int lmax = xs ? __ffs(xs) - 1 : lmin;
  r.imax = xs ? __shfl_sync(kFull, lt * kPer + __ffs(ex) - 1, lmax) : r.imin;   // forfeit
  // the slots' values: a zero slot may hold the other zero than the extreme
  float at_min = 0.f, at_max = 0.f;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    if ((em >> k) & 1u) at_min = v[k];
    if ((ex >> k) & 1u) at_max = v[k];
  }
  at_min = __shfl_sync(kFull, at_min, lmin);
  at_max = __shfl_sync(kFull, at_max, lmax);
  // the least key but the slot's: the second least where the slot holds the least
  const unsigned klo = !has_nan && lo_key(at_min) == l1 ? l2 : l1;
  const unsigned khi = !has_nan && hi_key(at_max) == h1 ? h2 : h1;
  lo = klo > kKeyTop ? inf_() : lo_value(klo);
  hi = khi > kKeyTop ? -inf_() : hi_value(khi);
  if (has_nan) r.vmin = r.vmax = at_min;      // the first NaN, bits and all
}

// The spike election of repro_torch/core/spike.py, eight values a thread
// (spike_rule8 states the rule). In a group without NaN whose min and max
// differ and which has no zero among its two least and two greatest
// values, float order is the rule's: a value equals the min (max) exactly
// when no value is below (above) it, and the max slot cannot be the
// min's. So one pass keeps each lane's two least and two greatest values
// (fminf / fmaxf) and the first position of its least and of its
// greatest, merged over the group's W lanes: each slot is the first lane
// holding the group's extreme (one ballot), at that lane's position (one
// shuffle), and the shrunk range is the second least and second greatest
// values. A NaN shows in the sum of the lane's values (as does inf - inf,
// which only sends its warp to the rule). A warp with any other group
// takes spike_rule8 for all its groups.
template <int W>
__device__ __forceinline__ Range spike_range8(const float (&v)[kPer], int lt) {
  const unsigned group_lanes = ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
  float l1 = inf_(), l2 = inf_(), h1 = -inf_(), h2 = -inf_(), sum = 0.f;
  int pl = 0, ph = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float x = v[k];
    l2 = fminf(l2, fmaxf(l1, x));
    pl = x < l1 ? k : pl;
    l1 = fminf(l1, x);
    h2 = fmaxf(h2, fminf(h1, x));
    ph = x > h1 ? k : ph;
    h1 = fmaxf(h1, x);
    sum = __fadd_rn(sum, x);
  }
  const bool nan = __ballot_sync(kFull, isnan_(sum)) & group_lanes;
  float gl1 = l1, gl2 = l2, gh1 = h1, gh2 = h2;
  for (int o = W / 2; o > 0; o >>= 1) {
    const float a1 = __shfl_xor_sync(kFull, gl1, o), a2 = __shfl_xor_sync(kFull, gl2, o);
    const float b1 = __shfl_xor_sync(kFull, gh1, o), b2 = __shfl_xor_sync(kFull, gh2, o);
    gl2 = fminf(fminf(gl2, a2), fmaxf(gl1, a1));
    gl1 = fminf(gl1, a1);
    gh2 = fmaxf(fmaxf(gh2, b2), fminf(gh1, b1));
    gh1 = fmaxf(gh1, b1);
  }
  Range r;
  r.vmin = gl1;
  r.vmax = gh1;
  const int lmin = __ffs(__ballot_sync(kFull, l1 == gl1) & group_lanes) - 1;
  const int lmax = __ffs(__ballot_sync(kFull, h1 == gh1) & group_lanes) - 1;
  r.imin = __shfl_sync(kFull, lt * kPer + pl, lmin);
  r.imax = __shfl_sync(kFull, lt * kPer + ph, lmax);
  float lo = gl2, hi = gh2;
  if (__any_sync(kFull, nan || gl1 == gh1 || gl1 == 0.f || gh1 == 0.f || gl2 == 0.f || gh2 == 0.f))
    spike_rule8<W>(v, lt, r, lo, hi);
  if (isinf(lo) && lo > 0.f && isinf(hi) && hi < 0.f) {    // all-NaN remainders
    lo = __int_as_float(0x7fc00000);
    hi = lo;
  }
  r.mn = lo;
  r.mx = hi;
  return r;
}

// The codes of a group with scale s: rint((v - z) / s) clamped to
// [0, qmax], a NaN's 0, with IEEE division's quotient. One reciprocal a
// group replaces a division a value: with y = RN(1 / s) (__frcp_rn),
// q0 = RN(a * y) and r = a - q0 * s (exact in one FMA), RN(q0 + r * y) is
// RN(a / s) (Markstein's correction) where every step stays normal and
// finite. `fast` ensures that: s is a bf16 value (8 significant bits,
// the case tests/test_torch_group_division.py checks for every pair of
// significands) in [2^-100, 2^100], and a is first clamped to
// [0, qmax * s] (qmax * s is exact), where a / s >= 2^-3 keeps every step
// normal and smaller quotients round to code 0 either way. The clamp
// gives the clamped code (RN is monotone and RN(qmax * s / s) = qmax),
// and a NaN 0; the quotient, in [0, qmax], converts with rounding half
// to even in one instruction. Any other s (fp16 meta, a NaN or infinite
// scale) divides and clamps after.
struct Div {
  float s, y, top;
  bool fast;
};

__device__ __forceinline__ Div group_div(float s, float qmax, bool bf16) {
  Div d;
  d.s = s;
  d.y = __frcp_rn(s);
  d.top = __fmul_rn(s, qmax);
  d.fast = bf16 && s >= 0x1p-100f && s <= 0x1p100f;
  return d;
}

__device__ __forceinline__ unsigned quant_fast(float a, const Div& d) {
  a = fminf(fmaxf(a, 0.f), d.top);       // fmaxf(NaN, 0) is 0
  const float q = __fmul_rn(a, d.y);
  return __float2uint_rn(__fmaf_rn(__fmaf_rn(-q, d.s, a), d.y, q));
}

// fminf(fmaxf(NaN, 0), qmax) is 0, and a clamped -0.0 converts to 0 too.
__device__ __forceinline__ unsigned quant_div(float a, const Div& d, float qmax) {
  return (unsigned)fminf(fmaxf(rintf(__fdiv_rn(a, d.s)), 0.f), qmax);
}

__device__ __forceinline__ unsigned quant_code8(float v, float z, const Div& d, float qmax) {
  const float a = __fsub_rn(v, z);
  return d.fast ? quant_fast(a, d) : quant_div(a, d, qmax);
}

// The codes of eight values, byte k value k's.
__device__ __forceinline__ unsigned long long codes8(const float (&v)[kPer], float z, const Div& d,
                                                     float qmax) {
  unsigned q[kPer];
  if (d.fast) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) q[k] = quant_fast(__fsub_rn(v[k], z), d);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) q[k] = quant_div(__fsub_rn(v[k], z), d, qmax);
  }
  unsigned long long c = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) c |= (unsigned long long)q[k] << (8 * k);
  return c;
}

// Quantize the thread's eight values v (rotated in place first under
// ROT) as one group of G with its W - 1 neighbours: the group's range
// (with spikes: their election), its meta (rtn_meta) and the codes, the
// spike slots holding the code of the shrunk min. Every kernel that
// quantizes (fc_quant_pack, fc_spike_pack, fc_encode_wire, fc_ar, fc_a2a)
// runs this.
template <int G, bool SPIKE, bool ROT>
__device__ __forceinline__ Code8 quantize8(float (&v)[kPer], int lt, const WireParams& p) {
  constexpr int W = G / kPer;
  const float qmax = (float)((1 << p.bits) - 1);
  if (ROT) rotate8<W>(v, lt, p);
  Code8 c;
  c.r = SPIKE ? spike_range8<W>(v, lt) : plain_range8<W>(v, lt, G);
  c.m = rtn_meta(c.r.mn, c.r.mx, qmax, p.eps, p.meta_f16);
  const Div d = group_div(c.m.s, qmax, !p.meta_f16);
  c.codes = codes8(v, c.m.z, d, qmax);
  if (SPIKE) {
    unsigned long long slots = 0;        // the bytes of this lane's spike slots
    if ((c.r.imin >> 3) == lt) slots |= 0xffull << (8 * (c.r.imin & 7));
    if ((c.r.imax >> 3) == lt) slots |= 0xffull << (8 * (c.r.imax & 7));
    const unsigned long long mn = 0x0101010101010101ull * quant_code8(c.r.mn, c.m.z, d, qmax);
    c.codes = (c.codes & ~slots) | (mn & slots);
  }
  return c;
}

// A thread's bytes of a quantized group in a wire row: its u bytes of
// each plane (at plane_off + e0 / 8 * u), and on lane lt < 4 of the group
// one meta section (lane 0 the scale, 1 the zero, 2 the spike values, 3
// the spike slots): the group's bytes of the wire format (core/
// tilecodec.py). Packed once, they can be put into several rows.
struct Bytes8 {
  unsigned long long plane[3];
  long long at;                          // e0 / 8
  unsigned meta;
  int meta_bytes;                        // 0 on lanes lt >= 4
  long long meta_off;
};

template <int G, bool SPIKE>
__device__ __forceinline__ Bytes8 bytes8(const Code8& c, long long e0, int lt, const WireParams& p) {
  Bytes8 b;
  int shift = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b.plane[i] = 0;
    if (i >= p.n_planes) continue;
    b.plane[i] = pack8(c.codes, p.unit[i], shift);
    shift += p.unit[i];
  }
  b.at = e0 >> 3;
  const long long g = e0 / G;
  const int mb = p.scale_int ? 1 : 2;    // bytes of a scale or zero
  b.meta = 0;
  b.meta_bytes = 0;
  b.meta_off = 0;
  if (lt == 0) {
    b.meta_off = p.scale_off + g * mb;
    b.meta_bytes = mb;
    b.meta = p.scale_int ? encode_scale(c.m.s, p) : c.m.sbits;
  } else if (lt == 1) {
    b.meta_off = p.zero_off + g * mb;
    b.meta_bytes = mb;
    b.meta = p.scale_int ? encode_signed(c.m.z, p) : c.m.zbits;
  } else if (SPIKE && lt == 2) {
    b.meta_off = p.sv_off + 4 * g;
    b.meta_bytes = 4;
    b.meta = to_meta(c.r.vmin, p.meta_f16) | ((unsigned)to_meta(c.r.vmax, p.meta_f16) << 16);
  } else if (SPIKE && lt == 3) {
    b.meta_off = p.si_off + 2 * g * mb;
    b.meta_bytes = 2 * mb;
    b.meta = p.scale_int ? (uint8_t)c.r.imin | ((unsigned)(uint8_t)c.r.imax << 8)
                         : to_meta((float)c.r.imin, p.meta_f16) |
                               ((unsigned)to_meta((float)c.r.imax, p.meta_f16) << 16);
  }
  return b;
}

// Put a thread's packed bytes into wire row w.
__device__ __forceinline__ void put8(uint8_t* __restrict__ w, const Bytes8& b, const WireParams& p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= p.n_planes) break;
    const int u = p.unit[i];
    store_le(w + p.plane_off[i] + b.at * u, b.plane[i], u);
  }
  if (b.meta_bytes) store_le(w + b.meta_off, b.meta, b.meta_bytes);
}

// A thread's raw bytes of one wire row, loaded before any of them is
// used (so that a thread's loads, and several rows' loads, are in flight
// together): its meta section (lane j < 4 of a group: the scale, the
// zero, the spike values, the spike slots; up to 4 bytes) and its u
// bytes of each plane.
struct Raw8 {
  unsigned meta;
  unsigned long long plane[3];
};

// Load a thread's raw bytes of wire row w with loader Ld (LoadL2, the
// default, for rows that other SMs or peers wrote). An inactive thread
// loads nothing.
template <int G, bool SPIKE, typename Ld = LoadL2>
__device__ __forceinline__ Raw8 fetch8(const uint8_t* w, long long e0, int lt, bool active,
                                      const WireParams& p) {
  const Ld ld{};
  Raw8 r;
  r.meta = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.plane[i] = 0;
  if (!active) return r;
  const long long g = e0 / G;
  const int mb = p.scale_int ? 1 : 2;                 // bytes of a scale or zero
  const uint8_t* a = nullptr;
  int nb = 0;
  if (lt == 0) { a = w + p.scale_off + g * mb; nb = mb; }
  else if (lt == 1) { a = w + p.zero_off + g * mb; nb = mb; }
  else if (SPIKE && lt == 2) { a = w + p.sv_off + 4 * g; nb = 4; }
  else if (SPIKE && lt == 3) { a = w + p.si_off + 2 * g * mb; nb = 2 * mb; }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < nb) r.meta |= (unsigned)ld(a + b) << (8 * b);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == p.n_planes) break;
    const int u = p.unit[i];
    r.plane[i] = load_le<Ld>(w + p.plane_off[i] + (e0 >> 3) * u, u);
  }
  return r;
}

// A thread's eight values from its raw bytes, rotated back under ROT:
// the plain decode's bits. Lane j < 4 of the group decodes meta section j,
// and the group's lanes take it by shuffle.
template <int G, bool SPIKE, bool ROT>
__device__ __forceinline__ void finish8(const Raw8& r, int lt, const WireParams& p,
                                        float (&v)[kPer]) {
  constexpr int W = G / kPer;
  float a = 0.f, b = 0.f;               // lane lt's meta section, decoded
  if (lt == 0) {
    a = p.scale_int ? decode_scale((unsigned char)r.meta, p)
                    : from_meta((unsigned short)r.meta, p.meta_f16);
  } else if (lt == 1) {
    a = p.scale_int ? decode_signed((unsigned char)r.meta, p)
                    : from_meta((unsigned short)r.meta, p.meta_f16);
  } else if (SPIKE && lt == 2) {
    a = from_meta((unsigned short)(r.meta & 0xffffu), p.meta_f16);
    b = from_meta((unsigned short)(r.meta >> 16), p.meta_f16);
  } else if (SPIKE && lt == 3) {
    int i0, i1;
    if (p.scale_int) {
      i0 = (int)(signed char)(r.meta & 0xffu);
      i1 = (int)(signed char)((r.meta >> 8) & 0xffu);
    } else {
      i0 = (int)(signed char)(int)from_meta((unsigned short)(r.meta & 0xffffu), p.meta_f16);
      i1 = (int)(signed char)(int)from_meta((unsigned short)(r.meta >> 16), p.meta_f16);
    }
    a = __int_as_float(i0);
    b = __int_as_float(i1);
  }
  const float s = __shfl_sync(kFull, a, 0, W);
  const float z = __shfl_sync(kFull, a, 1, W);
  float sv0 = 0.f, sv1 = 0.f;
  int si0 = -1, si1 = -1;
  if (SPIKE) {
    sv0 = __shfl_sync(kFull, a, 2, W);
    sv1 = __shfl_sync(kFull, b, 2, W);
    si0 = __float_as_int(__shfl_sync(kFull, a, 3, W));
    si1 = __float_as_int(__shfl_sync(kFull, b, 3, W));
  }
  unsigned code[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) code[k] = 0;
  int shift = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == p.n_planes) break;
    const int u = p.unit[i];
    const unsigned long long mask = (1ull << u) - 1ull;
#pragma unroll
    for (int k = 0; k < kPer; ++k) code[k] |= (unsigned)((r.plane[i] >> (k * u)) & mask) << shift;
    shift += u;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = dequant(code[k] & 0xffu, s, z);
    if (SPIKE) {
      const int pos = lt * kPer + k;
      if (pos == si1) v[k] = sv1;
      else if (pos == si0) v[k] = sv0;
    }
  }
  if (ROT) unrotate8<W>(v, lt, p);
}

// Decode the thread's eight values of wire row w into v (fetch8 with
// loader Ld, then finish8). An inactive thread reads nothing and decodes
// zeros.
template <int G, bool SPIKE, bool ROT, typename Ld = LoadL2>
__device__ __forceinline__ void decode8(const uint8_t* w, long long e0, int lt, bool active,
                                        const WireParams& p, float (&v)[kPer]) {
  finish8<G, SPIKE, ROT>(fetch8<G, SPIKE, Ld>(w, e0, lt, active, p), lt, p, v);
}

// CALL(G, SPIKE, ROT) for the config's group and mode (CALL is a macro
// of the caller: a launch, or an occupancy query of its kernel template);
// fail for a group the kernels do not take. Rotation and spike never come
// together (CommConfig refuses them).
#define FC_BY_MODE(p, CALL, fail)                                               \
  switch ((p).group * 4 + ((p).spike ? 1 : 0) + ((p).rotation ? 2 : 0)) {      \
    case 32 * 4: CALL(32, false, false); break;                                \
    case 32 * 4 + 1: CALL(32, true, false); break;                             \
    case 32 * 4 + 2: CALL(32, false, true); break;                             \
    case 64 * 4: CALL(64, false, false); break;                                \
    case 64 * 4 + 1: CALL(64, true, false); break;                             \
    case 64 * 4 + 2: CALL(64, false, true); break;                             \
    case 128 * 4: CALL(128, false, false); break;                              \
    case 128 * 4 + 1: CALL(128, true, false); break;                           \
    case 128 * 4 + 2: CALL(128, false, true); break;                           \
    default: fail;                                                             \
  }

}  // namespace fc

namespace fc {

// The block of the kernels that work eight values a thread over a row:
// the paper's 512 threads (4096 values), or a quarter of it for a call of
// fewer such blocks than the card has SMs (the decode step's (1, 20480):
// 20 blocks in place of 5).
constexpr int kBlockThreads = 512;
constexpr int kBlockThreadsSmall = 128;

// SMs of the current card (cached a card).
inline int sm_count() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Threads a block for a call of `items` threads' work.
inline int block_threads(long long items) {
  return (items + kBlockThreads - 1) / kBlockThreads < sm_count() ? kBlockThreadsSmall : kBlockThreads;
}

// Each kernel library links its own copy of the CUDA runtime (nvcc's
// static cudart), whose current device is its own: every entry point
// makes the card that holds its first tensor current before it launches.
inline int use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, ptr);
  if (e != cudaSuccess) return (int)e;
  if (attr.type != cudaMemoryTypeDevice) return (int)cudaErrorInvalidDevicePointer;
  return (int)cudaSetDevice(attr.device);
}

// The modes of FC_BY_MODE, in its order (rdma.py AR_MODES): CALL(G,
// SPIKE, ROT) for each instantiated (group, spike, rotation).
#define FC_EACH_MODE(CALL)                                                  \
  CALL(32, false, false) CALL(32, true, false) CALL(32, false, true)        \
  CALL(64, false, false) CALL(64, true, false) CALL(64, false, true)        \
  CALL(128, false, false) CALL(128, true, false) CALL(128, false, true)

// cudaFuncGetAttributes of one kernel for the analyzer
// (repro_torch/analysis/smem.py read_attrs): maxThreadsPerBlock, numRegs,
// sharedSizeBytes, localSizeBytes, maxDynamicSharedSizeBytes.
constexpr int kAttrInts = 5;
inline int func_attrs(const void* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.maxThreadsPerBlock;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxDynamicSharedSizeBytes;
  return 0;
}

// In an fc_<source>_attrs(int* out, int cap) entry point: the attributes
// of kernel __VA_ARGS__ into row k of out (cap rows), then the next row;
// on an error the entry point returns its negated code.
#define FC_ATTRS(...)                                                         \
  do {                                                                        \
    if (k >= cap) return -(int)cudaErrorInvalidValue;                         \
    if (const int rc_ = fc::func_attrs((const void*)(__VA_ARGS__), out + fc::kAttrInts * k)) \
      return -rc_;                                                            \
    ++k;                                                                      \
  } while (0)

}  // namespace fc
