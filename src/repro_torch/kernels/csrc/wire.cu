// Wire-codec kernels for Hopper (sm_90a): encode, decode, decode+reduce.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/wire.py     encode_wire (_encode_kernel)  -> fc_encode_wire
//   src/repro/kernels/wire.py     decode_wire (_decode_kernel)  -> fc_decode_wire
//   src/repro/kernels/emulate.py  encode_rows / decode_rows     -> the same two
//   src/repro/kernels/emulate.py  decode_reduce_rows            -> fc_decode_reduce
//
// Bound on an H100: all three are memory-bound. The least time is
// (bytes read + bytes written) / 3.35 TB/s: 4n + wire bytes for encode and
// decode (f32 side), R * wire bytes + 4 * chunk for decode+reduce.
//
// Design. On the serving path a site has one row (tp = 1) of ~10^6..10^7
// values, so the kernels parallelise over quantization groups, not rows:
// one warp owns one group of 32, 64 or 128 values (1, 2 or 4 per lane,
// lane-strided so that loads and stores coalesce). A group fills whole
// bytes of every plane, so each warp writes bytes no other warp touches:
//   plane bytes  plane_off + g * group * unit / 8
//   scale, zero  scale_off + g * meta_bytes, zero_off + g * meta_bytes
//   spikes       sv_off + 4 g,  si_off + 2 g * idx_bytes
// Group min/max and the spike election are warp shuffles; the codes go
// through 128 bytes of shared memory per warp to be packed into planes.
//
// Numerics follow the JAX reference exactly (and the plain PyTorch
// version in repro_torch/core): IEEE division (__fdiv_rn), round half to
// even (rintf), NaN-propagating min/max written by hand, scale and zero
// rounded to the meta dtype before use, NaN codes -> 0, one canonical NaN
// in the meta dtype (0x7FC0 bf16, 0x7E00 fp16), and dequantize as two roundings (__fmul_rn, __fadd_rn)
// so no FMA contraction changes a value.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps (groups) per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 128;
constexpr int kMaxTheta = 20;

struct Params {
  long long rows, n, wb, groups;          // groups per row
  int group, bits, n_planes;
  int unit[3];
  long long plane_off[3];
  long long scale_off, zero_off, sv_off, si_off;
  int spike, scale_int, theta, meta_f16, out_kind;   // out: 0 f32 1 bf16 2 f16
  int n_thr;
  unsigned thr[kMaxTheta];
  float frac[kMaxTheta];
  float eps, mag_min;
};

// ---- float helpers ------------------------------------------------------

__device__ __forceinline__ bool isnan_(float a) { return a != a; }

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}

// float32 -> bf16 bits, round to nearest even; NaN -> canonical 0x7FC0
__device__ __forceinline__ unsigned short f2bf(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}

// float32 -> fp16 bits, round to nearest even; NaN -> canonical 0x7E00
__device__ __forceinline__ unsigned short f2h(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)0x7e00u;
  return __half_as_ushort(__float2half_rn(f));
}

__device__ __forceinline__ unsigned short to_meta(float f, int f16) {
  return f16 ? f2h(f) : f2bf(f);
}

__device__ __forceinline__ float from_meta(unsigned short b, int f16) {
  return f16 ? __half2float(__ushort_as_half(b)) : __uint_as_float((unsigned)b << 16);
}

__device__ __forceinline__ float warp_nan_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- Eq. 1 integer-log codec (exponent arithmetic, no log2/exp2) --------

__device__ __forceinline__ int floor_log2_theta(float s, const Params& p) {
  unsigned u = __float_as_uint(s);
  int e = (int)(u >> 23) - 127;
  unsigned mant = u & 0x7fffffu;
  int r = 0;
  for (int k = 0; k < p.n_thr; ++k) r += (mant >= p.thr[k]) ? 1 : 0;
  return e * p.theta + r;
}

__device__ __forceinline__ float exp2_div_theta(int v, const Params& p) {
  int off = ((128 + p.theta - 1) / p.theta) * p.theta;
  int w = v + off;
  int q = w / p.theta - off / p.theta;
  int r = w - (w / p.theta) * p.theta;
  return __fmul_rn(p.frac[r], __int_as_float((q + 127) << 23));
}

__device__ __forceinline__ unsigned char encode_scale(float s, const Params& p) {
  s = isnan_(s) ? s : fmaxf(s, p.mag_min);
  int c = floor_log2_theta(s, p);
  c = c < -128 ? -128 : (c > 127 ? 127 : c);
  return (unsigned char)(signed char)c;
}

__device__ __forceinline__ unsigned char encode_signed(float z, const Params& p) {
  unsigned sign = z < 0.f ? 1u : 0u;
  float mag = fabsf(z);
  mag = isnan_(mag) ? mag : fmaxf(mag, p.mag_min);
  int ic = floor_log2_theta(mag, p) + 64;
  int c = ic < 1 ? 0 : (ic > 127 ? 127 : ic);
  return (unsigned char)((sign << 7) | (unsigned)c);
}

__device__ __forceinline__ float decode_scale(unsigned char b, const Params& p) {
  return exp2_div_theta((int)(signed char)b, p);
}

__device__ __forceinline__ float decode_signed(unsigned char b, const Params& p) {
  int mc = b & 0x7f;
  float mag = mc == 0 ? 0.f : exp2_div_theta(mc - 64, p);
  return (b >> 7) ? -mag : mag;
}

__device__ __forceinline__ unsigned char quant_code(float v, float z, float s, float qmax) {
  float t = rintf(__fdiv_rn(__fsub_rn(v, z), s));
  t = nan_min(nan_max(t, 0.f), qmax);
  return isnan_(t) ? (unsigned char)0 : (unsigned char)t;
}

__device__ __forceinline__ unsigned short rd16(const uint8_t* w, long long off) {
  return (unsigned short)(w[off] | (w[off + 1] << 8));
}

__device__ __forceinline__ void wr16(uint8_t* w, long long off, unsigned short v) {
  w[off] = (uint8_t)(v & 0xff);
  w[off + 1] = (uint8_t)(v >> 8);
}

// ---- encode ---------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(kThreads) encode_kernel(const float* __restrict__ x,
                                                          uint8_t* __restrict__ wire,
                                                          const Params p) {
  __shared__ uint8_t codes_s[kWarps][kMaxGroup];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  if (gid >= p.rows * p.groups) return;           // uniform per warp
  const long long row = gid / p.groups, g = gid % p.groups;
  const int G = p.group;
  const float* xg = x + row * p.n + g * G;
  uint8_t* w = wire + row * p.wb;
  const float qmax = (float)((1 << p.bits) - 1);

  float v[VPL];
  float vmin = __int_as_float(0x7f800000), vmax = -__int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    v[k] = xg[k * 32 + lane];
    vmin = nan_min(vmin, v[k]);
    vmax = nan_max(vmax, v[k]);
  }
  vmin = warp_nan_min(vmin);
  vmax = warp_nan_max(vmax);

  float mn = vmin, mx = vmax;
  int imin = G, imax = G;
  if (p.spike) {
    const bool has_nan = isnan_(vmin);
    int pmin = G, t1 = G;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int pos = k * 32 + lane;
      const bool em = has_nan ? isnan_(v[k]) : v[k] == vmin;
      const bool ex = has_nan ? isnan_(v[k]) : v[k] == vmax;
      if (em) pmin = min(pmin, pos);
      if (ex) t1 = min(t1, pos);
    }
    imin = warp_min_int(pmin);
    t1 = warp_min_int(t1);
    int t2 = G;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int pos = k * 32 + lane;
      const bool ex = has_nan ? isnan_(v[k]) : v[k] == vmax;
      if (ex && pos != t1) t2 = min(t2, pos);
    }
    t2 = warp_min_int(t2);
    imax = (t1 == imin) ? t2 : t1;
    if (imax == G) imax = imin;                   // single-NaN forfeit
    float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int pos = k * 32 + lane;
      if (!isnan_(v[k])) {
        if (pos != imin) lo = fminf(lo, v[k]);
        if (pos != imax) hi = fmaxf(hi, v[k]);
      }
    }
    lo = warp_nan_min(lo);
    hi = warp_nan_max(hi);
    if (isinf(lo) && lo > 0.f && isinf(hi) && hi < 0.f) {
      lo = __int_as_float(0x7fc00000);
      hi = lo;
    }
    mn = lo;
    mx = hi;
  }

  const float scale = __fdiv_rn(__fsub_rn(mx, mn), qmax);
  const unsigned short sbits = to_meta(nan_max(scale, p.eps), p.meta_f16);
  const unsigned short zbits = to_meta(mn, p.meta_f16);
  const float s = from_meta(sbits, p.meta_f16), z = from_meta(zbits, p.meta_f16);
  const unsigned char code_mn = quant_code(mn, z, s, qmax);

#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int pos = k * 32 + lane;
    unsigned char c = quant_code(v[k], z, s, qmax);
    if (p.spike && (pos == imin || pos == imax)) c = code_mn;
    codes_s[warp][pos] = c;
  }
  __syncwarp();

  int shift = 0;
  for (int i = 0; i < p.n_planes; ++i) {
    const int u = p.unit[i], per = 8 / u, nbytes = G * u / 8;
    const unsigned mask = (1u << u) - 1u;
    uint8_t* dst = w + p.plane_off[i] + g * nbytes;
    for (int b = lane; b < nbytes; b += 32) {
      unsigned byte = 0;
      for (int j = 0; j < per; ++j)
        byte |= ((codes_s[warp][b * per + j] >> shift) & mask) << (j * u);
      dst[b] = (uint8_t)byte;
    }
    shift += u;
  }

  if (lane == 0) {
    if (p.scale_int) {
      w[p.scale_off + g] = encode_scale(s, p);
      w[p.zero_off + g] = encode_signed(z, p);
    } else {
      wr16(w, p.scale_off + 2 * g, sbits);
      wr16(w, p.zero_off + 2 * g, zbits);
    }
    if (p.spike) {
      wr16(w, p.sv_off + 4 * g, to_meta(vmin, p.meta_f16));
      wr16(w, p.sv_off + 4 * g + 2, to_meta(vmax, p.meta_f16));
      if (p.scale_int) {
        w[p.si_off + 2 * g] = (uint8_t)imin;
        w[p.si_off + 2 * g + 1] = (uint8_t)imax;
      } else {
        wr16(w, p.si_off + 4 * g, to_meta((float)imin, p.meta_f16));
        wr16(w, p.si_off + 4 * g + 2, to_meta((float)imax, p.meta_f16));
      }
    }
  }
}

// ---- decode ---------------------------------------------------------------

// One group's metadata, read once per warp.
struct GroupMeta {
  float s, z, sv0, sv1;
  int si0, si1;
};

__device__ __forceinline__ GroupMeta read_meta(const uint8_t* w, long long g, const Params& p) {
  GroupMeta m;
  if (p.scale_int) {
    m.s = decode_scale(w[p.scale_off + g], p);
    m.z = decode_signed(w[p.zero_off + g], p);
  } else {
    m.s = from_meta(rd16(w, p.scale_off + 2 * g), p.meta_f16);
    m.z = from_meta(rd16(w, p.zero_off + 2 * g), p.meta_f16);
  }
  m.sv0 = m.sv1 = 0.f;
  m.si0 = m.si1 = -1;
  if (p.spike) {
    m.sv0 = from_meta(rd16(w, p.sv_off + 4 * g), p.meta_f16);
    m.sv1 = from_meta(rd16(w, p.sv_off + 4 * g + 2), p.meta_f16);
    if (p.scale_int) {
      m.si0 = (int)(signed char)w[p.si_off + 2 * g];
      m.si1 = (int)(signed char)w[p.si_off + 2 * g + 1];
    } else {
      m.si0 = (int)(signed char)(int)from_meta(rd16(w, p.si_off + 4 * g), p.meta_f16);
      m.si1 = (int)(signed char)(int)from_meta(rd16(w, p.si_off + 4 * g + 2), p.meta_f16);
    }
  }
  return m;
}

__device__ __forceinline__ float decode_value(const uint8_t* w, long long g, int pos,
                                              const GroupMeta& m, const Params& p) {
  const long long e = g * p.group + pos;          // element index in the row
  unsigned code = 0;
  int shift = 0;
  for (int i = 0; i < p.n_planes; ++i) {
    const int u = p.unit[i], per = 8 / u;
    const unsigned byte = w[p.plane_off[i] + (e * u) / 8];
    code |= ((byte >> ((int)(e % per) * u)) & ((1u << u) - 1u)) << shift;
    shift += u;
  }
  float val = __fadd_rn(__fmul_rn((float)(code & 0xffu), m.s), m.z);
  if (p.spike) {
    if (pos == m.si1) val = m.sv1;
    else if (pos == m.si0) val = m.sv0;
  }
  return val;
}

__device__ __forceinline__ void store_out(void* out, long long i, float v, int kind) {
  if (kind == 0) reinterpret_cast<float*>(out)[i] = v;
  else if (kind == 1) reinterpret_cast<unsigned short*>(out)[i] = f2bf(v);
  else reinterpret_cast<unsigned short*>(out)[i] = f2h(v);
}

__global__ void __launch_bounds__(kThreads) decode_kernel(const uint8_t* __restrict__ wire,
                                                          void* __restrict__ out,
                                                          const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  if (gid >= p.rows * p.groups) return;
  const long long row = gid / p.groups, g = gid % p.groups;
  const uint8_t* w = wire + row * p.wb;
  const GroupMeta m = read_meta(w, g, p);
  for (int pos = lane; pos < p.group; pos += 32)
    store_out(out, row * p.n + g * p.group + pos, decode_value(w, g, pos, m, p), p.out_kind);
}

// Dequantize rows 0..R-1 of one chunk and sum them in that order (from
// +0.0, as a reduction with initial value 0 does) into one f32 row.
__global__ void __launch_bounds__(kThreads) decode_reduce_kernel(const uint8_t* __restrict__ wire,
                                                                 float* __restrict__ out,
                                                                 const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= p.groups) return;
  float acc[kMaxGroup / 32];
#pragma unroll
  for (int k = 0; k < kMaxGroup / 32; ++k) acc[k] = 0.f;
  for (long long r = 0; r < p.rows; ++r) {
    const uint8_t* w = wire + r * p.wb;
    const GroupMeta m = read_meta(w, g, p);
#pragma unroll
    for (int k = 0; k < kMaxGroup / 32; ++k) {
      const int pos = k * 32 + lane;
      if (pos < p.group) acc[k] = __fadd_rn(acc[k], decode_value(w, g, pos, m, p));
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxGroup / 32; ++k) {
    const int pos = k * 32 + lane;
    if (pos < p.group) out[g * p.group + pos] = acc[k];
  }
}

// params: int64 array in the order of fill_params below; fthr: theta
// thresholds (uint32), ffrac: 2^(r/theta) table, feps: {eps, mag_min}.
Params fill_params(const long long* a, const unsigned* thr, const float* frac,
                   const float* eps) {
  Params p;
  p.rows = a[0]; p.n = a[1]; p.wb = a[2]; p.group = (int)a[3]; p.bits = (int)a[4];
  p.groups = p.n / p.group;
  p.n_planes = (int)a[5];
  for (int i = 0; i < 3; ++i) { p.unit[i] = (int)a[6 + i]; p.plane_off[i] = a[9 + i]; }
  p.scale_off = a[12]; p.zero_off = a[13]; p.sv_off = a[14]; p.si_off = a[15];
  p.spike = (int)a[16]; p.scale_int = (int)a[17]; p.theta = (int)a[18];
  p.meta_f16 = (int)a[19]; p.out_kind = (int)a[20];
  p.n_thr = p.theta - 1;
  for (int k = 0; k < kMaxTheta; ++k) {
    p.thr[k] = k < p.n_thr ? thr[k] : 0xffffffffu;
    p.frac[k] = k < p.theta ? frac[k] : 0.f;
  }
  p.eps = eps[0];
  p.mag_min = eps[1];
  return p;
}

unsigned blocks_for(long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); }

}  // namespace

extern "C" {

int fc_encode_wire(const void* x, void* wire, const long long* params, const unsigned* thr,
                   const float* frac, const float* eps, void* stream) {
  const Params p = fill_params(params, thr, frac, eps);
  const long long warps = p.rows * p.groups;
  if (warps == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  uint8_t* w = (uint8_t*)wire;
  switch (p.group) {
    case 32: encode_kernel<1><<<blocks_for(warps), kThreads, 0, st>>>(xf, w, p); break;
    case 64: encode_kernel<2><<<blocks_for(warps), kThreads, 0, st>>>(xf, w, p); break;
    case 128: encode_kernel<4><<<blocks_for(warps), kThreads, 0, st>>>(xf, w, p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fc_decode_wire(const void* wire, void* out, const long long* params, const unsigned* thr,
                   const float* frac, const float* eps, void* stream) {
  const Params p = fill_params(params, thr, frac, eps);
  const long long warps = p.rows * p.groups;
  if (warps == 0) return 0;
  decode_kernel<<<blocks_for(warps), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, out, p);
  return (int)cudaGetLastError();
}

int fc_decode_reduce(const void* wire, void* out, const long long* params, const unsigned* thr,
                     const float* frac, const float* eps, void* stream) {
  const Params p = fill_params(params, thr, frac, eps);
  if (p.groups == 0) return 0;
  decode_reduce_kernel<<<blocks_for(p.groups), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (float*)out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
