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
// Group min/max and the spike election are warp shuffles (codec.cuh);
// the codes go through shared memory, one byte a value, and lane l packs
// codes 8l .. 8l+7 into u whole bytes of each unit-u plane.
//
// Rotation (CommConfig.rotation): each group is rotated before it is
// quantized, x -> (x * s) @ H / sqrt(g), and rotated back after it is
// dequantized, as repro_torch/core/rotation.py does, in its fixed order:
// output j is a sum over i in increasing order from +0.0 of products
// rounded before the add. The warp broadcasts value i by __shfl_sync;
// H[i][j] = +-1/sqrt(g) by the parity of popcount(i & j), and the signs s
// come from the lowbias32 hash of the position. That is 2g flops a value
// (64 at g = 32): at the card's 67 TFLOP/s of f32 about as long as moving
// the value's bytes, so a rotating kernel sits near both bounds.
//
// Numerics: see codec.cuh.

#include "codec.cuh"

namespace {

using namespace fc;

constexpr int kWarps = 8;                 // warps (groups) per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTheta = 20;

struct Params {
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
  unsigned thr[kMaxTheta];
  float frac[kMaxTheta];
  float eps, mag_min;
};

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

__device__ __forceinline__ unsigned short rd16(const uint8_t* w, long long off) {
  return (unsigned short)(w[off] | (w[off + 1] << 8));
}

__device__ __forceinline__ void wr16(uint8_t* w, long long off, unsigned short v) {
  w[off] = (uint8_t)(v & 0xff);
  w[off + 1] = (uint8_t)(v >> 8);
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

// In place: lane value k is position k * 32 + lane of the warp's group.
// out_j = sum_i x_i * H[i][j], i increasing, from +0.0; H is symmetric,
// so the same sum is the rotation and its transpose.
template <int VPL>
__device__ __forceinline__ void hadamard_warp(float (&v)[VPL], int lane, float h) {
  float acc[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) acc[k] = 0.f;
#pragma unroll
  for (int kk = 0; kk < VPL; ++kk) {
    for (int l = 0; l < 32; ++l) {
      const float xi = __shfl_sync(kFull, v[kk], l);
      const int i = kk * 32 + l;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const float hij = (__popc(i & (k * 32 + lane)) & 1) ? -h : h;
        acc[k] = __fadd_rn(acc[k], __fmul_rn(xi, hij));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = acc[k];
}

template <int VPL>
__device__ __forceinline__ void rotate_warp(float (&v)[VPL], int lane, const Params& p) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = __fmul_rn(v[k], rot_sign(k * 32 + lane, p.sign_seed));
  hadamard_warp<VPL>(v, lane, p.hscale);
}

template <int VPL>
__device__ __forceinline__ void unrotate_warp(float (&v)[VPL], int lane, const Params& p) {
  hadamard_warp<VPL>(v, lane, p.hscale);
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = __fmul_rn(v[k], rot_sign(k * 32 + lane, p.sign_seed));
}

// ---- encode ---------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(kThreads) encode_kernel(const float* __restrict__ x,
                                                          uint8_t* __restrict__ wire,
                                                          const Params p) {
  __shared__ __align__(8) uint8_t codes_s[kWarps][VPL * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  if (gid >= p.rows * p.groups) return;           // uniform per warp
  const long long row = gid / p.groups, g = gid % p.groups;
  const int G = VPL * 32;
  const float* xg = x + row * p.n + g * G;
  uint8_t* w = wire + row * p.wb;
  const float qmax = (float)((1 << p.bits) - 1);

  float v[VPL];
  int pos[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    pos[k] = k * 32 + lane;
    v[k] = xg[pos[k]];
  }
  if (p.rotation) rotate_warp<VPL>(v, lane, p);
  const Range r = group_range<VPL, 32>(v, pos, G, p.spike);
  const Meta m = rtn_meta(r.mn, r.mx, qmax, p.eps, p.meta_f16);
  const unsigned char code_mn = quant_code(r.mn, m.z, m.s, qmax);

#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    unsigned char c = quant_code(v[k], m.z, m.s, qmax);
    if (p.spike && (pos[k] == r.imin || pos[k] == r.imax)) c = code_mn;
    codes_s[warp][pos[k]] = c;
  }
  __syncwarp();

  // lane l < G / 8 packs codes 8l .. 8l+7 into u bytes of each plane
  if (lane < G / 8) {
    const unsigned long long codes8 =
        *reinterpret_cast<const unsigned long long*>(&codes_s[warp][8 * lane]);
    int shift = 0;
    for (int i = 0; i < p.n_planes; ++i) {
      const int u = p.unit[i];
      const unsigned long long word = pack8(codes8, u, shift);
      uint8_t* dst = w + p.plane_off[i] + (g * G + 8 * lane) * u / 8;
      for (int b = 0; b < u; ++b) dst[b] = (uint8_t)(word >> (8 * b));
      shift += u;
    }
  }

  if (lane == 0) {
    if (p.scale_int) {
      w[p.scale_off + g] = encode_scale(m.s, p);
      w[p.zero_off + g] = encode_signed(m.z, p);
    } else {
      wr16(w, p.scale_off + 2 * g, m.sbits);
      wr16(w, p.zero_off + 2 * g, m.zbits);
    }
    if (p.spike) {
      wr16(w, p.sv_off + 4 * g, to_meta(r.vmin, p.meta_f16));
      wr16(w, p.sv_off + 4 * g + 2, to_meta(r.vmax, p.meta_f16));
      if (p.scale_int) {
        w[p.si_off + 2 * g] = (uint8_t)r.imin;
        w[p.si_off + 2 * g + 1] = (uint8_t)r.imax;
      } else {
        wr16(w, p.si_off + 4 * g, to_meta((float)r.imin, p.meta_f16));
        wr16(w, p.si_off + 4 * g + 2, to_meta((float)r.imax, p.meta_f16));
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
    code |= plane_field(w + p.plane_off[i], e, p.unit[i], shift);
    shift += p.unit[i];
  }
  float val = dequant(code & 0xffu, m.s, m.z);
  if (p.spike) {
    if (pos == m.si1) val = m.sv1;
    else if (pos == m.si0) val = m.sv0;
  }
  return val;
}

// The warp's group of one row, decoded (and rotated back) into v.
template <int VPL>
__device__ __forceinline__ void decode_group(const uint8_t* w, long long g, int lane,
                                             const Params& p, float (&v)[VPL]) {
  const GroupMeta m = read_meta(w, g, p);
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = decode_value(w, g, k * 32 + lane, m, p);
  if (p.rotation) unrotate_warp<VPL>(v, lane, p);
}

template <int VPL>
__global__ void __launch_bounds__(kThreads) decode_kernel(const uint8_t* __restrict__ wire,
                                                          void* __restrict__ out,
                                                          const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  if (gid >= p.rows * p.groups) return;
  const long long row = gid / p.groups, g = gid % p.groups;
  float v[VPL];
  decode_group<VPL>(wire + row * p.wb, g, lane, p, v);
#pragma unroll
  for (int k = 0; k < VPL; ++k)
    store_out(out, row * p.n + g * p.group + k * 32 + lane, v[k], p.out_kind);
}

// Dequantize rows 0..R-1 of one chunk and sum them in that order (from
// +0.0, as a reduction with initial value 0 does) into one f32 row.
template <int VPL>
__global__ void __launch_bounds__(kThreads) decode_reduce_kernel(const uint8_t* __restrict__ wire,
                                                                 float* __restrict__ out,
                                                                 const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= p.groups) return;
  float acc[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) acc[k] = 0.f;
  for (long long r = 0; r < p.rows; ++r) {
    float v[VPL];
    decode_group<VPL>(wire + r * p.wb, g, lane, p, v);
#pragma unroll
    for (int k = 0; k < VPL; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) out[g * p.group + k * 32 + lane] = acc[k];
}

// params: int64 array in the order of fill_params below; thr: theta
// thresholds (uint32), frac: 2^(r/theta) table, f: {eps, mag_min,
// hscale}; the sign seed is params[22].
Params fill_params(const long long* a, const unsigned* thr, const float* frac,
                   const float* f) {
  Params p;
  p.rows = a[0]; p.n = a[1]; p.wb = a[2]; p.group = (int)a[3]; p.bits = (int)a[4];
  p.groups = p.n / p.group;
  p.n_planes = (int)a[5];
  for (int i = 0; i < 3; ++i) { p.unit[i] = (int)a[6 + i]; p.plane_off[i] = a[9 + i]; }
  p.scale_off = a[12]; p.zero_off = a[13]; p.sv_off = a[14]; p.si_off = a[15];
  p.spike = (int)a[16]; p.scale_int = (int)a[17]; p.theta = (int)a[18];
  p.meta_f16 = (int)a[19]; p.out_kind = (int)a[20];
  p.rotation = (int)a[21]; p.sign_seed = (unsigned)a[22];
  p.n_thr = p.theta - 1;
  for (int k = 0; k < kMaxTheta; ++k) {
    p.thr[k] = k < p.n_thr ? thr[k] : 0xffffffffu;
    p.frac[k] = k < p.theta ? frac[k] : 0.f;
  }
  p.eps = f[0];
  p.mag_min = f[1];
  p.hscale = f[2];
  return p;
}

unsigned blocks_for(long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); }

// One launch of kernel K<VPL> for the config's group (32, 64 or 128).
#define FC_LAUNCH_BY_GROUP(K, blocks, st, ...)                                 \
  switch (p.group) {                                                          \
    case 32: K<1><<<(blocks), kThreads, 0, (st)>>>(__VA_ARGS__); break;       \
    case 64: K<2><<<(blocks), kThreads, 0, (st)>>>(__VA_ARGS__); break;       \
    case 128: K<4><<<(blocks), kThreads, 0, (st)>>>(__VA_ARGS__); break;      \
    default: return (int)cudaErrorInvalidValue;                               \
  }

}  // namespace

extern "C" {

int fc_encode_wire(const void* x, void* wire, const long long* params, const unsigned* thr,
                   const float* frac, const float* f, void* stream) {
  const Params p = fill_params(params, thr, frac, f);
  const long long warps = p.rows * p.groups;
  if (warps == 0) return 0;
  FC_LAUNCH_BY_GROUP(encode_kernel, blocks_for(warps), (cudaStream_t)stream,
                     (const float*)x, (uint8_t*)wire, p);
  return (int)cudaGetLastError();
}

int fc_decode_wire(const void* wire, void* out, const long long* params, const unsigned* thr,
                   const float* frac, const float* f, void* stream) {
  const Params p = fill_params(params, thr, frac, f);
  const long long warps = p.rows * p.groups;
  if (warps == 0) return 0;
  FC_LAUNCH_BY_GROUP(decode_kernel, blocks_for(warps), (cudaStream_t)stream,
                     (const uint8_t*)wire, out, p);
  return (int)cudaGetLastError();
}

int fc_decode_reduce(const void* wire, void* out, const long long* params, const unsigned* thr,
                     const float* frac, const float* f, void* stream) {
  const Params p = fill_params(params, thr, frac, f);
  if (p.groups == 0) return 0;
  FC_LAUNCH_BY_GROUP(decode_reduce_kernel, blocks_for(p.groups), (cudaStream_t)stream,
                     (const uint8_t*)wire, (float*)out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
