// Per-stage codec kernels for Hopper (sm_90a): quantize + pack, unpack +
// dequantize, spike reserving + pack.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant_pack.py      quant_pack (_quant_pack_kernel) -> fc_quant_pack
//   src/repro/kernels/dequant_unpack.py  dequant_unpack (_dequant_kernel) -> fc_dequant_unpack
//   src/repro/kernels/spike_reserve.py   spike_pack (_spike_kernel)       -> fc_spike_pack
//
// Outputs, per row of n values with G = n / group groups (meta is bf16):
//   payload  (R, sum_u n * u / 8) u8: the bit-split planes of the codes,
//            plane u at sum_{u' before u} n * u' / 8 (BIT_UNITS order)
//   scale, zero  (R, G) bf16
//   spike_vals (R, G, 2) bf16 [min, max], spike_idx (R, G, 2) int8
//
// Bound on an H100: all three are memory-bound. The least time is
// (bytes read + bytes written) / 3.35 TB/s: the input values, the
// payload and the meta, each once.
//
// Design: the paper's own CUDA shape. One block of 512 threads owns a
// chunk of 4096 consecutive values of one row; thread t owns values
// 8t .. 8t+7 of the chunk, which fill exactly u whole bytes of the
// unit-u plane, so no two threads share a byte and each writes its bytes
// with one aligned store. A group of 32, 64 or 128 values lies on
// 4, 8 or 16 neighbouring lanes, whose min/max and spike election are
// shuffles over those lanes only (codec.cuh). A row whose n is not a
// multiple of 4096 ends in a partial chunk: its idle threads compute on
// zeros and store nothing (groups never straddle the end, since group
// divides n). Loads and stores of the values are 16-byte vectors.

#include "codec.cuh"

namespace {

using namespace fc;

constexpr int kThreads = 512;
constexpr int kPer = 8;                   // values a thread
constexpr int kChunk = kThreads * kPer;   // values a block
constexpr float kEps = 1e-12f;            // repro_torch.core.quant.EPS

struct Stage {
  long long rows, n, nbytes, chunks;      // nbytes: payload bytes a row
  int bits, n_planes;
  int unit[3];
  long long plane_off[3];
  int in_bf16, out_kind;                  // out: 0 f32 1 bf16 2 f16
};

// BIT_UNITS of repro_torch/core/comm_config.py: the planes of each width.
Stage make_stage(long long rows, long long n, int bits) {
  static const int units[9][3] = {{0, 0, 0}, {1, 0, 0}, {2, 0, 0}, {2, 1, 0}, {4, 0, 0},
                                  {4, 1, 0}, {4, 2, 0}, {4, 2, 1}, {8, 0, 0}};
  Stage s;
  s.rows = rows;
  s.n = n;
  s.bits = bits;
  s.chunks = (n + kChunk - 1) / kChunk;
  s.n_planes = 0;
  long long off = 0;
  for (int i = 0; i < 3; ++i) {
    s.unit[i] = units[bits][i];
    s.plane_off[i] = off;
    if (s.unit[i]) {
      s.n_planes = i + 1;
      off += n * s.unit[i] / 8;
    }
  }
  s.nbytes = off;
  s.in_bf16 = 0;
  s.out_kind = 0;
  return s;
}

// u bytes at dst, which is u-byte aligned (see the wrappers' checks).
__device__ __forceinline__ void store_bytes(uint8_t* dst, unsigned long long word, int u) {
  switch (u) {
    case 8: *reinterpret_cast<unsigned long long*>(dst) = word; break;
    case 4: *reinterpret_cast<unsigned*>(dst) = (unsigned)word; break;
    case 2: *reinterpret_cast<unsigned short*>(dst) = (unsigned short)word; break;
    default: *dst = (uint8_t)word;
  }
}

__device__ __forceinline__ unsigned long long load_bytes(const uint8_t* src, int u) {
  switch (u) {
    case 8: return *reinterpret_cast<const unsigned long long*>(src);
    case 4: return *reinterpret_cast<const unsigned*>(src);
    case 2: return *reinterpret_cast<const unsigned short*>(src);
    default: return *src;
  }
}

__device__ __forceinline__ float bf2f(unsigned short b) { return __uint_as_float((unsigned)b << 16); }

// Quantize + pack (SPIKE: with spike reserving) of one chunk. G: group.
template <int G, bool SPIKE>
__global__ void __launch_bounds__(kThreads) pack_kernel(const void* __restrict__ x,
                                                        uint8_t* __restrict__ payload,
                                                        unsigned short* __restrict__ scale,
                                                        unsigned short* __restrict__ zero,
                                                        unsigned short* __restrict__ spike_vals,
                                                        int8_t* __restrict__ spike_idx,
                                                        const Stage s) {
  constexpr int W = G / kPer;                     // lanes a group
  const long long row = blockIdx.x / s.chunks, chunk = blockIdx.x % s.chunks;
  const long long e0 = chunk * kChunk + (long long)threadIdx.x * kPer;   // in the row
  const bool active = e0 < s.n;
  const int lt = threadIdx.x % W;
  const float qmax = (float)((1 << s.bits) - 1);

  float v[kPer];
  int pos[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    pos[k] = lt * kPer + k;
    v[k] = 0.f;
  }
  if (active) {
    const long long i0 = row * s.n + e0;
    if (s.in_bf16) {
      const uint4 q = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned short*>(x) + i0);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = bf2f((unsigned short)(w[k] & 0xffffu));
        v[2 * k + 1] = bf2f((unsigned short)(w[k] >> 16));
      }
    } else {
      const float4* xf = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + i0);
      const float4 a = xf[0], b = xf[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  }

  const Range r = group_range<kPer, W>(v, pos, G, SPIKE);
  const Meta m = rtn_meta(r.mn, r.mx, qmax, kEps, 0);
  const unsigned char code_mn = quant_code(r.mn, m.z, m.s, qmax);
  unsigned long long codes8 = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    unsigned char c = quant_code(v[k], m.z, m.s, qmax);
    if (SPIKE && (pos[k] == r.imin || pos[k] == r.imax)) c = code_mn;
    codes8 |= (unsigned long long)c << (8 * k);
  }
  if (!active) return;

  uint8_t* prow = payload + row * s.nbytes;
  int shift = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {             // unrolled: s stays in registers
    if (i == s.n_planes) break;
    const int u = s.unit[i];
    store_bytes(prow + s.plane_off[i] + e0 * u / 8, pack8(codes8, u, shift), u);
    shift += u;
  }
  if (lt == 0) {
    const long long gi = row * (s.n / G) + e0 / G;
    scale[gi] = m.sbits;
    zero[gi] = m.zbits;
    if (SPIKE) {
      spike_vals[2 * gi] = to_meta(r.vmin, 0);
      spike_vals[2 * gi + 1] = to_meta(r.vmax, 0);
      spike_idx[2 * gi] = (int8_t)r.imin;
      spike_idx[2 * gi + 1] = (int8_t)r.imax;
    }
  }
}

// Unpack + dequantize one chunk: codes * scale + zero, two roundings.
template <int G>
__global__ void __launch_bounds__(kThreads) unpack_kernel(const uint8_t* __restrict__ payload,
                                                          const unsigned short* __restrict__ scale,
                                                          const unsigned short* __restrict__ zero,
                                                          void* __restrict__ out, const Stage s) {
  const long long row = blockIdx.x / s.chunks, chunk = blockIdx.x % s.chunks;
  const long long e0 = chunk * kChunk + (long long)threadIdx.x * kPer;
  if (e0 >= s.n) return;
  const long long gi = row * (s.n / G) + e0 / G;
  const float sc = bf2f(scale[gi]), z = bf2f(zero[gi]);

  unsigned code[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) code[k] = 0;
  const uint8_t* prow = payload + row * s.nbytes;
  int shift = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == s.n_planes) break;
    const int u = s.unit[i];
    const unsigned long long word = load_bytes(prow + s.plane_off[i] + e0 * u / 8, u);
    const unsigned long long mask = (1ull << u) - 1ull;
#pragma unroll
    for (int k = 0; k < kPer; ++k) code[k] |= (unsigned)((word >> (k * u)) & mask) << shift;
    shift += u;
  }
  float val[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) val[k] = dequant(code[k] & 0xffu, sc, z);

  const long long i0 = row * s.n + e0;
  if (s.out_kind == 0) {
    float4* o = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i0);
    o[0] = make_float4(val[0], val[1], val[2], val[3]);
    o[1] = make_float4(val[4], val[5], val[6], val[7]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = s.out_kind == 1 ? f2bf(val[2 * k]) : f2h(val[2 * k]);
      const unsigned hi = s.out_kind == 1 ? f2bf(val[2 * k + 1]) : f2h(val[2 * k + 1]);
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned short*>(out) + i0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

unsigned blocks_for(const Stage& s) { return (unsigned)(s.rows * s.chunks); }

template <bool SPIKE>
int launch_pack(const void* x, void* payload, void* scale, void* zero, void* sv, void* si,
                long long rows, long long n, int bits, int group, int in_bf16, void* stream) {
  if (bits < 1 || bits > 8) return (int)cudaErrorInvalidValue;
  Stage s = make_stage(rows, n, bits);
  s.in_bf16 = in_bf16;
  if (s.rows * s.chunks == 0) return 0;
  if (const int rc = use_device_of(x)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const void* a0 = x;
  uint8_t* a1 = (uint8_t*)payload;
  unsigned short *a2 = (unsigned short*)scale, *a3 = (unsigned short*)zero,
                 *a4 = (unsigned short*)sv;
  int8_t* a5 = (int8_t*)si;
  switch (group) {
    case 32: pack_kernel<32, SPIKE><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, a3, a4, a5, s); break;
    case 64: pack_kernel<64, SPIKE><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, a3, a4, a5, s); break;
    case 128: pack_kernel<128, SPIKE><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, a3, a4, a5, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fc_quant_pack(const void* x, void* payload, void* scale, void* zero, long long rows,
                  long long n, int bits, int group, int in_bf16, void* stream) {
  return launch_pack<false>(x, payload, scale, zero, nullptr, nullptr, rows, n, bits, group,
                            in_bf16, stream);
}

int fc_spike_pack(const void* x, void* payload, void* scale, void* zero, void* spike_vals,
                  void* spike_idx, long long rows, long long n, int bits, int group, int in_bf16,
                  void* stream) {
  return launch_pack<true>(x, payload, scale, zero, spike_vals, spike_idx, rows, n, bits, group,
                           in_bf16, stream);
}

int fc_dequant_unpack(const void* payload, const void* scale, const void* zero, void* out,
                      long long rows, long long n, int bits, int group, int out_kind,
                      void* stream) {
  if (bits < 1 || bits > 8 || out_kind < 0 || out_kind > 2) return (int)cudaErrorInvalidValue;
  Stage s = make_stage(rows, n, bits);
  s.out_kind = out_kind;
  if (s.rows * s.chunks == 0) return 0;
  if (const int rc = use_device_of(payload)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* a0 = (const uint8_t*)payload;
  const unsigned short *a1 = (const unsigned short*)scale, *a2 = (const unsigned short*)zero;
  switch (group) {
    case 32: unpack_kernel<32><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, out, s); break;
    case 64: unpack_kernel<64><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, out, s); break;
    case 128: unpack_kernel<128><<<blocks_for(s), kThreads, 0, st>>>(a0, a1, a2, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
