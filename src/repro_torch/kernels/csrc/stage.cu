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
// payload and the meta, each once (stage.py bound_bytes).
//
// Design. The packs are fc_encode_wire's encode with the stage layout.
// Block (c, y, z) of 512 threads quantizes chunk c, 4096 consecutive
// values, of row z * 65535 + y (128 threads over 1024 where a call has
// fewer 4096-value chunks than the card has SMs), eight values a thread,
// loaded as two 16-byte vectors (f32) or one (bf16) and quantized by
// codec.cuh quantize8, the one quantizer of every kernel:
// min and max as one pass over the values, the spike election by ballots
// over the group's G / 8 lanes, one reciprocal a group in place of a
// division a value. Eight codes fill exactly u whole bytes of the unit-u
// plane, so a thread stores one aligned word a plane, packed with the
// unit known at compile time (store_planes<BITS>, pack_unit<U>: four
// codes a multiply or a byte permute), and no two threads share a byte.
// The group's first lanes store its meta, one section each: scale, zero,
// the spike values as one (min, max) bf16 pair, the spike slots as one
// int8 pair. The input type and the mode are template arguments. A row
// whose n is no multiple of the chunk ends in a partial chunk whose idle
// threads compute on zeros and store nothing (group divides n).
// Unpack: one block of 512 threads a chunk of 4096 values, thread t
// values 8t .. 8t+7: u bytes of each plane in one load, two roundings a
// value, 16-byte stores.

#include "codec.cuh"

namespace {

using namespace fc;

constexpr int kChunk = kBlockThreads * kPer;   // values an unpack block
constexpr float kEps = 1e-12f;            // repro_torch.core.quant.EPS
constexpr long long kMaxGridY = 65535;

// BIT_UNITS of repro_torch/core/comm_config.py: unit i of a width's
// planes, 0 past its last.
__host__ __device__ constexpr int plane_unit(int bits, int i) {
  constexpr int units[9][3] = {{0, 0, 0}, {1, 0, 0}, {2, 0, 0}, {2, 1, 0}, {4, 0, 0},
                               {4, 1, 0}, {4, 2, 0}, {4, 2, 1}, {8, 0, 0}};
  return units[bits][i];
}

struct Stage {
  long long rows, n, nbytes, chunks;      // nbytes: payload bytes a row
  int bits, n_planes;
  int unit[3];
  long long plane_off[3];
  int out_kind;                           // 0 f32 1 bf16 2 f16
};

Stage make_stage(long long rows, long long n, int bits) {
  Stage s;
  s.rows = rows;
  s.n = n;
  s.bits = bits;
  s.chunks = (n + kChunk - 1) / kChunk;
  s.n_planes = 0;
  long long off = 0;
  for (int i = 0; i < 3; ++i) {
    s.unit[i] = plane_unit(bits, i);
    s.plane_off[i] = off;
    if (s.unit[i]) {
      s.n_planes = i + 1;
      off += n * s.unit[i] / 8;
    }
  }
  s.nbytes = off;
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

// codec.cuh pack8 for a unit U known at compile time: four codes' fields
// gathered at once, by one multiply whose partial products land in
// disjoint bits (U = 1, 2), or by one shift and a byte permute (U = 4).
template <int U>
__device__ __forceinline__ unsigned long long pack_unit(unsigned long long codes, int shift) {
  if constexpr (U == 8) {
    return codes;
  } else {
    constexpr unsigned mask = ((1u << U) - 1u) * 0x01010101u;   // U bits of each byte
    unsigned lo = ((unsigned)codes >> shift) & mask, hi = ((unsigned)(codes >> 32) >> shift) & mask;
    if constexpr (U == 4) {
      lo |= lo >> 4;
      hi |= hi >> 4;
      return __byte_perm(lo, hi, 0x6420);
    } else {
      // field i (at bit 8i) times 2^((8 - U)(3 - i)) lands at bit (8 - U) * 3 + U * i
      constexpr unsigned mul = U == 2 ? 0x41041u : 0x204081u;
      constexpr int at = (8 - U) * 3, w = 4 * U;
      return (((lo * mul) >> at) & ((1u << w) - 1u)) |
             ((((hi * mul) >> at) & ((1u << w) - 1u)) << w);
    }
  }
}

// A thread's codes (byte k value k's) into each plane of a BITS-bit row
// of n values at prow: one store of u bytes a plane, at e0 / 8 * u.
template <int BITS>
__device__ __forceinline__ void store_planes(uint8_t* prow, long long n, long long e0,
                                             unsigned long long codes) {
  constexpr int u0 = plane_unit(BITS, 0), u1 = plane_unit(BITS, 1), u2 = plane_unit(BITS, 2);
  store_bytes(prow + e0 / 8 * u0, pack_unit<u0>(codes, 0), u0);
  if constexpr (u1 != 0) store_bytes(prow + n * u0 / 8 + e0 / 8 * u1, pack_unit<u1>(codes, u0), u1);
  if constexpr (u2 != 0)
    store_bytes(prow + n * (u0 + u1) / 8 + e0 / 8 * u2, pack_unit<u2>(codes, u0 + u1), u2);
}

// Quantize + pack (SPIKE: with spike reserving): block (c, y, z) packs
// chunk c, blockDim.x * 8 values, of row z * gridDim.y + y; x is float or
// bf16. p.wb is a row's payload bytes.
template <int G, bool SPIKE, typename T>
__global__ void __launch_bounds__(kBlockThreads) pack_kernel(const T* __restrict__ x,
                                                             uint8_t* __restrict__ payload,
                                                             unsigned short* __restrict__ scale,
                                                             unsigned short* __restrict__ zero,
                                                             unsigned* __restrict__ spike_vals,
                                                             unsigned short* __restrict__ spike_idx,
                                                             const WireParams p) {
  const long long row = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= p.rows) return;                                // the last z's spare rows
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kPer;
  const bool active = e0 < p.n;
  const int lt = threadIdx.x % (G / kPer);
  float v[kPer];
  load8(x + row * p.n + e0, active, v);
  const Code8 c = quantize8<G, SPIKE, false>(v, lt, p);
  if (!active) return;
  uint8_t* prow = payload + row * p.wb;
  switch (p.bits) {
    case 1: store_planes<1>(prow, p.n, e0, c.codes); break;
    case 2: store_planes<2>(prow, p.n, e0, c.codes); break;
    case 3: store_planes<3>(prow, p.n, e0, c.codes); break;
    case 4: store_planes<4>(prow, p.n, e0, c.codes); break;
    case 5: store_planes<5>(prow, p.n, e0, c.codes); break;
    case 6: store_planes<6>(prow, p.n, e0, c.codes); break;
    case 7: store_planes<7>(prow, p.n, e0, c.codes); break;
    default: store_planes<8>(prow, p.n, e0, c.codes);
  }
  const long long g = row * p.groups + e0 / G;
  if (lt == 0) {
    scale[g] = c.m.sbits;
  } else if (lt == 1) {
    zero[g] = c.m.zbits;
  } else if (SPIKE && lt == 2) {
    spike_vals[g] = f2bf(c.r.vmin) | ((unsigned)f2bf(c.r.vmax) << 16);
  } else if (SPIKE && lt == 3) {
    spike_idx[g] = (unsigned short)((uint8_t)c.r.imin | ((unsigned)(uint8_t)c.r.imax << 8));
  }
}

// Unpack + dequantize one chunk: codes * scale + zero, two roundings.
template <int G>
__global__ void __launch_bounds__(kBlockThreads) unpack_kernel(const uint8_t* __restrict__ payload,
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
  WireParams p{};
  p.rows = rows;
  p.n = n;
  p.groups = n / group;
  p.bits = bits;
  p.wb = make_stage(rows, n, bits).nbytes;
  p.eps = kEps;
  if (rows * n == 0) return 0;
  if (const int rc = use_device_of(x)) return rc;
  const long long big = (long long)kBlockThreads * kPer;
  const int threads = block_threads(rows * ((n + big - 1) / big) * kBlockThreads);
  const long long ys = rows < kMaxGridY ? rows : kMaxGridY;
  const dim3 grid((unsigned)((n + threads * kPer - 1) / (threads * kPer)), (unsigned)ys,
                  (unsigned)((rows + ys - 1) / ys));
  const cudaStream_t st = (cudaStream_t)stream;
  uint8_t* a1 = (uint8_t*)payload;
  unsigned short *a2 = (unsigned short*)scale, *a3 = (unsigned short*)zero,
                 *a5 = (unsigned short*)si;
  unsigned* a4 = (unsigned*)sv;
#define FC_PACK(G, T) \
  pack_kernel<G, SPIKE, T><<<grid, threads, 0, st>>>((const T*)x, a1, a2, a3, a4, a5, p)
#define FC_PACK_IN(G)                                  \
  if (in_bf16) FC_PACK(G, __nv_bfloat16);              \
  else FC_PACK(G, float)
  switch (group) {
    case 32: FC_PACK_IN(32); break;
    case 64: FC_PACK_IN(64); break;
    case 128: FC_PACK_IN(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FC_PACK_IN
#undef FC_PACK
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
    case 32: unpack_kernel<32><<<blocks_for(s), kBlockThreads, 0, st>>>(a0, a1, a2, out, s); break;
    case 64: unpack_kernel<64><<<blocks_for(s), kBlockThreads, 0, st>>>(a0, a1, a2, out, s); break;
    case 128: unpack_kernel<128><<<blocks_for(s), kBlockThreads, 0, st>>>(a0, a1, a2, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
