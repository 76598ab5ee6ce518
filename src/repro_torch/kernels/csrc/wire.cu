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
// values, so the kernels parallelise over quantization groups, not rows.
// A group fills whole bytes of every plane, so no two groups share a
// byte:
//   plane bytes  plane_off + g * group * unit / 8
//   scale, zero  scale_off + g * meta_bytes, zero_off + g * meta_bytes
//   spikes       sv_off + 4 g,  si_off + 2 g * idx_bytes
// Encode (fc_encode_wire): the paper's block of 512 threads over a chunk
// of 4096 consecutive values of a row (128 threads over 1024 where a call
// has fewer chunks than the card has SMs, as at the decode step's
// (1, 20480): 20 blocks in place of 5), eight values a thread (codec.cuh
// quantize8 / bytes8 / put8, shared with fc_ar): two 16-byte loads, min/max and
// the spike election as shuffles over the group's G / 8 lanes, one
// aligned store of u bytes a plane (8 codes fill u whole bytes), and the
// meta sections written by the group's first four lanes, one each. A row
// whose n is no multiple of 4096 ends in a partial chunk whose idle
// threads compute on zeros and store nothing (group divides n). Its mode
// (spike, rotation) is a template argument, so the plain RTN path carries
// no spike or rotation registers.
// Decode and decode+reduce: one warp a group of 32, 64 or 128 values (1,
// 2 or 4 per lane, lane-strided so that loads and stores coalesce),
// group min/max and the spike election as warp shuffles (codec.cuh
// decode_group).
//
// Rotation (CommConfig.rotation): each group is rotated before it is
// quantized, x -> (x * s) @ H / sqrt(g), and rotated back after it is
// dequantized, as repro_torch/core/rotation.py does, in its fixed order:
// output j is a sum over i in increasing order from +0.0 of products
// rounded before the add. Value i is broadcast by __shfl_sync (over the
// warp in the decodes, over the group's lanes in the encode);
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

// ---- encode ---------------------------------------------------------------

constexpr int kEncThreads = 512;          // the paper's block: 4096 values
constexpr int kEncSmall = 128;            // a call of fewer such chunks than SMs

// A block of blockDim.x threads (kEncThreads or kEncSmall) encodes
// blockDim.x * 8 consecutive values of a row.
template <int G, bool SPIKE, bool ROT>
__global__ void __launch_bounds__(kEncThreads) encode_kernel(const float* __restrict__ x,
                                                             uint8_t* __restrict__ wire,
                                                             const WireParams p) {
  const long long chunk = (long long)blockDim.x * kPer;
  const long long chunks = (p.n + chunk - 1) / chunk;
  const long long row = blockIdx.x / chunks;
  const long long e0 = (blockIdx.x % chunks) * chunk + (long long)threadIdx.x * kPer;
  const bool active = e0 < p.n;
  const int lt = threadIdx.x % (G / kPer);
  float v[kPer];
  load8(x + row * p.n + e0, active, v);
  const Code8 c = quantize8<G, SPIKE, ROT>(v, lt, p);
  if (active) put8(wire + row * p.wb, bytes8<G, SPIKE>(c, e0, lt, p), p);
}

// ---- decode ---------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(kThreads) decode_kernel(const uint8_t* __restrict__ wire,
                                                          void* __restrict__ out,
                                                          const WireParams p) {
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
                                                                 const WireParams p) {
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

unsigned blocks_for(long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); }

// SMs of the current card (cached a card).
int sm_count() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

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
  const WireParams p = fill_params(params, thr, frac, f);
  if (p.rows * p.n == 0) return 0;
  if (const int rc = use_device_of(x)) return rc;
  // the paper's block, or a quarter of it where that leaves SMs idle
  const long long chunk = (long long)kEncThreads * kPer;
  const int threads = p.rows * ((p.n + chunk - 1) / chunk) < sm_count() ? kEncSmall : kEncThreads;
  const long long blocks = p.rows * ((p.n + threads * kPer - 1) / (threads * kPer));
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xs = (const float*)x;
  uint8_t* w = (uint8_t*)wire;
#define FC_ENCODE(G, S, R) encode_kernel<G, S, R><<<(unsigned)blocks, threads, 0, st>>>(xs, w, p)
  FC_BY_MODE(p, FC_ENCODE, return (int)cudaErrorInvalidValue)
#undef FC_ENCODE
  return (int)cudaGetLastError();
}

int fc_decode_wire(const void* wire, void* out, const long long* params, const unsigned* thr,
                   const float* frac, const float* f, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  const long long warps = p.rows * p.groups;
  if (warps == 0) return 0;
  if (const int rc = use_device_of(wire)) return rc;
  FC_LAUNCH_BY_GROUP(decode_kernel, blocks_for(warps), (cudaStream_t)stream,
                     (const uint8_t*)wire, out, p);
  return (int)cudaGetLastError();
}

int fc_decode_reduce(const void* wire, void* out, const long long* params, const unsigned* thr,
                     const float* frac, const float* f, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  if (p.groups == 0) return 0;
  if (const int rc = use_device_of(wire)) return rc;
  FC_LAUNCH_BY_GROUP(decode_reduce_kernel, blocks_for(p.groups), (cudaStream_t)stream,
                     (const uint8_t*)wire, (float*)out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
