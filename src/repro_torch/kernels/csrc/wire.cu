// Wire-codec kernels for Hopper (sm_90a): encode, decode, decode+reduce.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/wire.py     encode_wire (_encode_kernel)  -> fc_encode_wire
//   src/repro/kernels/wire.py     decode_wire (_decode_kernel)  -> fc_decode_wire
//   src/repro/kernels/emulate.py  encode_rows / decode_rows     -> the same two
//   src/repro/kernels/emulate.py  decode_reduce_rows            -> fc_decode_reduce
//
// Bound on an H100: all three are memory-bound. The least time is
// (bytes read + bytes written) / 3.35 TB/s: 4n + wire bytes for encode,
// R * (wire bytes + n * out itemsize) for decode, R * wire bytes + 4n for
// decode+reduce.
//
// Design. On the serving path a TP site has one row (tp = 1) of
// ~10^6..10^7 values, so the kernels parallelise over the values of a
// row, eight a thread, not over rows. A group fills whole bytes of every
// plane, so no two groups share a byte:
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
// Decode (fc_decode_wire) and decode+reduce (fc_decode_reduce): the same
// eight values a thread (codec.cuh fetch8 / finish8, shared with fc_ar)
// on one flat grid over the call's rows x n / 8 items, so that a short
// row (a dispatch row of 2048 values) leaves no thread of a block idle.
// n is a multiple of the group, so a thread's eight values never cross a
// row or a group, and a group's G / 8 lanes never cross a warp. A thread
// issues one load of u bytes a plane (bytes where the row's stride leaves
// the address unaligned), its group's first four lanes one meta section
// each, passed to the others by shuffle; it stores its eight outputs as
// one aligned vector store a 16 bytes (two at f32, one at bf16 / fp16).
// The output kind (f32, bf16, fp16) and the mode (group, spike,
// rotation) are template arguments. Decode+reduce gives each thread
// eight values of the one output row: it issues the loads of up to
// kRowsInFlight rows before it decodes any of them (one where the call
// has one row, so that a thread keeps about the decode's registers),
// then adds the rows' values in row order from +0.0. Loads are plain
// (the rows were written on the same stream): on an H100 they ran 3-9%
// faster than L2-only loads on some configs and level on the rest
// (PERF.md).
//
// Rotation (CommConfig.rotation): each group is rotated before it is
// quantized, x -> (x * s) @ H / sqrt(g), and rotated back after it is
// dequantized, as repro_torch/core/rotation.py does, in its fixed order:
// output j is a sum over i in increasing order from +0.0 of products
// rounded before the add. Value i is broadcast by __shfl_sync over the
// group's G / 8 lanes (codec.cuh hadamard8);
// H[i][j] = +-1/sqrt(g) by the parity of popcount(i & j), and the signs s
// come from the lowbias32 hash of the position. That is 2g flops a value
// (64 at g = 32): at the card's 67 TFLOP/s of f32 about as long as moving
// the value's bytes, so a rotating kernel sits near both bounds.
//
// Numerics: see codec.cuh.

#include "codec.cuh"

namespace {

using namespace fc;

// ---- encode ---------------------------------------------------------------

// A block of blockDim.x threads (kBlockThreads or kBlockThreadsSmall) encodes
// blockDim.x * 8 consecutive values of a row.
template <int G, bool SPIKE, bool ROT>
__global__ void __launch_bounds__(kBlockThreads) encode_kernel(const float* __restrict__ x,
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

constexpr int kRowsInFlight = 4;          // decode+reduce of several rows: loaded before they are summed

// Thread it of the grid decodes the eight values of item it: row
// it / (n / 8), elements e0 .. e0 + 7 of that row. The wrapper sizes the
// grid so that the item index fits in 32 bits.
template <int G, bool SPIKE, bool ROT, int OUT>
__global__ void __launch_bounds__(kBlockThreads) decode_kernel(const uint8_t* __restrict__ wire,
                                                               void* __restrict__ out,
                                                               const WireParams p) {
  const unsigned per_row = (unsigned)(p.n / kPer);
  const unsigned it = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned row = it / per_row;
  const long long e0 = (long long)(it - row * per_row) * kPer;
  const bool active = row < p.rows;
  float v[kPer];
  decode8<G, SPIKE, ROT, LoadPlain>(wire + row * p.wb, e0, threadIdx.x % (G / kPer), active, p, v);
  if (active) store8_out<OUT>(out, row * p.n + e0, v);
}

// Dequantize rows 0..R-1 of one chunk and sum them in that order (from
// +0.0, as a reduction with initial value 0 does) into one f32 row,
// loading RF rows before it decodes them. A row's raw bytes take 7
// registers: RF = kRowsInFlight holds a thread at 64, two blocks of 512
// an SM; RF = 1 is launched for a call of one row (as on every serve
// path), whose row count it then knows at compile time: 30-32
// registers, 48 rotating, where a loop over a row count it did not know
// took 96-117 (0.0 + v is still added).
template <int G, bool SPIKE, bool ROT, int RF>
__global__ void __launch_bounds__(kBlockThreads, RF == 1 ? 1 : 2)
    decode_reduce_kernel(const uint8_t* __restrict__ wire, float* __restrict__ out,
                         const WireParams p) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kPer;
  const bool active = e0 < p.n;
  const int lt = threadIdx.x % (G / kPer);
  const long long rows = RF == 1 ? 1 : p.rows;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  for (long long r0 = 0; r0 < rows; r0 += RF) {
    Raw8 raw[RF];
#pragma unroll
    for (int j = 0; j < RF; ++j)
      if (r0 + j < rows) raw[j] = fetch8<G, SPIKE, LoadPlain>(wire + (r0 + j) * p.wb, e0, lt, active, p);
#pragma unroll
    for (int j = 0; j < RF; ++j) {
      if (r0 + j < rows) {
        float v[kPer];
        finish8<G, SPIKE, ROT>(raw[j], lt, p, v);
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      }
    }
  }
  if (active) store8(out + e0, acc);
}

}  // namespace

extern "C" {

int fc_encode_wire(const void* x, void* wire, const long long* params, const unsigned* thr,
                   const float* frac, const float* f, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  if (p.rows * p.n == 0) return 0;
  if (const int rc = use_device_of(x)) return rc;
  const long long chunk = (long long)kBlockThreads * kPer;
  const int threads = block_threads(p.rows * ((p.n + chunk - 1) / chunk) * kBlockThreads);
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
  const long long items = p.rows * (p.n / kPer);
  if (items == 0) return 0;
  if (items > 0xffffffffLL - kBlockThreads) return (int)cudaErrorInvalidValue;   // 32-bit items
  if (const int rc = use_device_of(wire)) return rc;
  const int threads = block_threads(items);
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* w = (const uint8_t*)wire;
#define FC_DECODE_AS(G, S, R, O) decode_kernel<G, S, R, O><<<blocks, threads, 0, st>>>(w, out, p)
#define FC_DECODE(G, S, R)                                    \
  switch (p.out_kind) {                                       \
    case 0: FC_DECODE_AS(G, S, R, 0); break;                  \
    case 1: FC_DECODE_AS(G, S, R, 1); break;                  \
    case 2: FC_DECODE_AS(G, S, R, 2); break;                  \
    default: return (int)cudaErrorInvalidValue;               \
  }
  FC_BY_MODE(p, FC_DECODE, return (int)cudaErrorInvalidValue)
#undef FC_DECODE
#undef FC_DECODE_AS
  return (int)cudaGetLastError();
}

int fc_decode_reduce(const void* wire, void* out, const long long* params, const unsigned* thr,
                     const float* frac, const float* f, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  const long long items = p.n / kPer;
  if (items == 0) return 0;
  if (const int rc = use_device_of(wire)) return rc;
  const int threads = block_threads(items);
  const long long blocks = (items + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* w = (const uint8_t*)wire;
  float* o = (float*)out;
#define FC_REDUCE_RF(G, S, R, RF) \
  decode_reduce_kernel<G, S, R, RF><<<(unsigned)blocks, threads, 0, st>>>(w, o, p)
#define FC_REDUCE(G, S, R)                                    \
  if (p.rows == 1) FC_REDUCE_RF(G, S, R, 1);                  \
  else FC_REDUCE_RF(G, S, R, kRowsInFlight)
  FC_BY_MODE(p, FC_REDUCE, return (int)cudaErrorInvalidValue)
#undef FC_REDUCE
#undef FC_REDUCE_RF
  return (int)cudaGetLastError();
}

// Every instantiation's attributes (repro_torch/analysis/smem.py
// INSTANCES order: the encodes, the decodes by output kind, the
// decode+reduces by rows in flight, each by mode) -> the count.
int fc_wire_attrs(int* out, int cap) {
  int k = 0;
#define FC_A_ENCODE(G, S, R) FC_ATTRS(encode_kernel<G, S, R>);
#define FC_A_DECODE(G, S, R)                 \
  FC_ATTRS(decode_kernel<G, S, R, 0>);       \
  FC_ATTRS(decode_kernel<G, S, R, 1>);       \
  FC_ATTRS(decode_kernel<G, S, R, 2>);
#define FC_A_REDUCE(G, S, R)                 \
  FC_ATTRS(decode_reduce_kernel<G, S, R, 1>); \
  FC_ATTRS(decode_reduce_kernel<G, S, R, kRowsInFlight>);
  FC_EACH_MODE(FC_A_ENCODE)
  FC_EACH_MODE(FC_A_DECODE)
  FC_EACH_MODE(FC_A_REDUCE)
#undef FC_A_REDUCE
#undef FC_A_DECODE
#undef FC_A_ENCODE
  return k;
}

}  // extern "C"
