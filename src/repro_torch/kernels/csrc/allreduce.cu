// Fused two-step quantized AllReduce with the push inside the kernel, for
// Hopper (sm_90a): one launch a call.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rdma_allreduce.py  fused_all_reduce_rdma
//     _scatter_reduce_kernel + _gather_kernel -> fc_ar
//
// Rank my holds x[my] = (n,), chunk = n / tp a group multiple; chunk p is
// values p * chunk .. (p + 1) * chunk. One kernel runs both phases of the
// declared choreography (protocol.py allreduce_*_protocol, peer.cuh),
// each phase on its own receive buffers and signal pads:
//   1. ring barrier (the scatter protocol's);
//   2. encode chunk p straight into peer p's scatter row my (no send
//      staging); the own chunk goes into the own row my, locally;
//   3. signal, wait (the scatter protocol's slots);
//   4. decode the tp received rows of each tile of the own chunk, read
//      through L2, and sum them in row order from +0.0 (the order of
//      fc_decode_reduce and core/collectives.py sum_rows); the same
//      threads quantize the sum at once and write its bytes into every
//      peer's gather row my (the own row locally): the partial never
//      leaves registers, one encode, tp writes;
//   5. signal, wait (the gather protocol's slots);
//   6. decode all tp gather rows into out (n,): row p is chunk p.
// The encode and decode are codec.cuh's quantize8 / bytes8 / put8 / decode8
// (step 4 fetches kRowsInFlight rows' bytes before it decodes them), so
// the wire bytes are fc_encode_wire's and the decoded bits
// fc_decode_wire's, and the result is the two-step schedule's
// (core/collectives.py) bit for bit.
//
// The gather protocol's ring barrier is not run: step 1 covers its
// buffer. A rank writes a peer's gather row only after step 1 of the
// same call, which the peer passes only once every rank has entered this
// call; a rank enters a call only after its last call has ended (stream
// order: the loopback world's ranks share one launch, a world of
// processes runs one launch a rank on one stream), and with it that
// call's step 6, the last read of the gather rows. So no push of call
// k + 1 lands in a row that call k still reads; the gather pad's barrier
// counter stays 0 and its slots count pushes only. chip_smoke.py phase ar
// checks it with back-to-back calls of mixed sizes and no sync between
// them: every output and receive row exact, every pad at its target.
//
// Bound on an H100: bytes (rdma.py bound_bytes_ar). Per rank: x read
// (4n), tp scatter rows of wire_bytes(chunk) written and read, tp gather
// rows written and read, out written (4n); the partial stays in
// registers. On one card (the loopback world, or processes sharing a
// card) all of it is HBM traffic over 3.35 TB/s; across cards the pushed
// rows would cross NVLink. The quantizer's arithmetic (an IEEE division
// a value) keeps the encode steps near the wire encode's rate, not the
// bytes' (PERF.md, from the step stamps below).
//
// Design. Eight values a thread (codec.cuh): a block of 256 threads
// covers a tile of 2048 consecutive values of one chunk row; each step
// walks its tiles (tp * tiles for 2 and 6, tiles for 4) with a stride of
// the grid. Where step 4 has fewer tiles than the grid has blocks (the
// decode step's sizes) and tp divides 256, a block takes 1 / tp of a
// tile instead, each thread decoding one row into shared memory and the
// first 256 / tp threads summing them in order: the rows' decodes run
// side by side, not one after another in each thread. The grid is sized by the call's work: blocks a rank =
// min(cap, tp * ceil(chunk / 2048)) (rdma.py PeerWorld.ar_blocks), where
// cap, the most blocks a rank that are resident at once on the card
// (fc_ar_blocks_per_rank; a cooperative launch, so no spin wait waits on
// a block that is not resident), is agreed by the world. Every rank
// computes the same count from (n, tp, cap), and the host keeps each
// pad's running target, since the waits count peer blocks. At the decode
// shape (tp = 4, n = 20,480) that is 12 blocks a rank where a grid of the
// whole card ran hundreds of mostly idle ones, each signalling.
// Every block signals its peers itself (peer.cuh). One leader block a
// rank signalling for the others was timed beside it at the decode shape
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) and was the slower
// by 0.5-0.8 us a call (one hop more a round; 12 blocks a rank make few
// atomics), level at the prefill shape, so it was not kept.

#include "codec.cuh"
#include "peer.cuh"

namespace {

using namespace fc;

constexpr int kThreads = 256;
constexpr int kTile = kThreads * kPer;    // 2048 values: rdma.py AR_TILE
constexpr int kStamps = 7;                // rdma.py AR_STAMPS
constexpr int kRowsInFlight = 4;          // step 4 loads this many rows before it sums them

// Block 0 of a rank, thread 0: the card's clock (ns) at step boundary i
// into stamps[lr][i], when the caller asked for stamps.
__device__ __forceinline__ void stamp(unsigned long long* stamps, int lr, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) stamps[lr * kStamps + i] = global_ns();
}

// Quantize a thread's eight partial sums (elements e0 .. e0 + 7 of the
// rank's chunk) and put their bytes into every rank's gather row my.
template <int G, bool SPIKE, bool ROT>
__device__ __forceinline__ void quantize_put(float (&acc)[kPer], long long e0, int lt, bool active,
                                             const WireParams& p, const PeerTable& tg, int my) {
  const Code8 c = quantize8<G, SPIKE, ROT>(acc, lt, p);
  const Bytes8 b = bytes8<G, SPIKE>(c, e0, lt, p);
  if (active)
    for (int dst = 0; dst < tg.tp; ++dst) put8(tg.recv[dst] + my * tg.row_bytes, b, p);
}

// x: (local_ranks, n) f32 -> out: (local_ranks, n) f32; p: the wire of a
// chunk row; ts / tg: the scatter and gather protocols' tables; stamps:
// a measurement hook, null on the serve paths, or (local_ranks, kStamps)
// u64 for the step boundaries (start, barrier passed, step 2 done,
// scatter rows in, step 4 done, gather rows in, end) as block 0 of each
// rank sees them.
// Three blocks an SM (at most 85 registers a thread) keep 24 warps a
// card's SM in flight; the rotating modes, which need about 200, one.
template <int G, bool SPIKE, bool ROT>
__global__ void __launch_bounds__(kThreads, ROT ? 1 : 3) ar_kernel(const float* __restrict__ x,
                                                      float* __restrict__ out, const WireParams p,
                                                      const PeerTable ts, const PeerTable tg,
                                                      unsigned long long* __restrict__ stamps) {
  const int lr = blockIdx.y;
  const int my = ts.rank0 + lr;
  const int tp = ts.tp;
  const long long chunk = p.n;
  const long long tiles = (chunk + kTile - 1) / kTile;
  const long long te = (long long)threadIdx.x * kPer;   // the thread's values in a tile
  const int lt = threadIdx.x % (G / kPer);
  const float* xr = x + (long long)lr * tp * chunk;

  stamp(stamps, lr, 0);
  peer_barrier(ts, my);
  stamp(stamps, lr, 1);

  for (long long it = blockIdx.x; it < tp * tiles; it += gridDim.x) {   // uniform per block
    const long long dst = it / tiles, e0 = (it % tiles) * kTile + te;
    const bool active = e0 < chunk;
    float v[kPer];
    load8(xr + dst * chunk + e0, active, v);
    const Code8 c = quantize8<G, SPIKE, ROT>(v, lt, p);
    if (active) put8(ts.recv[dst] + my * ts.row_bytes, bytes8<G, SPIKE>(c, e0, lt, p), p);
  }

  stamp(stamps, lr, 2);
  peer_signal(ts, my);
  peer_wait(ts, my);
  stamp(stamps, lr, 3);

  const uint8_t* rs = ts.recv[my];
  if (kThreads % tp == 0 && tiles * tp <= gridDim.x) {
    // Few tiles (the decode step's sizes): a block takes 1 / tp of a tile,
    // its threads split by row, each decoding 8 values of one row into
    // shared memory; then the first kThreads / tp threads sum the rows
    // in order: one row's latency on the path where there were tp.
    __shared__ float part[kTile];         // tp rows of kTile / tp values
    const int per = kThreads / tp;        // threads a row: 16 or more, a multiple of G / 8
    const int r = threadIdx.x / per, j = threadIdx.x % per;
    for (long long it = blockIdx.x; it < tiles * tp; it += gridDim.x) {
      const long long base = (it / tp) * kTile + (it % tp) * (kTile / tp);
      const long long e0 = base + (long long)j * kPer;
      float v[kPer];
      decode8<G, SPIKE, ROT>(rs + r * ts.row_bytes, e0, j % (G / kPer), e0 < chunk, p, v);
#pragma unroll
      for (int k = 0; k < kPer; ++k) part[r * (kTile / tp) + j * kPer + k] = v[k];
      __syncthreads();
      if (threadIdx.x < ((per + 31) & ~31)) {          // whole warps: quantize8 shuffles
        const bool mine = threadIdx.x < per;
        const long long q0 = base + (long long)threadIdx.x * kPer;
        float acc[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
        for (int rr = 0; rr < tp; ++rr)
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            acc[k] = __fadd_rn(acc[k], mine ? part[rr * (kTile / tp) + threadIdx.x * kPer + k] : 0.f);
        quantize_put<G, SPIKE, ROT>(acc, q0, lt, mine && q0 < chunk, p, tg, my);
      }
      __syncthreads();                     // part is the next item's
    }
  } else {
    for (long long it = blockIdx.x; it < tiles; it += gridDim.x) {
      const long long e0 = it * kTile + te;
      const bool active = e0 < chunk;
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
      for (int r0 = 0; r0 < tp; r0 += kRowsInFlight) {   // rows in order
        Raw8 raw[kRowsInFlight];
#pragma unroll
        for (int jj = 0; jj < kRowsInFlight; ++jj)
          if (r0 + jj < tp) raw[jj] = fetch8<G, SPIKE>(rs + (r0 + jj) * ts.row_bytes, e0, lt, active, p);
#pragma unroll
        for (int jj = 0; jj < kRowsInFlight; ++jj) {
          if (r0 + jj < tp) {
            float v[kPer];
            finish8<G, SPIKE, ROT>(raw[jj], lt, p, v);
#pragma unroll
            for (int k = 0; k < kPer; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
          }
        }
      }
      quantize_put<G, SPIKE, ROT>(acc, e0, lt, active, p, tg, my);
    }
  }

  stamp(stamps, lr, 4);
  peer_signal(tg, my);
  peer_wait(tg, my);
  stamp(stamps, lr, 5);

  const uint8_t* rg = tg.recv[my];
  float* o = out + (long long)lr * tp * chunk;
  for (long long it = blockIdx.x; it < tp * tiles; it += gridDim.x) {
    const long long src = it / tiles, e0 = (it % tiles) * kTile + te;
    const bool active = e0 < chunk;
    float v[kPer];
    decode8<G, SPIKE, ROT>(rg + src * tg.row_bytes, e0, lt, active, p, v);
    if (active) store8(o + src * chunk + e0, v);
  }
  stamp(stamps, lr, 6);
}

template <int G, bool SPIKE, bool ROT>
int occupancy() {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ar_kernel<G, SPIKE, ROT>, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return occ;
}

template <int G, bool SPIKE, bool ROT>
int launch(const float* x, float* out, const WireParams& p, const PeerArgs& s, const PeerArgs& g,
           unsigned long long* stamps, cudaStream_t st) {
  void* args[] = {(void*)&x, (void*)&out, (void*)&p, (void*)&s.t, (void*)&g.t, (void*)&stamps};
  return (int)cudaLaunchCooperativeKernel((const void*)ar_kernel<G, SPIKE, ROT>,
                                          dim3(s.blocks_per_rank, s.t.local_ranks), dim3(kThreads),
                                          args, 0, st);
}

}  // namespace

extern "C" {

// Blocks a rank of the kernel for (group, spike, rotation) that are
// resident at once for `local_ranks` ranks on card `dev`: the cap of a
// call's grid (-1 for a mode the kernel does not take).
int fc_ar_blocks_per_rank(int dev, int local_ranks, int group, int spike, int rotation) {
  int sms = 0;
  if (cudaSetDevice(dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  WireParams p;
  p.group = group;
  p.spike = spike;
  p.rotation = rotation;
  int occ = 0;
#define FC_OCC(G, S, R) occ = occupancy<G, S, R>()
  FC_BY_MODE(p, FC_OCC, return -1)
#undef FC_OCC
  return occ * sms / local_ranks;
}

// x: (local_ranks, n) f32 -> out: (local_ranks, n) f32. params/thr/frac/f
// are the wire codec's for rows of chunk values (kernels/wire.py
// _params); peer_scatter / peer_gather the two protocols' tables of this
// call (one grid: the same blocks_per_rank); stamps null or
// (local_ranks, kStamps) u64 (ar_kernel).
int fc_ar(const void* x, void* out, const long long* params, const unsigned* thr,
          const float* frac, const float* f, const long long* peer_scatter,
          const long long* peer_gather, void* stamps, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  PeerArgs s, g;
  if (!read_peer(peer_scatter, s) || !read_peer(peer_gather, g) || s.in_kind != 0 ||
      g.blocks_per_rank != s.blocks_per_rank || g.t.tp != s.t.tp ||
      g.t.local_ranks != s.t.local_ranks || g.t.rank0 != s.t.rank0)
    return (int)cudaErrorInvalidValue;
  if (const int rc = use_device_of(x)) return rc;
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
#define FC_AR(G, S, R) rc = launch<G, S, R>(xs, o, p, s, g, (unsigned long long*)stamps, st)
  FC_BY_MODE(p, FC_AR, return (int)cudaErrorInvalidValue)
#undef FC_AR
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// Every instantiation's attributes (repro_torch/analysis/smem.py
// INSTANCES order: AR_MODES) -> the count.
int fc_allreduce_attrs(int* out, int cap) {
  int k = 0;
#define FC_A_AR(G, S, R) FC_ATTRS(ar_kernel<G, S, R>);
  FC_EACH_MODE(FC_A_AR)
#undef FC_A_AR
  return k;
}

}  // extern "C"
