// Fused two-step quantized AllReduce with the push inside the kernels, for
// Hopper (sm_90a): one launch for each phase.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rdma_allreduce.py  fused_all_reduce_rdma
//     _scatter_reduce_kernel -> fc_ar_scatter
//     _gather_kernel         -> fc_ar_gather
//
// Rank my holds x[my] = (n,), chunk = n / tp a group multiple; chunk p is
// values p * chunk .. (p + 1) * chunk. Both phases run the declared
// choreography (protocol.py allreduce_*_protocol, peer.cuh), each on its
// own receive buffers and signal pads:
//
// fc_ar_scatter (phase 1, scatter-reduce)
//   1. ring barrier;
//   2. encode chunk p straight into peer p's receive row my (no send
//      staging); the own chunk goes into the own row my, locally, and is
//      never pushed;
//   3. signal, wait (release / acquire, system scope);
//   4. decode the tp received rows, read through L2, and sum them in row
//      order from +0.0 into the f32 partial (chunk,): the order of
//      fc_decode_reduce and of core/collectives.py sum_rows.
// fc_ar_gather (phase 2, gather)
//   1. ring barrier;
//   2. quantize each group of the partial once and write its bytes into
//      every peer's gather row my (the own row locally): one encode,
//      tp writes;
//   3. signal, wait;
//   4. decode all tp rows into out (n,): row p is chunk p.
// The encode and decode are codec.cuh's, so the wire bytes and the
// decoded bits are those of fc_encode_wire / fc_decode_wire, and the
// result is the two-step schedule's (core/collectives.py) bit for bit.
//
// Bound on an H100: bytes. Per rank, phase 1 reads x (4n), writes and
// reads tp wire rows of wire_bytes(chunk) and writes the partial
// (4 chunk); phase 2 reads the partial, writes and reads tp wire rows and
// writes the output (4n). On one card (the loopback world, or processes
// sharing a card) all of it is HBM traffic over 3.35 TB/s; across cards
// the pushed rows would cross NVLink instead.
//
// Design: rdma.cu's. A persistent grid of blocks_per_rank blocks a rank,
// launched cooperatively, so that no spin wait waits on a block that is
// not resident; one warp a group, looping over the rank's groups.

#include "codec.cuh"
#include "peer.cuh"

namespace {

using namespace fc;

constexpr int kWarps = 8;                 // warps per block, one group each at a time
constexpr int kThreads = kWarps * 32;

// x: (local_ranks, n) f32 -> partial: (local_ranks, chunk) f32.
template <int VPL>
__global__ void __launch_bounds__(kThreads) ar_scatter_kernel(const float* __restrict__ x,
                                                              float* __restrict__ partial,
                                                              const WireParams p, const PeerTable t) {
  __shared__ __align__(8) uint8_t codes_s[kWarps][VPL * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = blockIdx.y;
  const int my = t.rank0 + lr;
  const long long chunk = p.n;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const float* xr = x + (long long)lr * t.tp * chunk;

  ring_barrier(t, my);

  const long long enc = (long long)t.tp * p.groups;
  for (long long gid = first; gid < enc; gid += stride) {       // uniform per warp
    const long long dst = gid / p.groups, g = gid % p.groups;
    encode_group<VPL>(xr + dst * chunk + g * p.group, t.recv[dst] + my * t.row_bytes, g, lane,
                      codes_s[warp], p);
  }

  signal_pushes(t, my);
  wait_pushes(t, my);

  const uint8_t* recv = t.recv[my];
  float* out = partial + (long long)lr * chunk;
  for (long long g = first; g < p.groups; g += stride) {
    float acc[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) acc[k] = 0.f;
    for (int r = 0; r < t.tp; ++r) {
      float v[VPL];
      decode_group<VPL, LoadL2>(recv + r * t.row_bytes, g, lane, p, v);
#pragma unroll
      for (int k = 0; k < VPL; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < VPL; ++k) out[g * p.group + k * 32 + lane] = acc[k];
  }
}

// partial: (local_ranks, chunk) f32 -> out: (local_ranks, n) f32.
template <int VPL>
__global__ void __launch_bounds__(kThreads) ar_gather_kernel(const float* __restrict__ partial,
                                                             float* __restrict__ out,
                                                             const WireParams p, const PeerTable t) {
  __shared__ __align__(8) uint8_t codes_s[kWarps][VPL * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = blockIdx.y;
  const int my = t.rank0 + lr;
  const long long chunk = p.n;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const float* pr = partial + (long long)lr * chunk;

  ring_barrier(t, my);

  for (long long g = first; g < p.groups; g += stride) {
    const GroupCode c = quantize_group<VPL>(pr + g * p.group, lane, codes_s[warp], p);
    for (int dst = 0; dst < t.tp; ++dst)
      write_group<VPL>(t.recv[dst] + my * t.row_bytes, g, lane, codes_s[warp], c, p);
    __syncwarp();                         // codes is reused by the warp's next group
  }

  signal_pushes(t, my);
  wait_pushes(t, my);

  const uint8_t* recv = t.recv[my];
  float* o = out + (long long)lr * t.tp * chunk;
  const long long dec = (long long)t.tp * p.groups;
  for (long long gid = first; gid < dec; gid += stride) {
    const long long src = gid / p.groups, g = gid % p.groups;
    float v[VPL];
    decode_group<VPL, LoadL2>(recv + src * t.row_bytes, g, lane, p, v);
#pragma unroll
    for (int k = 0; k < VPL; ++k) o[src * chunk + g * p.group + k * 32 + lane] = v[k];
  }
}

template <typename K>
int occupancy(K kernel) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return occ;
}

int min_occupancy() {
  const int occ[] = {occupancy(ar_scatter_kernel<1>), occupancy(ar_scatter_kernel<2>),
                     occupancy(ar_scatter_kernel<4>), occupancy(ar_gather_kernel<1>),
                     occupancy(ar_gather_kernel<2>), occupancy(ar_gather_kernel<4>)};
  int m = occ[0];
  for (int o : occ) m = o < m ? o : m;
  return m;
}

template <typename K>
int launch(K kernel, const float* src, float* dst, const WireParams& p, const PeerArgs& a,
           cudaStream_t st) {
  void* args[] = {(void*)&src, (void*)&dst, (void*)&p, (void*)&a.t};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(a.blocks_per_rank, a.t.local_ranks),
                                          dim3(kThreads), args, 0, st);
}

// One phase: params/thr/frac/f are the wire codec's for rows of chunk
// values (kernels/wire.py _params); peer is peer.cuh's table.
int run_phase(bool scatter, const void* src, void* dst, const long long* params,
              const unsigned* thr, const float* frac, const float* f, const long long* peer,
              void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  PeerArgs a;
  if (!read_peer(peer, a) || a.in_kind != 0) return (int)cudaErrorInvalidValue;
  if (const int rc = use_device_of(src)) return rc;
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (p.group) {
    case 32: rc = scatter ? launch(ar_scatter_kernel<1>, s, d, p, a, st)
                          : launch(ar_gather_kernel<1>, s, d, p, a, st); break;
    case 64: rc = scatter ? launch(ar_scatter_kernel<2>, s, d, p, a, st)
                          : launch(ar_gather_kernel<2>, s, d, p, a, st); break;
    case 128: rc = scatter ? launch(ar_scatter_kernel<4>, s, d, p, a, st)
                           : launch(ar_gather_kernel<4>, s, d, p, a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per rank of both phases for `local_ranks` ranks on card `dev`:
// every block of every rank resident at once, for every group.
int fc_ar_blocks_per_rank(int dev, int local_ranks) {
  int sms = 0;
  if (cudaSetDevice(dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  return min_occupancy() * sms / local_ranks;
}

// x: (local_ranks, n) f32 -> partial: (local_ranks, chunk) f32.
int fc_ar_scatter(const void* x, void* partial, const long long* params, const unsigned* thr,
                  const float* frac, const float* f, const long long* peer, void* stream) {
  return run_phase(true, x, partial, params, thr, frac, f, peer, stream);
}

// partial: (local_ranks, chunk) f32 -> out: (local_ranks, n) f32.
int fc_ar_gather(const void* partial, void* out, const long long* params, const unsigned* thr,
                 const float* frac, const float* f, const long long* peer, void* stream) {
  return run_phase(false, partial, out, params, thr, frac, f, peer, stream);
}

}  // extern "C"
