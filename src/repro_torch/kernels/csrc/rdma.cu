// Fused quantized All2All with the push inside the kernel, for Hopper
// (sm_90a): encode + push + decode in one launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rdma_all2all.py  fused_all_to_all_rdma (_a2a_kernel) -> fc_a2a
//
// Rank my holds x[my] = (tp, m, d): block p is the m payload rows for
// peer p. The output's block j is what peer j sent (all-to-all order):
//   out[my][j] = decode(encode(x[j][my])).
// Every rank runs the declared choreography (protocol.py, peer.cuh):
//   1. ring barrier: every peer has entered this call;
//   2. encode each row straight into its destination's receive buffer,
//      row my (block p -> peer p; the own block into the own buffer), so
//      every wire byte is written once, with no send staging;
//   3. signal each destination's slot (release, system scope);
//   4. wait until every sender's slot holds this call's count (acquire);
//   5. decode the tp * m received rows, read through L2, into out[my].
// The encode and decode are codec.cuh's encode_group / decode_group, so
// the wire bytes are fc_encode_wire's and the decoded bits fc_decode_wire's.
//
// Bound on an H100: bytes. Per rank, the payload read once, the wire
// written once and read once, the output written once; on one card (the
// loopback world) all of it is HBM traffic, over 3.35 TB/s. Across cards
// the wire would cross NVLink instead.
//
// Design. A spin wait on a block that is not resident deadlocks, so the
// grid is persistent: blocks_per_rank blocks per rank, from the
// occupancy of the kernel, all resident at once (a cooperative launch
// guarantees it), each looping over the rank's groups one warp per group.
// In the loopback world one launch runs every rank on one card (grid
// dimension y = local rank); in a world of processes each process
// launches its own rank (local_ranks = 1, rank0 = its rank) through
// pointers opened from its peers' IPC handles (fc_peer_* below). The
// device code is the same, through the same table of peer pointers.

#include <string.h>

#include "codec.cuh"
#include "peer.cuh"

namespace {

using namespace fc;

constexpr int kWarps = 8;                 // warps per block, one group each at a time
constexpr int kThreads = kWarps * 32;

template <int VPL, typename T>
__global__ void __launch_bounds__(kThreads) a2a_kernel(const T* __restrict__ x, void* __restrict__ out,
                                                       const WireParams p, const PeerTable t,
                                                       long long m) {
  __shared__ __align__(8) uint8_t codes_s[kWarps][VPL * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = blockIdx.y;              // local rank
  const int my = t.rank0 + lr;
  const long long rows = (long long)t.tp * m;          // rows a rank sends and receives
  const long long warps = rows * p.groups;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const T* xr = x + (long long)lr * rows * p.n;

  ring_barrier(t, my);

  for (long long gid = first; gid < warps; gid += stride) {   // uniform per warp
    const long long row = gid / p.groups, g = gid % p.groups;
    const long long dst = row / m, r = row % m;
    uint8_t* w = t.recv[dst] + my * t.row_bytes + r * p.wb;
    encode_group<VPL>(xr + row * p.n + g * p.group, w, g, lane, codes_s[warp], p);
  }

  signal_pushes(t, my);
  wait_pushes(t, my);

  const uint8_t* recv = t.recv[my];
  const long long out0 = (long long)lr * rows * p.n;
  for (long long gid = first; gid < warps; gid += stride) {
    const long long row = gid / p.groups, g = gid % p.groups;
    const long long src = row / m, r = row % m;
    float v[VPL];
    decode_group<VPL, LoadL2>(recv + src * t.row_bytes + r * p.wb, g, lane, p, v);
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      store_out(out, out0 + row * p.n + g * p.group + k * 32 + lane, v[k], p.out_kind);
  }
}

template <int VPL, typename T>
int occupancy() {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, a2a_kernel<VPL, T>, kThreads, 0) != cudaSuccess)
    return 0;
  return occ;
}

template <int VPL, typename T>
int launch(const void* x, void* out, const WireParams& p, const PeerTable& t, long long m,
           int blocks_per_rank, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  void* args[] = {(void*)&xt, (void*)&out, (void*)&p, (void*)&t, (void*)&m};
  return (int)cudaLaunchCooperativeKernel((const void*)a2a_kernel<VPL, T>,
                                          dim3(blocks_per_rank, t.local_ranks), dim3(kThreads),
                                          args, 0, st);
}

template <typename T>
int launch_by_group(const void* x, void* out, const WireParams& p, const PeerTable& t,
                    long long m, int bpr, cudaStream_t st) {
  switch (p.group) {
    case 32: return launch<1, T>(x, out, p, t, m, bpr, st);
    case 64: return launch<2, T>(x, out, p, t, m, bpr, st);
    case 128: return launch<4, T>(x, out, p, t, m, bpr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int min_occupancy() {
  int a = occupancy<1, T>(), b = occupancy<2, T>(), c = occupancy<4, T>();
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

}  // namespace

extern "C" {

// Blocks per rank for `local_ranks` ranks on card `dev`: every block of
// every rank resident at once, for every group and payload type, so one
// world keeps one count across calls.
int fc_a2a_blocks_per_rank(int dev, int local_ranks) {
  int sms = 0;
  if (cudaSetDevice(dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  const int f = min_occupancy<float>(), b = min_occupancy<__nv_bfloat16>();
  return (f < b ? f : b) * sms / local_ranks;
}

// x: (local_ranks, tp, m, n) payload (in_kind 0 f32, 1 bf16); out:
// the same shape, out_kind as in params. params/thr/frac/f: the wire
// codec's (kernels/wire.py _params, rows = tp * m). peer: the table of
// peer.cuh read_peer, m the rows a rank sends each peer.
int fc_a2a(const void* x, void* out, const long long* params, const unsigned* thr,
           const float* frac, const float* f, const long long* peer, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  PeerArgs a;
  if (!read_peer(peer, a)) return (int)cudaErrorInvalidValue;
  if (const int rc = use_device_of(x)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (a.in_kind) {
    case 0: rc = launch_by_group<float>(x, out, p, a.t, a.m, a.blocks_per_rank, st); break;
    case 1: rc = launch_by_group<__nv_bfloat16>(x, out, p, a.t, a.m, a.blocks_per_rank, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// ---- a world of processes: receive buffers and pads shared by CUDA IPC ----
//
// Each rank allocates its buffers with a plain cudaMalloc (an IPC handle
// covers a whole allocation, so no block of a caching allocator is
// exported), zeroed before any kernel can see it, and opens its peers'
// handles. A process cannot open its own handle: it keeps its pointer.

int fc_peer_alloc(int dev, long long bytes, void** out) {
  cudaError_t e = cudaSetDevice(dev);
  if (e == cudaSuccess) e = cudaMalloc(out, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*out, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// handle: cudaIpcMemHandle_t, 64 bytes
int fc_peer_export(void* ptr, void* handle) {
  return (int)cudaIpcGetMemHandle(reinterpret_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

// Peer access from card dev to card peer_dev (nothing to do on one card).
int fc_peer_enable(int dev, int peer_dev) {
  if (dev == peer_dev) return 0;
  int can = 0;
  cudaError_t e = cudaSetDevice(dev);
  if (e == cudaSuccess) e = cudaDeviceCanAccessPeer(&can, dev, peer_dev);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaDeviceEnablePeerAccess(peer_dev, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}

int fc_peer_open(int dev, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int fc_peer_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int fc_peer_free(void* ptr) { return (int)cudaFree(ptr); }

}  // extern "C"
