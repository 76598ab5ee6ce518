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
//   1. ring barrier: every peer has entered this call, so (stream order)
//      its last call has ended, and with it that call's decode of its
//      receive rows: no push of this call lands in a row still being read;
//   2. encode each row straight into its destination's receive buffer,
//      row my (block p -> peer p; the own block into the own buffer), so
//      every wire byte is written once, with no send staging;
//   3. signal each destination's slot and the own local slot;
//   4. wait until every sender's slot and the local slot hold this call's
//      targets;
//   5. decode the tp * m received rows, read through L2, into out[my].
// The encode and decode are codec.cuh's quantize8 / bytes8 / put8 and
// fetch8 / finish8, so the wire bytes are fc_encode_wire's and the
// decoded bits fc_decode_wire's.
//
// Bound on an H100: bytes (rdma.py bound_bytes). Per rank, the payload
// read once, the wire written once and read once, the output written
// once; on one card (the loopback world, or processes sharing a card)
// all of it is HBM traffic, over 3.35 TB/s. Across cards the wire would
// cross NVLink instead.
//
// Design. Eight values a thread, as fc_encode_wire and fc_decode_wire
// (codec.cuh): one flat item space a rank, the tp * m rows x d / 8 items,
// which the grid's threads walk with a stride of the grid, the encode
// and then the decode. d is a multiple of the group, so a thread's eight
// values never cross a group or a row, and a group's G / 8 lanes never
// cross a warp (blocks and strides are multiples of 32). The encode
// loads 16 bytes a thread (eight bf16, cast exactly to f32, or two
// float4), quantizes with the group's lanes by shuffle and stores u
// bytes a plane; the decode loads u bytes a plane through L2 (the rows
// were written by other ranks' blocks, on other SMs or from other
// processes), its group's first four lanes a meta section each, and
// stores 16 bytes a thread (two bf16 values an instruction). The grid
// is sized by the call's work: blocks a rank = min(cap, ceil(items /
// kThreads)) (rdma.py PeerWorld.a2a_blocks), where cap, the most blocks
// a rank of the instantiation that are resident at once on the card
// (fc_a2a_blocks_per_rank; a cooperative launch, so no spin wait waits on
// a block that is not resident), is agreed by the world; the host keeps
// each pad's running target, since the waits count peer blocks. At the
// decode dispatch (tp = 4, 16 rows a peer of 2048 values) that is 64
// blocks of 256 a rank, one item a thread.
// Signalling is fc_ar's (peer.cuh peer_barrier / peer_signal /
// peer_wait): one fence a block a round, at gpu scope when every rank is
// on this card, relaxed adds, every counter of a wait polled at once.
// The mode (group, spike, rotation) and the payload type T (f32 or bf16,
// the output's too) are template arguments.
//
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

constexpr int kThreads = 256;             // rdma.py A2A_THREADS

// x: (local_ranks, tp * m, d) payload -> out: the same, as T; p: the wire
// of a row of d values; t: the protocol's table; m: rows a rank sends
// each peer. Thread it of the item space handles row it / (d / 8),
// elements e0 .. e0 + 7 of it; the wrapper keeps the items within 32
// bits. At least three blocks an SM (at most 85 registers a thread):
// ptxas gives every mode 56 registers, with no spill, so four fit.
template <int G, bool SPIKE, bool ROT, typename T>
__global__ void __launch_bounds__(kThreads, 3) a2a_kernel(const T* __restrict__ x,
                                                       T* __restrict__ out, const WireParams p,
                                                       const PeerTable t, unsigned m) {
  constexpr int OUT = sizeof(T) == 4 ? 0 : 1;       // store8_out's kind: f32, bf16
  const int lr = blockIdx.y;                         // local rank
  const int my = t.rank0 + lr;
  const unsigned per_row = (unsigned)(p.n / kPer);
  const unsigned items = (unsigned)t.tp * m * per_row;
  const unsigned stride = gridDim.x * kThreads;
  const int lt = threadIdx.x % (G / kPer);
  const long long base = (long long)lr * t.tp * m * p.n;   // this local rank's rows

  peer_barrier(t, my);

  for (unsigned b = blockIdx.x * kThreads; b < items; b += stride) {   // uniform per block
    const unsigned it = b + threadIdx.x;
    const bool active = it < items;
    const unsigned row = active ? it / per_row : 0;
    const long long e0 = active ? (long long)(it - row * per_row) * kPer : 0;
    float v[kPer];
    load8(x + base + (long long)row * p.n + e0, active, v);
    const Code8 c = quantize8<G, SPIKE, ROT>(v, lt, p);
    if (active) {
      const unsigned dst = row / m, r = row - dst * m;
      put8(t.recv[dst] + my * t.row_bytes + (long long)r * p.wb, bytes8<G, SPIKE>(c, e0, lt, p), p);
    }
  }

  peer_signal(t, my);
  peer_wait(t, my);

  const uint8_t* recv = t.recv[my];
  for (unsigned b = blockIdx.x * kThreads; b < items; b += stride) {
    const unsigned it = b + threadIdx.x;
    const bool active = it < items;
    const unsigned row = active ? it / per_row : 0;
    const long long e0 = active ? (long long)(it - row * per_row) * kPer : 0;
    const unsigned src = row / m, r = row - src * m;
    float v[kPer];
    decode8<G, SPIKE, ROT, LoadL2>(recv + src * t.row_bytes + (long long)r * p.wb, e0, lt, active, p, v);
    if (active) store8_out<OUT>(out, base + (long long)row * p.n + e0, v);
  }
}

template <int G, bool SPIKE, bool ROT, typename T>
int occupancy() {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, a2a_kernel<G, SPIKE, ROT, T>, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return occ;
}

template <int G, bool SPIKE, bool ROT, typename T>
int launch(const void* x, void* out, const WireParams& p, const PeerArgs& a, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  unsigned m = (unsigned)a.m;
  void* args[] = {(void*)&xt, (void*)&o, (void*)&p, (void*)&a.t, (void*)&m};
  return (int)cudaLaunchCooperativeKernel((const void*)a2a_kernel<G, SPIKE, ROT, T>,
                                          dim3(a.blocks_per_rank, a.t.local_ranks), dim3(kThreads),
                                          args, 0, st);
}

}  // namespace

extern "C" {

// Blocks a rank of the kernel for (group, spike, rotation, in_kind: 0
// f32, 1 bf16) that are resident at once for `local_ranks` ranks on card
// `dev`: the cap of a call's grid (-1 for a mode the kernel does not
// take).
int fc_a2a_blocks_per_rank(int dev, int local_ranks, int group, int spike, int rotation,
                           int in_kind) {
  int sms = 0;
  if (in_kind != 0 && in_kind != 1) return -1;
  if (cudaSetDevice(dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  WireParams p;
  p.group = group;
  p.spike = spike;
  p.rotation = rotation;
  int occ = 0;
#define FC_OCC(G, S, R) \
  occ = in_kind == 0 ? occupancy<G, S, R, float>() : occupancy<G, S, R, __nv_bfloat16>()
  FC_BY_MODE(p, FC_OCC, return -1)
#undef FC_OCC
  return occ * sms / local_ranks;
}

// x: (local_ranks, tp, m, n) payload (the table's in_kind: 0 f32, 1
// bf16); out: the same shape and type (params' out_kind must be that
// type's). params/thr/frac/f: the wire codec's (kernels/wire.py _params,
// rows = tp * m). peer: the table of peer.cuh read_peer, m the rows a
// rank sends each peer, blocks_per_rank this call's grid.
int fc_a2a(const void* x, void* out, const long long* params, const unsigned* thr,
           const float* frac, const float* f, const long long* peer, void* stream) {
  const WireParams p = fill_params(params, thr, frac, f);
  PeerArgs a;
  if (!read_peer(peer, a) || (a.in_kind != 0 && a.in_kind != 1) || p.out_kind != a.in_kind ||
      p.n % kPer != 0 || a.m < 1)
    return (int)cudaErrorInvalidValue;
  // the item space and its grid stride stay within 32 bits
  if ((long long)a.t.tp * a.m * (p.n / kPer) + (long long)a.blocks_per_rank * kThreads > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  if (const int rc = use_device_of(x)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
#define FC_A2A(G, S, R)                                                              \
  rc = a.in_kind == 0 ? launch<G, S, R, float>(x, out, p, a, st)                     \
                      : launch<G, S, R, __nv_bfloat16>(x, out, p, a, st)
  FC_BY_MODE(p, FC_A2A, return (int)cudaErrorInvalidValue)
#undef FC_A2A
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

// Every instantiation's attributes (repro_torch/analysis/smem.py
// INSTANCES order: A2A_MODES, float then bf16 payloads) -> the count.
int fc_rdma_attrs(int* out, int cap) {
  int k = 0;
#define FC_A_A2A(G, S, R)                         \
  FC_ATTRS(a2a_kernel<G, S, R, float>);           \
  FC_ATTRS(a2a_kernel<G, S, R, __nv_bfloat16>);
  FC_EACH_MODE(FC_A_A2A)
#undef FC_A_A2A
  return k;
}

}  // extern "C"
