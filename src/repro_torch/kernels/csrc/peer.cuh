// Peer-push device code: the ring barrier, the push signals and the waits
// of the declared choreography (repro_torch/kernels/protocol.py), over a
// table of peer pointers. Shared by the peer-push kernels (rdma.cu,
// allreduce.cu). Each protocol (collective id) has its own receive
// buffers and signal pads, so the kernels of two protocols never touch
// each other's counters.
//
// Every rank owns a receive buffer that peers write into and a signal pad
// of u32 counters that peers add to:
//   pad[0]                 the barrier counter
//   pad[1 + s]             receive slot s (s < sem_slots): push step i
//                          (peer my + i) adds to slot i - 1 over there
//   pad[1 + sem_slots]     the local slot: the rank's own blocks
// Counters only grow, and no pad is ever reset. The host (rdma.py
// PeerWorld) keeps, for each protocol, the running sum of what every
// call adds to each counter, and passes the sums after this call in the
// table (bar_target, slot_target, local_target): the waits compare
// against them, so the grid may change from call to call (both kernels
// size theirs by the call's work).
//
// Signals (peer_barrier, peer_signal, peer_wait): one fence.acq_rel a
// block a signal round, at the world's scope (the table's kFlagOneCard:
// every rank on one card, gpu; else sys), then relaxed adds; a wait polls
// every counter it needs at once with relaxed loads, then fences once.
// The barrier's signals are relaxed with no fence: entering a call
// publishes nothing (the rank's last call has ended, stream order).
// Every block of a rank signals the barrier of each peer, each push
// step's slot and the local slot, and waits on the rank's own counters
// itself: a call of B blocks a rank adds wait_count * B to a barrier and
// B to a slot (allreduce.cu says why not one leader block a rank).
//
// Ordering: a block's stores, then __syncthreads(), then one thread's
// fence and its adds to the destination's pad; the waiting thread's
// fence after its relaxed loads, then __syncthreads() before the block
// reads what the signal covers (through L2: __ldcg in codec.cuh). A wait
// that outlasts kWaitNs traps, so a fault cannot hang the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace fc {

constexpr int kMaxPeers = 16;
constexpr unsigned long long kWaitNs = 5000000000ull;   // 5 s
constexpr int kFlagOneCard = 1;            // every rank on this card: gpu-scope fences

struct PeerTable {
  uint8_t* recv[kMaxPeers];        // each rank's receive buffer
  unsigned* signal[kMaxPeers];     // each rank's signal pad
  long long row_bytes;             // stride of a receive row
  int tp, local_ranks, rank0;      // ranks; this launch runs rank0 + blockIdx.y
  int sem_slots;
  int n_signal;                    // barrier: signal (my + off) % tp for each off
  int signal_off[kMaxPeers];
  int wait_count;                  // barrier: peers that signal each rank
  int n_push;                      // push step i: peer (my + dst_off[i]) % tp, its slot recv_slot[i]
  int push_dst_off[kMaxPeers];
  int push_recv_slot[kMaxPeers];
  unsigned bar_target, slot_target, local_target;   // the counters after this call
  int flags;                       // kFlag*
};

__device__ __forceinline__ unsigned* barrier_word(const PeerTable& t, int rank) {
  return t.signal[rank];
}

__device__ __forceinline__ unsigned* slot_word(const PeerTable& t, int rank, int slot) {
  return t.signal[rank] + 1 + slot;
}

__device__ __forceinline__ unsigned* local_word(const PeerTable& t, int rank) {
  return t.signal[rank] + 1 + t.sem_slots;
}

__device__ __forceinline__ void signal_relaxed(unsigned* word) {
  asm volatile("red.relaxed.sys.global.add.u32 [%0], %1;" ::"l"(word), "r"(1u) : "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* word) {
  unsigned v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void timed_out(const unsigned* word, unsigned target, int my,
                                          const char* what) {
  printf("fc peer wait timed out: rank %d block %d %s at %u < %u\n", my, blockIdx.x, what,
         load_relaxed(word), target);
  __trap();
}

// fence.acq_rel at the world's scope. Before a signal, with the relaxed
// add after it: a release of every store the block made before its
// __syncthreads(). After the relaxed loads of a wait that saw every
// signal it needs: an acquire of what those signals released.
__device__ __forceinline__ void fence_world(const PeerTable& t) {
  if (t.flags & kFlagOneCard) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  else asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ bool reached(const unsigned* word, unsigned target) {
  return (int)(load_relaxed(word) - target) >= 0;
}

// Spin (one thread) until the barrier (barrier), or the local slot and
// every receive slot (!barrier), of rank my have reached this call's
// targets: each poll loads all of them at once; then one fence.
__device__ __forceinline__ void peer_poll(const PeerTable& t, int my, bool barrier) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    bool done;
    if (barrier) {
      done = reached(barrier_word(t, my), t.bar_target);
    } else {
      done = reached(local_word(t, my), t.local_target);
      for (int s = 0; s < t.sem_slots; ++s) done &= reached(slot_word(t, my, s), t.slot_target);
    }
    if (done) break;
    if (global_ns() - t0 > kWaitNs)
      timed_out(barrier ? barrier_word(t, my) : local_word(t, my),
                barrier ? t.bar_target : t.local_target, my, barrier ? "barrier" : "slots");
  }
  fence_world(t);
}

// The ring barrier: every block of rank my signals the barrier of each
// peer at (my + off) % tp, then waits until its own barrier has every
// peer's signals of this call. After it, every peer has entered this
// call, so (stream order) its last call has ended, and with it every
// read of its receive buffers.
__device__ __forceinline__ void peer_barrier(const PeerTable& t, int my) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < t.n_signal; ++i)
      signal_relaxed(barrier_word(t, (my + t.signal_off[i]) % t.tp));
    peer_poll(t, my, true);
  }
  __syncthreads();
}

// After the block's pushes: one fence, then each push step's slot at its
// peer and the rank's local slot.
__device__ __forceinline__ void peer_signal(const PeerTable& t, int my) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_world(t);
    for (int i = 0; i < t.n_push; ++i)
      signal_relaxed(slot_word(t, (my + t.push_dst_off[i]) % t.tp, t.push_recv_slot[i]));
    signal_relaxed(local_word(t, my));
  }
}

// Wait until every block of the rank has pushed (the local slot) and
// every peer has pushed its rows here.
__device__ __forceinline__ void peer_wait(const PeerTable& t, int my) {
  if (threadIdx.x == 0) peer_poll(t, my, false);
  __syncthreads();
}

// The int64 peer argument of a peer-push kernel (repro_torch/kernels/
// rdma.py PeerWorld.table):
//   [tp, local_ranks, rank0, m, row_bytes, blocks_per_rank, in_kind,
//    sem_slots, n_signal, wait_count, n_push,
//    bar_target, slot_target, local_target, flags,
//    recv[kMaxPeers], signal[kMaxPeers], signal_off[kMaxPeers],
//    push_dst_off[kMaxPeers], push_recv_slot[kMaxPeers]]
// m is a kernel's own size argument; in_kind its payload type (0 f32,
// 1 bf16); the targets are u32 counters (mod 2^32).
constexpr int kPeerHead = 15;

struct PeerArgs {
  PeerTable t;
  long long m;
  int blocks_per_rank, in_kind;
};

// False for a table no launch can take.
inline bool read_peer(const long long* peer, PeerArgs& a) {
  PeerTable& t = a.t;
  t.tp = (int)peer[0];
  t.local_ranks = (int)peer[1];
  t.rank0 = (int)peer[2];
  a.m = peer[3];
  t.row_bytes = peer[4];
  a.blocks_per_rank = (int)peer[5];
  a.in_kind = (int)peer[6];
  t.sem_slots = (int)peer[7];
  t.n_signal = (int)peer[8];
  t.wait_count = (int)peer[9];
  t.n_push = (int)peer[10];
  t.bar_target = (unsigned)peer[11];
  t.slot_target = (unsigned)peer[12];
  t.local_target = (unsigned)peer[13];
  t.flags = (int)peer[14];
  if (t.tp < 1 || t.tp > kMaxPeers || a.blocks_per_rank < 1 || t.local_ranks < 1 ||
      t.n_signal > kMaxPeers || t.n_push > kMaxPeers)
    return false;
  const long long* tab = peer + kPeerHead;
  for (int i = 0; i < kMaxPeers; ++i) {
    t.recv[i] = reinterpret_cast<uint8_t*>(tab[i]);
    t.signal[i] = reinterpret_cast<unsigned*>(tab[kMaxPeers + i]);
    t.signal_off[i] = (int)tab[2 * kMaxPeers + i];
    t.push_dst_off[i] = (int)tab[3 * kMaxPeers + i];
    t.push_recv_slot[i] = (int)tab[4 * kMaxPeers + i];
  }
  return true;
}

}  // namespace fc
