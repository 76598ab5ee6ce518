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
// Counters only grow. Every block of a rank signals once per call, so
// after call number `epoch` (1, 2, ...) a peer's slot holds epoch *
// blocks_per_rank and the barrier epoch * wait_count * blocks_per_rank:
// the waits compare against those, and no pad is ever reset.
//
// Ordering: a block's stores, then __syncthreads(), then one thread's
// __threadfence_system() and red.release.sys on the destination's pad;
// the waiting thread's ld.acquire.sys, then __syncthreads() before the
// block reads what the signal covers (through L2: LoadL2 in codec.cuh).
// A wait that outlasts kWaitNs traps, so a fault cannot hang the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace fc {

constexpr int kMaxPeers = 16;
constexpr unsigned long long kWaitNs = 5000000000ull;   // 5 s

struct PeerTable {
  uint8_t* recv[kMaxPeers];        // each rank's receive buffer
  unsigned* signal[kMaxPeers];     // each rank's signal pad
  long long row_bytes;             // stride of a receive row
  int tp, local_ranks, rank0;      // ranks; this launch runs rank0 + blockIdx.y
  int sem_slots;
  int n_signal;                    // barrier: signal (my + off) % tp for each off
  int signal_off[kMaxPeers];
  int wait_count;                  // barrier: signals to wait for (per block of a peer)
  int n_push;                      // push step i: peer (my + dst_off[i]) % tp, its slot recv_slot[i]
  int push_dst_off[kMaxPeers];
  int push_recv_slot[kMaxPeers];
  unsigned epoch;                  // this call's number, from 1
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

__device__ __forceinline__ void signal_release(unsigned* word) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(word), "r"(1u) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* word) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *word has reached target (wrap-safe).
__device__ __forceinline__ void wait_until(const unsigned* word, unsigned target, int my,
                                           const char* what) {
  const unsigned long long t0 = global_ns();
  while ((int)(load_acquire(word) - target) < 0) {
    __nanosleep(100);
    if (global_ns() - t0 > kWaitNs) {
      printf("fc peer wait timed out: rank %d block %d %s at %u < %u\n", my, blockIdx.x, what,
             load_acquire(word), target);
      __trap();
    }
  }
}

// The ring barrier: every block of rank my signals the barrier of each
// peer at (my + off) % tp, then waits until its own barrier has every
// peer block's signal of this call. After it, every peer has entered this
// call, so it has finished reading its receive buffer in the last one.
__device__ __forceinline__ void ring_barrier(const PeerTable& t, int my) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < t.n_signal; ++i)
      signal_release(barrier_word(t, (my + t.signal_off[i]) % t.tp));
    wait_until(barrier_word(t, my), t.epoch * (unsigned)(t.wait_count * gridDim.x), my,
               "barrier");
  }
  __syncthreads();
}

// After the block's pushes: signal each push step's slot at its peer, and
// the rank's local slot (its own block, spliced in locally).
__device__ __forceinline__ void signal_pushes(const PeerTable& t, int my) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int i = 0; i < t.n_push; ++i)
      signal_release(slot_word(t, (my + t.push_dst_off[i]) % t.tp, t.push_recv_slot[i]));
    signal_release(local_word(t, my));
  }
}

// Wait until every block of every rank has pushed its rows here.
__device__ __forceinline__ void wait_pushes(const PeerTable& t, int my) {
  if (threadIdx.x == 0) {
    const unsigned target = t.epoch * gridDim.x;
    for (int s = 0; s < t.sem_slots; ++s) wait_until(slot_word(t, my, s), target, my, "slot");
    wait_until(local_word(t, my), target, my, "local");
    __threadfence();
  }
  __syncthreads();
}

// The int64 peer argument of a peer-push kernel (repro_torch/kernels/
// rdma.py PeerWorld.table):
//   [tp, local_ranks, rank0, m, row_bytes, epoch, blocks_per_rank, in_kind,
//    sem_slots, n_signal, wait_count, n_push,
//    recv[kMaxPeers], signal[kMaxPeers], signal_off[kMaxPeers],
//    push_dst_off[kMaxPeers], push_recv_slot[kMaxPeers]]
// m is a kernel's own size argument; in_kind its payload type (0 f32,
// 1 bf16).
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
  t.epoch = (unsigned)peer[5];
  a.blocks_per_rank = (int)peer[6];
  a.in_kind = (int)peer[7];
  t.sem_slots = (int)peer[8];
  t.n_signal = (int)peer[9];
  t.wait_count = (int)peer[10];
  t.n_push = (int)peer[11];
  if (t.tp < 1 || t.tp > kMaxPeers || a.blocks_per_rank < 1 || t.local_ranks < 1 ||
      t.n_signal > kMaxPeers || t.n_push > kMaxPeers)
    return false;
  const long long* tab = peer + 12;
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
