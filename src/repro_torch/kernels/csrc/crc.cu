// CRC32C (Castagnoli) of byte rows for Hopper (sm_90a): fc_crc32c.
//
// Replaces no Pallas TPU kernel. The JAX package computes the frame's
// CRC32C (src/repro/core/frame.py:122 crc32c_rows) with a byte-serial
// lax.scan; the port's training path runs it over the pod site's wire
// rows (some 270 MB a row at llama3-8b's embedding leaf), so it is a
// kernel here. Its plain version, the same chunks, chains and combine in
// tensor ops, is repro_torch/kernels/crc.py crc32c_rows_plain.
//
// Bound on an H100: memory. The least time is the rows' bytes over
// 3.35 TB/s (8 bytes a row written).
//
// Design. The register is linear over GF(2): the register of A || B from
// zero is M^|B| reg(A) ^ reg(B), M^k the 32x32 operator of k zero bytes
// (built on the host, 32 words). A row of L bytes is left-padded with
// zero bytes to whole tiles of kTile bytes (leading zeros leave a register
// that starts from zero as it is). A tile is kChunks chunks of kChunk = 68
// bytes: 17 words, an odd count, so the 32 lanes that read word j of 32
// neighbouring chunks hit 32 banks in the tile's plain layout.
//   crc_tiles: one persistent block an SM takes a contiguous run of the
//     rows' (row, tile) pairs, row-major: a segment of each row it meets.
//     An elected lane of its producer warp feeds a ring of kStages tiles
//     in shared memory with 1-D bulk copies (cp.async.bulk; an mbarrier a
//     stage counts the bytes, another counts the consumers done with it),
//     so a tile's lookups run while the next tiles load. A bulk copy takes
//     16-byte-aligned addresses and sizes: tile 0 copies the row's bytes
//     only, and its pad is read as zeros. Each of kThreads consumer
//     threads runs kChains independent chains, chain k on chunk
//     k kThreads + t of every tile; a chain goes on from tile to tile:
//     its register is carried over the bytes between its chunks by
//     M^(kTile - kChunk) (four 256-entry tables in shared memory, one a
//     byte of the register), then takes its chunk through the 256-entry
//     table, held once a lane (lane l reads copy l: no bank conflicts).
//     At a segment's end each chain is shifted to the tile's end by its
//     own M^((kChunks - 1 - c) kChunk) and the block XORs them.
//   crc_rows: a block a row XORs its segments' registers, each shifted to
//     the row's end by M^(z kTile) for the z tiles after it (a product of
//     the host's M^(2^j kTile), copied to shared memory), and M^L init ^
//     0xFFFFFFFF, a host constant (init: the register of the bytes
//     before the row).
// Rows whose address, pitch and length are not all multiples of 16 take
// the same kernel without the ring: the consumers load each tile a byte a
// thread, then read it.
// A step of a chain is one table lookup (LDS) and four integer operations;
// the shifts cost 32-step GF(2) products once a segment. A barrier wait
// of more than 5 s (a copy that never lands) traps rather than hang.
#include <stdio.h>

#include "codec.cuh"

namespace {

constexpr int kChunk = 68;                 // bytes a chunk: 17 words
constexpr int kWords = kChunk / 4;
constexpr int kThreads = 256;              // consumer threads a block
constexpr int kChains = 4;                 // chunks a consumer thread
constexpr int kChunks = kThreads * kChains;
constexpr int kTile = kChunk * kChunks;    // bytes a tile
constexpr int kStages = 2;                 // tiles in the ring
constexpr int kBlock = kThreads + 32;      // and the producer warp
constexpr int kPowers = 32;                // M^(2^j kTile), j < 32
constexpr unsigned kPoly = 0x82F63B78u;
// The host's constants: word i of chunk c's shift at i * kChunks + c, then
// the advance's four byte tables, then the row pass's powers.
constexpr int kAdvOff = 32 * kChunks;
constexpr int kPowOff = kAdvOff + 4 * 256;
constexpr int kConstWords = kPowOff + 32 * kPowers;
// Dynamic shared memory (bytes): the ring, the table (32 copies), the
// advance's tables, the warps' parts, the barriers.
constexpr int kTblOff = kStages * kTile;
constexpr int kAdvSmem = kTblOff + 256 * 32 * 4;
constexpr int kPartOff = kAdvSmem + 4 * 256 * 4;
constexpr int kBarOff = kPartOff + 32 * 4;
constexpr int kSmem = kBarOff + 2 * kStages * 8;
static_assert(kWords % 2 == 1 && kTile % 16 == 0 && kBarOff % 8 == 0, "layout");

__device__ unsigned g_const[kConstWords];

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_done(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the phase of parity `parity` of the barrier has completed; a wait
// of more than 5 s is a fault (a copy that never lands), and traps.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  if (mbar_done(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_done(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 5000000000ULL) {
      printf("fc_crc32c: barrier wait timed out in block %d\n", blockIdx.x);
      __trap();
    }
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The consumer threads only (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// op: 32 words at a stride of `stride`.
__device__ __forceinline__ unsigned gf2_apply(const unsigned* op, int stride, unsigned v) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= op[i * stride] & (0u - ((v >> i) & 1u));
  return r;
}

// M^(kTile - kChunk) v: one table a byte of v.
__device__ __forceinline__ unsigned advance(const unsigned* adv, unsigned v) {
  return adv[v & 0xFFu] ^ adv[256 + ((v >> 8) & 0xFFu)] ^ adv[512 + ((v >> 16) & 0xFFu)] ^
         adv[768 + (v >> 24)];
}

// Each chain takes its chunk of the tile; with kPad, the words of the
// tile's first `pad` bytes read as zeros (the ring leaves them unwritten).
template <bool kPad>
__device__ __forceinline__ void take(unsigned (&reg)[kChains], const unsigned* tile,
                                     const unsigned* lut, int t, long long pad) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const int e = (k * kThreads + t) * kWords + j;
      reg[k] ^= (kPad && 4LL * e < pad) ? 0u : tile[e];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) reg[k] = (reg[k] >> 8) ^ lut[(reg[k] & 0xFFu) * 32];
    }
  }
}

// Register of each segment (the part of a row in this block's run of
// tiles), shifted to the end of its last tile, at seg_regs[block + row].
template <bool kRing>
__global__ void __launch_bounds__(kBlock, 1) crc_tiles(
    const uint8_t* __restrict__ src, unsigned* __restrict__ seg_regs, long long pitch,
    long long tiles, long long pad, long long work) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* tbl = (unsigned*)(smem + kTblOff);
  unsigned* adv = (unsigned*)(smem + kAdvSmem);
  unsigned* part = (unsigned*)(smem + kPartOff);
  unsigned long long* full = (unsigned long long*)(smem + kBarOff);
  unsigned long long* empty = full + kStages;
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < 256; i += kBlock) {
    unsigned c = (unsigned)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
#pragma unroll
    for (int l = 0; l < 32; ++l) tbl[i * 32 + l] = c;
  }
  for (int i = t; i < 4 * 256; i += kBlock) adv[i] = g_const[kAdvOff + i];
  if (kRing && t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * work / gridDim.x;
  const long long hi = (long long)(blockIdx.x + 1) * work / gridDim.x;

  if (t >= kThreads) {   // the producer warp
    if constexpr (kRing) {
      if (lane != 0) return;
      for (long long w = lo, i = 0; w < hi; ++w, ++i) {
        const int s = (int)(i % kStages);
        if (i >= kStages) mbar_wait(&empty[s], (unsigned)((i / kStages - 1) & 1));
        const long long row = w / tiles, tl = w - row * tiles;
        const unsigned off = tl == 0 ? (unsigned)pad : 0u;   // tile 0: the row's bytes only
        mbar_expect_tx(&full[s], kTile - off);
        bulk_load(smem + s * kTile + off, src + row * pitch + tl * kTile - pad + off,
                  kTile - off, &full[s]);
      }
    }
    return;
  }

  unsigned reg[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) reg[k] = 0;
  const unsigned* lut = tbl + lane;
  for (long long w = lo, i = 0; w < hi; ++w, ++i) {
    const int s = kRing ? (int)(i % kStages) : 0;
    const long long row = w / tiles, tl = w - row * tiles;
    unsigned char* stage = smem + s * kTile;
    if (kRing) {
      mbar_wait(&full[s], (unsigned)((i / kStages) & 1));
    } else {
      consumers_sync();   // the last tile's reads are done
      const uint8_t* base = src + row * pitch;
      const long long v0 = tl * kTile - pad;   // the row's byte at the tile's start
#pragma unroll 8
      for (int e = t; e < kTile; e += kThreads) {
        const long long b = v0 + e;
        stage[e] = b < 0 ? (uint8_t)0 : base[b];
      }
      consumers_sync();
    }
    // each chain over the bytes between its last chunk and this one
#pragma unroll
    for (int k = 0; k < kChains; ++k) reg[k] = advance(adv, reg[k]);
    if (kRing && tl == 0 && pad > 0)
      take<true>(reg, (const unsigned*)stage, lut, t, pad);
    else
      take<false>(reg, (const unsigned*)stage, lut, t, pad);
    if (kRing) mbar_arrive(&empty[s]);
    if (tl == tiles - 1 || w == hi - 1) {   // the segment's end
      unsigned r = 0;
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        r ^= gf2_apply(g_const + k * kThreads + t, kChunks, reg[k]);
        reg[k] = 0;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) r ^= __shfl_xor_sync(fc::kFull, r, o);
      if (lane == 0) part[t >> 5] = r;
      consumers_sync();
      if (t == 0) {
        unsigned x = 0;
#pragma unroll
        for (int q = 0; q < kThreads / 32; ++q) x ^= part[q];
        seg_regs[blockIdx.x + row] = x;
      }
      consumers_sync();   // part is free again
    }
  }
}

// Each row's CRC from its segments' registers.
__global__ void __launch_bounds__(128) crc_rows(const unsigned* __restrict__ seg_regs,
                                                long long* __restrict__ out, long long tiles,
                                                long long work, int blocks, unsigned cnst) {
  __shared__ unsigned powers[32 * kPowers];
  __shared__ unsigned part[4];
  const int t = threadIdx.x;
  for (int i = t; i < 32 * kPowers; i += blockDim.x) powers[i] = g_const[kPowOff + i];
  __syncthreads();
  const long long row = blockIdx.x, first = row * tiles, last = first + tiles;
  unsigned acc = 0;
  for (int b = t; b < blocks; b += blockDim.x) {
    const long long lo = (long long)b * work / blocks, hi = (long long)(b + 1) * work / blocks;
    if (lo >= last || hi <= first) continue;
    unsigned v = seg_regs[b + row];
    long long z = last - (hi < last ? hi : last);   // tiles after the segment
    for (int j = 0; z; ++j, z >>= 1)
      if (z & 1) v = gf2_apply(powers + 32 * j, 1, v);
    acc ^= v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(fc::kFull, acc, o);
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  if (t == 0) out[row] = (long long)(part[0] ^ part[1] ^ part[2] ^ part[3] ^ cnst);
}

// The constants, and the grid, on each card once (one copy of the runtime
// a library, so one a process and card).
int blocks_ready(const unsigned* host, cudaStream_t st) {
  static int blocks[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (blocks[dev]) return blocks[dev];
  cudaError_t e = cudaMemcpyToSymbolAsync(g_const, host, sizeof(g_const), 0,
                                          cudaMemcpyHostToDevice, st);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc_tiles<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc_tiles<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int occ = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, crc_tiles<true>, kBlock, kSmem);
  if (e != cudaSuccess) return -(int)e;
  if (occ < 1) return -(int)cudaErrorInvalidConfiguration;
  blocks[dev] = fc::sm_count() * occ;
  return blocks[dev];
}

}  // namespace

extern "C" {

// params: rows, pitch, len, tiles, pad, cnst, ring (0 | 1), scratch words;
// consts: kConstWords host-built words (see kAdvOff, kPowOff). scratch:
// a word a (block, row) segment, blocks + rows words at most.
int fc_crc32c(const void* src, void* scratch, void* out, const long long* params,
              const unsigned* consts, void* stream) {
  const long long rows = params[0], pitch = params[1], len = params[2], tiles = params[3],
                  pad = params[4], ring = params[6], scratch_words = params[7];
  const unsigned cnst = (unsigned)params[5];
  if (rows == 0 || len == 0) return 0;
  if (rows < 0 || rows > 0x7fffffffLL || len < 0 || tiles != (len + kTile - 1) / kTile ||
      pad != tiles * kTile - len || scratch_words <= rows)
    return (int)cudaErrorInvalidValue;
  if (ring && ((uintptr_t)src % 16 || pitch % 16 || len % 16)) return (int)cudaErrorInvalidValue;
  if (const int rc = fc::use_device_of(src)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const int most = blocks_ready(consts, st);
  if (most < 0) return -most;
  const long long work = rows * tiles;
  long long blocks = work < most ? work : most;
  if (blocks > scratch_words - rows) blocks = scratch_words - rows;
  const uint8_t* s = (const uint8_t*)src;
  unsigned* segs = (unsigned*)scratch;
  if (ring)
    crc_tiles<true><<<(unsigned)blocks, kBlock, kSmem, st>>>(s, segs, pitch, tiles, pad, work);
  else
    crc_tiles<false><<<(unsigned)blocks, kBlock, kSmem, st>>>(s, segs, pitch, tiles, pad, work);
  if (const cudaError_t le = cudaGetLastError()) return (int)le;
  crc_rows<<<(unsigned)rows, 128, 0, st>>>(segs, (long long*)out, tiles, work, (int)blocks, cnst);
  return (int)cudaGetLastError();
}

// Every instantiation's attributes (repro_torch/analysis/smem.py
// INSTANCES order: the ring's and the synchronous path's tiles, then the
// rows) -> the count.
int fc_crc_attrs(int* out, int cap) {
  int k = 0;
  FC_ATTRS(crc_tiles<true>);
  FC_ATTRS(crc_tiles<false>);
  FC_ATTRS(crc_rows);
  return k;
}

}  // extern "C"
