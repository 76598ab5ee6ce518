// CRC32C (Castagnoli) of byte rows for Hopper (sm_90a): fc_crc32c.
//
// Replaces no Pallas TPU kernel. The JAX package computes the frame's
// CRC32C (src/repro/core/frame.py:122 crc32c_rows) with a byte-serial
// lax.scan; the port's training path runs it over the pod site's wire
// rows (some 270 MB a row at llama3-8b's embedding leaf), so it is a
// kernel here. Its plain version, the same chunks and the same combine
// in tensor ops, is repro_torch/kernels/crc.py crc32c_rows_plain.
//
// Bound on an H100: memory. The least time is the rows' bytes over
// 3.35 TB/s (8 bytes a row written).
//
// Design. The register is linear over GF(2): the register of A || B from
// zero is M^|B| reg(A) ^ reg(B), M^k the 32x32 operator of k zero bytes
// (built on the host, 32 words). A row of L bytes is left-padded with
// zero bytes to whole tiles of kTile bytes (leading zeros leave a register
// that starts from zero as it is), so every chunk and tile has one length:
//   crc_tiles: persistent blocks of kThreads threads walk the (row, tile)
//     pairs. A block stages the tile in shared memory (4-byte loads where
//     the row's address, pitch and length allow, else bytes; a chunk's
//     words at a stride of 17 so that the lanes' reads hit 32 banks),
//     then each thread runs its kChunk-byte chunk from zero through the
//     256-entry table, held 32 times over in shared memory (lane l reads
//     copy l: no bank conflicts), and shifts it to the tile's end by its
//     own M^((kThreads - 1 - c) kChunk), kept in registers for the whole
//     walk. The tile's register is the XOR of the chunks' (shuffles, then
//     the warps' four in shared memory).
//   crc_rows: a block a row. Its threads (a power of two up to 1024) take
//     per_thread consecutive tiles each, the row left-padded with zero
//     tiles, by Horner's rule (M^kTile), then a tree over the threads
//     (M^(kTile per_thread 2^k)); the result is XORed with the host
//     constant M^L init ^ 0xFFFFFFFF (init: the register of the bytes
//     before the row).
// Each thread makes kChunk dependent table lookups a tile; the tree and
// the shifts are 32-step GF(2) products (32 words each).
#include "codec.cuh"

namespace {

constexpr int kChunk = 64;                 // bytes a thread
constexpr int kThreads = 128;              // chunks a tile
constexpr int kTile = kChunk * kThreads;   // bytes a tile
constexpr int kStride = kChunk / 4 + 1;    // words between chunks in smem
constexpr int kRowLevels = 10;             // log2(1024)
constexpr unsigned kPoly = 0x82F63B78u;

struct RowOps {
  unsigned w[(kRowLevels + 1) * 32];       // M^kTile, then the tree's levels
};

__device__ __forceinline__ unsigned gf2_apply(const unsigned* op, unsigned v) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= op[i] & (0u - ((v >> i) & 1u));
  return r;
}

// Register of each (row, tile): M^kTile-aligned, from zero.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) crc_tiles(
    const uint8_t* __restrict__ src, unsigned* __restrict__ tile_regs,
    const unsigned* __restrict__ shift, long long rows, long long pitch, long long len,
    long long tiles, long long pad) {
  __shared__ unsigned tbl[256 * 32];
  __shared__ unsigned tile[kThreads * kStride];
  __shared__ unsigned part[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < 256; i += kThreads) {
    unsigned c = (unsigned)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
#pragma unroll
    for (int l = 0; l < 32; ++l) tbl[i * 32 + l] = c;
  }
  unsigned op[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) op[i] = shift[t * 32 + i];
  __syncthreads();
  const long long work = rows * tiles;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const long long row = w / tiles, tl = w - row * tiles;
    const uint8_t* base = src + row * pitch;
    const long long v0 = tl * kTile - pad;   // the row's byte at the tile's start
    if (kVec) {
      // word e of the tile: its bytes are all pad or all the row's
#pragma unroll
      for (int k = 0; k < kTile / 4 / kThreads; ++k) {
        const int e = t + k * kThreads;
        const long long b = v0 + 4LL * e;
        const unsigned v = b < 0 ? 0u : *(const unsigned*)(base + b);
        tile[(e / (kChunk / 4)) * kStride + e % (kChunk / 4)] = v;
      }
    } else {
      uint8_t* tb = (uint8_t*)tile;
#pragma unroll 4
      for (int k = 0; k < kTile / kThreads; ++k) {
        const int e = t + k * kThreads;
        const long long b = v0 + e;
        tb[(e / kChunk) * (kStride * 4) + e % kChunk] =
            (b < 0 || b >= len) ? (uint8_t)0 : base[b];
      }
    }
    __syncthreads();
    unsigned reg = 0;
    const unsigned* mine = tile + t * kStride;
#pragma unroll
    for (int k = 0; k < kChunk / 4; ++k) {
      unsigned d = mine[k];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        reg = (reg >> 8) ^ tbl[((reg ^ d) & 0xFFu) * 32 + lane];
        d >>= 8;
      }
    }
    reg = gf2_apply(op, reg);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) reg ^= __shfl_xor_sync(fc::kFull, reg, o);
    if (lane == 0) part[warp] = reg;
    __syncthreads();
    if (t == 0) {
      unsigned r = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) r ^= part[i];
      tile_regs[w] = r;
    }
  }
}

// Each row's CRC from its tiles' registers.
__global__ void __launch_bounds__(1024) crc_rows(
    const unsigned* __restrict__ tile_regs, long long* __restrict__ out, long long tiles,
    int per_thread, unsigned cnst, RowOps ops) {
  __shared__ unsigned sops[(kRowLevels + 1) * 32];
  __shared__ unsigned red[1024];
  const int t = threadIdx.x, n = blockDim.x;
  if (t == 0) {   // constant offsets into the parameter: no local copy
#pragma unroll
    for (int i = 0; i < (kRowLevels + 1) * 32; ++i) sops[i] = ops.w[i];
  }
  __syncthreads();
  const long long row = blockIdx.x;
  const long long lead = (long long)n * per_thread - tiles;   // zero tiles first
  unsigned acc = 0;
  for (int i = 0; i < per_thread; ++i) {
    const long long vt = (long long)t * per_thread + i - lead;
    acc = gf2_apply(sops, acc) ^ (vt < 0 ? 0u : tile_regs[row * tiles + vt]);
  }
  red[t] = acc;
  __syncthreads();
  for (int lv = 1, st = 1; st < n; ++lv, st *= 2) {
    if (t % (2 * st) == 0) red[t] = gf2_apply(sops + lv * 32, red[t]) ^ red[t + st];
    __syncthreads();
  }
  if (t == 0) out[row] = (long long)(red[0] ^ cnst);
}

// The shift operators, on each card once (one copy of the runtime a
// library, so one table a process and card).
__device__ unsigned g_shift[kThreads * 32];

int shift_ready(const unsigned* host, cudaStream_t st) {
  static bool ready[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (ready[dev]) return 0;
  const cudaError_t e = cudaMemcpyToSymbolAsync(g_shift, host, sizeof(g_shift), 0,
                                                cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  ready[dev] = true;
  return 0;
}

}  // namespace

extern "C" {

// params: rows, pitch, len, tiles, pad, row_threads, per_thread, cnst;
// ops: kThreads shift operators, then M^kTile and the row tree's levels
// (32 words each). tile_regs: rows x tiles words of scratch.
int fc_crc32c(const void* src, void* tile_regs, void* out, const long long* params,
              const unsigned* ops, void* stream) {
  const long long rows = params[0], pitch = params[1], len = params[2], tiles = params[3],
                  pad = params[4];
  const int row_threads = (int)params[5], per_thread = (int)params[6];
  const unsigned cnst = (unsigned)params[7];
  if (rows == 0 || len == 0) return 0;
  if (row_threads < 1 || row_threads > 1024 || (row_threads & (row_threads - 1)) ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (const int rc = fc::use_device_of(src)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (const int rc = shift_ready(ops, st)) return rc;
  const unsigned* shift = nullptr;
  if (cudaGetSymbolAddress((void**)&shift, g_shift) != cudaSuccess) return (int)cudaGetLastError();
  const bool vec = ((uintptr_t)src % 4 == 0) && (pitch % 4 == 0) && (len % 4 == 0);
  int occ = 0;
  const cudaError_t e = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, crc_tiles<true>, kThreads, 0)
                            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, crc_tiles<false>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long want = (long long)fc::sm_count() * (occ > 0 ? occ : 1);
  const unsigned blocks = (unsigned)(rows * tiles < want ? rows * tiles : want);
  const uint8_t* s = (const uint8_t*)src;
  unsigned* regs = (unsigned*)tile_regs;
  if (vec)
    crc_tiles<true><<<blocks, kThreads, 0, st>>>(s, regs, shift, rows, pitch, len, tiles, pad);
  else
    crc_tiles<false><<<blocks, kThreads, 0, st>>>(s, regs, shift, rows, pitch, len, tiles, pad);
  if (const cudaError_t le = cudaGetLastError()) return (int)le;
  RowOps rops;
  for (int i = 0; i < (kRowLevels + 1) * 32; ++i) rops.w[i] = ops[kThreads * 32 + i];
  crc_rows<<<(unsigned)rows, row_threads, 0, st>>>(regs, (long long*)out, tiles, per_thread,
                                                   cnst, rops);
  return (int)cudaGetLastError();
}

}  // extern "C"
