// The flat-BPE pass's ablations with the parity scan run block by block,
// and a block-local parity scan of a bare match mask:
//   T6's scan16 and swarpack (segment_scan),
//   T10's noscan2 (row_scan_kernel),
//   T12's scan in int32 and in bf16x2 (mask_scan).
//
// Replaces: tools/exp_scan.py::_pallas (kernel body _variant_body) for
// scan16 and swarpack; tools/exp_chd.py::chain (body make_kernel) for
// noscan2; tools/exp_bf16scan.py::chain (bodies _scan_i32_kernel and
// _scan_bf16_kernel). T6's other four variants and T10's prod and novalid
// are flag sets of the flat pass, blt_flat_pass (flat_bpe.cu).
//
// scan16, swarpack and noscan2 take K2's arguments and the dense wire table
// in place of the tools' CHD probe (the same function: the pre-byteswapped
// rule value or no rule), emit values unswapped (as K2) and write
// carry_out = start[n-1] (carry_in when n == 0):
//   scan16:     start = m && ((i & 1) ^ p), p the parity of the last
//               non-match at or before i within i's block of rpb rows, 1 if
//               there is none: full's function except where a block opens
//               with a run of matches after a start (the tool's 16-bit row
//               scan keeps no carry between blocks);
//   swarpack:   the tool's SWAR-packed scan. In each block, row pair
//               (2q, 2q+1) is packed as code_2q | code_2q+1 << 16 per lane,
//               code = m ? 0 : (lane+1)*2 + (lane & 1); 7 Hillis-Steele
//               steps s = (s & k) | (c & ~k), c = s at lane - sh (0 below
//               sh), g = ((s | 0x80008000) - c) & 0x80008000,
//               k = (g - (g >> 15)) | g, all in int32 (>> arithmetic). Row r
//               then reads field f of packed row r mod (rpb/2): the low half
//               for r < rpb/2, the high half after (the tool's
//               concatenate([se, so])); p = f & 1 where f > 0, else the
//               parity of the last non-match in the earlier rows of the
//               block (1 if none); start = m && ((i & 1) ^ p). The tool's
//               docstring calls this deliberately approximate; this is
//               exactly what it computes.
//   noscan2:    the scan's first phase alone: lz = max(the last non-match
//               at or before i within i's 128-byte row, s - 1 - c), s the
//               first position of i's block of rpb rows and c the block's
//               carry; start = m && ((i - lz) & 1). A block's carry is the
//               previous block's start at its last position (min(block end,
//               n - 1)), the call's carry_in for block 0, and passes
//               through a block with no position below n: the Pallas grid's
//               SMEM carry, a true chain from block to block.
// In scan16 and swarpack consumed = start[i-1], or carry_in at i == 0; in
// noscan2 consumed at a block's first position is the block's carry. The
// next byte of a block's last position is the next block's first byte.
//
// mask_scan (T12) takes a u8 mask of whole blocks of rpb rows x 128 and
// writes u8 starts: per block, start = m && ((i - lz) & 1), lz the last
// zero of the mask at or before i within the block, -1 if none (a
// block-local scan with carry 0; blocks are even-sized, so i's parity is its
// lane's, and "none" acts as a zero just before the block). The int32 and
// bf16 variants compute this one function and share every step but the lane
// scan inside a thread: bf16 runs it on lane indices (-1..127, exact in
// bf16) two lanes to a 32-bit register with __hmax2, the card's analogue of
// the tool's question whether 16-bit values packed two to a lane scan
// faster; int32 runs scan_starts.
//
// Bound on the H100: the bytes. The flat variants read 1 byte and write 2
// bytes of slots per position plus the 128 KB table (192 MiB at 64 MiB,
// about 60 us at 3.35 TB/s); mask_scan reads 1 and writes 1 (128 MiB at
// 64 MiB, about 40 us).
//
// Design of scan16 and swarpack (segment_scan, their Hopper design): one
// launch after one cudaMemsetAsync of the jobs' flags and a ticket. A job is
// whole segments (a segment: a block of rpb rows, rpb x 128 positions), as
// many as fit in a 4096-position tile and at least one (jobs_of); a CTA of
// 256 threads takes one job from the ticket and streams its tiles in order
// through two stages of kTile + 16 bytes in shared memory, each filled by
// one bulk copy (cp.async.bulk onto the stage's mbarrier, bulk.cuh) two
// tiles ahead of the tile being scanned. Each thread owns 16 consecutive
// positions of a tile, as K2 does:
//   scan16: the tile's pairs looked up once into registers, the exclusive
//   max across the tile's threads, and lz = max(that, the running max of the
//   job's earlier tiles, s - 1 for the segment start s at or before the
//   thread): K2's max-scan with the reset at every segment start; then the
//   slots from registers with 16-byte stores. No look-back: a segment never
//   leaves its CTA.
//   swarpack: pass 1 keeps the job's match bits in shared memory (2 bytes a
//   16 positions) and each row's parity of the last non-match before it in
//   its segment (a byte a row); then 8 threads a row pair run the SWAR steps
//   of rows 2q and 2q + 1 once, giving row q its low fields and row
//   q + rpb/2 its high fields, and keep the start bits (2 bytes a 16
//   positions; 33 KiB in all at rpb 1024); pass 2 streams the tiles again
//   and looks up each start's pair for its value.
// consumed at a job's first position is the previous job's last start: a
// job publishes its own in its flag word (2 | start) as soon as it knows it,
// and only then waits for its predecessor's to fix its first slot; the
// predecessor holds an earlier ticket, so it has started and the wait ends.
// The flags and ticket are reset on the stream, so a captured chain replays.
// tools_cuda.block_scan_plan mirrors the jobs; tests/test_torch_segment_scan.py
// plays the protocol on the host.
// What holds them (an H100 80GB HBM3 at 700 W, exp_scan at 64 MiB chained
// 64, PERF.md): at rpb 1024 scan16 takes 0.142-0.145 ms and swarpack
// 0.329-0.334 against the bytes' 0.060 (the two-launch design before them
// 0.394-0.397 and 0.595-0.602). A 64 MiB batch holds 512 jobs of 32 tiles,
// under 4 an SM, each walking its tiles one after another: latency and
// issue, not bytes, bound a step (K2's pass without its scan, a tile a CTA
// at 8 CTAs an SM, takes 0.091). swarpack adds its SWAR steps (7 steps of
// 16 lanes a thread a row pair) and its second pass.
//
// Design of noscan2 (T10's Hopper design): one launch after one
// cudaMemsetAsync of the blocks' flags and a ticket. A CTA of 8 data warps
// and a control warp takes a tile of kRowScanUnroll sub-tiles of kTile
// positions from the ticket; each data thread owns 16 consecutive positions
// of each sub-tile: one 16-byte load (the byte after them from the next
// lane), each pair looked up once into registers (staged_pairs). A row is
// 8 threads, so the row's last non-match before a thread is an 8-lane
// shuffle maximum. The starts depend on the block's carry c only through
// the sentinel s - 1 - c, so each thread computes them for c = 0 and for
// c = 1 at once, bit-parallel (parity_starts), and waits for the carry only
// after every load and lookup. A block's carry out is its start at
// last_pos = min(block end, n - 1), a function of its carry in given by two
// bits, its map (bit c: the start there for carry c); a block wholly past n
// passes its carry (every CTA knows n, so no flag stands for it). The
// thread that holds a block's last_pos publishes the map in the block's
// flag (4 | map) at once; the control warp publishes the carry out (8 |
// carry) once it knows the carry in. Meanwhile the control warp finds the
// carry into the tile's first block: the maps of the kLocalMaps nearest
// blocks before it it computes itself from their last rows (8 lanes a
// row), so it waits on no flag of a tile just started, and the carry into
// the oldest of them is a look-back over the flags before it, 32 at a
// read, nearest first, composing maps (K3's non-commuting composition, on
// functions of one bit) until a flag holds a carry or the walk passes block
// 0 (carry_in); the tile's later blocks (rpb 8 and 16 put 8 and 4 in a
// tile) take the maps composed inside the tile. consumed at a thread's
// first position is the start before it: from the lane before, the warp or
// sub-tile before (shared memory), or, for the tile's first position inside
// a block, the previous row's last, which the control warp's other 8 lanes
// compute from that row's bytes. Slots leave by 16-byte stores. A CTA waits
// only on lower tickets, whose CTAs have started and publish before they
// wait; the memset puts the flags back on the stream, so a captured chain
// replays. tools_cuda.row_scan_plan mirrors the grid and the scratch;
// tests/test_torch_row_scan.py plays the protocol on the host. On an H100
// 80GB HBM3 at 700 W (PERF.md, exp_chd at 64 MiB, rpb 1024) it takes 0.135
// ms against the three-launch design's 0.315 and the bytes' 0.060;
// kRowScanUnroll 2 beat 1 and 4, more CTAs an SM (launch bounds) ran
// slower, and a persistent grid that fetched its next tile by bulk copy
// ran 0.162.
//
// Design of mask_scan (T12's Hopper design): one launch after one
// cudaMemsetAsync of the tiles' status words and a ticket. The grid is of
// tiles, not of blocks: a CTA of 256 threads takes a tile of kMaskTile
// positions from the ticket, and each thread owns one group of 16
// consecutive positions in each of the tile's kMaskUnroll sub-tiles of 4096,
// every load and store a coalesced 16-byte vector, all loads issued before
// any is used. A block's start s is a sentinel, a zero at s - 1, so the
// scan never needs to know where blocks end: within a thread scan_starts
// (or the bf16 lane scan), across the tile the exclusive maximum over the
// sub-tiles in order (a warp scan each, one barrier, the warps' totals),
// across tiles max_lookback.cuh's decoupled look-back. Only a last zero's
// parity matters, so a tile publishes one bit, the parity of its last zero
// or sentinel (or an aggregate when it holds neither), and positions need
// only tile-local indices: any size the wrapper takes. A tile that opens a
// block needs no carry: it publishes at once and walks nowhere, so no
// look-back crosses a block's start. The memset puts the status words back
// on the stream, so a captured chain replays. tools_cuda.mask_scan_plan
// mirrors the grid; tests/test_torch_mask_scan.py plays the protocol on the
// host.

#include <cuda_bf16.h>

#include "bulk.cuh"
#include "flat_pass.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

// The tool's 9-bit code of lane l (bit 0 of nib: its match bit): 0 at a
// match, else (l + 1) * 2 + (l & 1).
__device__ __forceinline__ uint32_t code_of(uint32_t nib, int l) {
  return (nib & 1u) ? 0u : (uint32_t)((l + 1) * 2 + (l & 1));
}

// One SWAR max step of the tool: s = (s & k) | (c & ~k).
__device__ __forceinline__ uint32_t swar_step(uint32_t s, uint32_t c) {
  const uint32_t guard = 0x80008000u;
  uint32_t g = ((s | guard) - c) & guard;
  uint32_t k = (g - (uint32_t)((int)g >> 15)) | g;
  return (s & k) | (c & ~k);
}

// --- T6 scan16, swarpack: one launch, segments streamed per CTA ----------

constexpr int kSegThreads = 256;              // threads of a segment_scan CTA
constexpr int kSegTile = kSegThreads * kPer;  // positions of its tile
constexpr int kSegWarps = kSegThreads / 32;

// A launch's work: a job is whole segments of rpb x 128 positions, as many
// as fit in a tile (at least one), taken by one CTA from a ticket; the last
// job of a buffer may hold fewer segments. tools_cuda.block_scan_plan
// mirrors this.
struct Jobs {
  int seg;    // positions of a segment, rpb * 128
  int job;    // positions of a job: max(1, kSegTile / seg) segments
  int count;  // jobs, ceil(cap / job)
};

inline Jobs jobs_of(int cap, int rpb) {
  Jobs j;
  j.seg = rpb * 128;
  j.job = (kSegTile / j.seg > 1 ? kSegTile / j.seg : 1) * j.seg;
  j.count = (cap + j.job - 1) / j.job;
  return j;
}

constexpr int kStageBytes = kSegTile + kPer;  // a tile's bytes and the 16 after it
constexpr int kStages = 2;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kBitsOffset = kBarOffset + 16;  // swarpack's bits after the barriers
static_assert(kStageBytes % 16 == 0, "bulk copies move multiples of 16 bytes");

constexpr int kMaxSegment = 1024 * 128;  // positions of a segment at the largest rpb

// Dynamic shared memory of segment_scan: the ring of two tile stages and
// their barriers; swarpack adds a job's match bits and start bits (a u16
// per 16 positions each) and one parity byte a row.
inline int segment_smem(bool swar, int job) {
  return kBitsOffset + (swar ? 2 * (job / kPer) * 2 + job / 128 : 0);
}

// Byte k of a thread's 16 staged bytes.
__device__ __forceinline__ int byte_of(uint4 x, int k) {
  const uint32_t w = k < 4 ? x.x : k < 8 ? x.y : k < 12 ? x.z : x.w;
  return (w >> (8 * (k & 3))) & 0xFF;
}

// The 16 pairs of a thread's positions at i0 from its staged bytes x and
// the byte after them: bit k of the result is m[i0 + k], and the value a
// start there emits is the 16-bit half k & 1 of vals[k / 2]. Where every
// pair lies inside the batch (i0 + 16 < n), the lookup alone decides.
__device__ __forceinline__ uint32_t staged_pairs(const Batch& b, int i0, uint4 x, int after,
                                                 uint32_t vals[kPer / 2]) {
  uint32_t match = 0;
#pragma unroll
  for (int k = 0; k < kPer / 2; ++k) vals[k] = 0;
  if (i0 + kPer < b.n) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int nx = k + 1 < kPer ? byte_of(x, k + 1) : after;
      const uint32_t v = __ldg(b.table + ((byte_of(x, k) << 8) | nx));
      match |= (uint32_t)(v != 0) << k;
      vals[k >> 1] |= v << (16 * (k & 1));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int v;
      const int nx = k + 1 < kPer ? byte_of(x, k + 1) : after;
      match |= (uint32_t)pair_at<true>(b, i0 + k, byte_of(x, k), nx, v) << k;
      vals[k >> 1] |= ((uint32_t)v & 0xFFFFu) << (16 * (k & 1));
    }
  }
  return match;
}

// A thread's 16 slots from its bytes x, its values, its start bits and
// consumed bits (bit k: the start at i0 + k - 1), written with two 16-byte
// stores.
__device__ __forceinline__ void store_slots(uint16_t* __restrict__ slots, int i0, uint4 x,
                                            const uint32_t vals[kPer / 2], uint32_t starts,
                                            uint32_t consumed) {
  uint32_t w[kPer / 2];
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    uint32_t s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * j + h;
      s[h] = ((consumed >> k) & 1u) ? 0u
             : ((starts >> k) & 1u) ? (vals[j] >> (16 * h)) & 0xFFFFu
                                    : (uint32_t)byte_of(x, k) << 8;
    }
    w[j] = s[0] | (s[1] << 16);
  }
  uint4* out = reinterpret_cast<uint4*>(slots + i0);
  out[0] = make_uint4(w[0], w[1], w[2], w[3]);
  out[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// The tile's maximum, for every thread (after block_excl_max filled warp_tot).
__device__ __forceinline__ int all_max(const int* warp_tot) {
  int m = kNeg;
#pragma unroll
  for (int w = 0; w < kSegWarps; ++w) m = max(m, warp_tot[w]);
  return m;
}

// swarpack's SWAR scan of one row pair (rows 2q and 2q + 1 of a segment,
// their match bits me and mo at this thread's 16 lanes 16 tr + k): s[k]
// packs lane l's codes as code_2q | code_2q+1 << 16, then 7 Hillis-Steele
// steps, each lane taking the old value of lane l - sh (0 below sh): every
// shuffle of a step is issued before its updates, so their latencies
// overlap. The 8 threads of a row pair are 8 neighbouring lanes of a warp,
// and every thread of the warp calls this.
__device__ __forceinline__ void swar_pair(uint32_t me, uint32_t mo, int tr, uint32_t s[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int l = kPer * tr + k;
    s[k] = (code_of(me >> k, l) & 0x7FFFu) | (code_of(mo >> k, l) << 16);
  }
#pragma unroll
  for (int sh = 1; sh < 128; sh <<= 1) {
    uint32_t c[kPer];
    if (sh < kPer) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k >= sh) {
          c[k] = s[k - sh];
        } else {
          const uint32_t up = __shfl_up_sync(kFull, s[k - sh + kPer], 1);
          c[k] = tr >= 1 ? up : 0u;
        }
      }
    } else {
      const int o = sh / kPer;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint32_t up = __shfl_up_sync(kFull, s[k], o);
        c[k] = tr >= o ? up : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) s[k] = swar_step(s[k], c[k]);
  }
}

// Publishes a job's last start for the next job (2 | start: 0 is "not yet").
__device__ __forceinline__ void publish_last(int* flags, int job, uint32_t start) {
  atomicExch(flags + job, 2 | (int)start);
}

// consumed at the job's first position: carry_in for job 0, else the start
// at the previous job's last position, which that job publishes before it
// waits for its own predecessor; the previous ticket's CTA has started, so
// the wait ends (a flag never published ends the kernel with a fault after
// 2**26 reads, never a hang). Where it is a start, the job's first slot
// becomes 0.
__device__ __forceinline__ void fix_first(const int* __restrict__ carry_in, int* flags, int job,
                                          int job0, uint16_t* __restrict__ slots) {
  int prev;
  if (job == 0) {
    prev = carry_in[0] != 0;
  } else {
    int w = 0;
    for (uint32_t tries = 0; w == 0; ++tries) {
      if (tries == (1u << 26)) __trap();
      w = *reinterpret_cast<volatile int*>(flags + job - 1);
    }
    prev = w & 1;
  }
  if (prev) slots[job0] = 0;
}

// Thread 0: the tile of a job's step (tile step % tiles of the job at job0:
// its bytes and the 16 after it, or up to cap) into stage step % 2 by one
// bulk copy, completing that stage's barrier.
__device__ __forceinline__ void stage_tile(const Batch& b, uint32_t base, uint32_t bars,
                                           int job0, int tiles, int step) {
  const int tile0 = job0 + (step % tiles) * kSegTile;
  const uint32_t bytes = (uint32_t)min(kStageBytes, b.cap - tile0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  stage(base + (step & 1) * kStageBytes, b.data + tile0, bytes, bytes, bars + 8 * (step & 1));
}

// Waits for step's stage (its barrier's phase step / 2); this thread's 16
// bytes at i0 and the byte after them (0 past cap).
__device__ __forceinline__ void read_stage(const Batch& b, const uint8_t* smem, uint32_t bars,
                                           int step, int i0, uint4& x, int& after) {
  mbar_wait(bars + 8 * (step & 1), (step >> 1) & 1);
  const uint8_t* st = smem + (step & 1) * kStageBytes + threadIdx.x * kPer;
  x = *reinterpret_cast<const uint4*>(st);
  after = i0 + kPer < b.cap ? st[kPer] : 0;
}

// CTAs an SM must hold (launch bounds): scan16 fits 8 in 32 registers;
// swarpack's SWAR steps keep 32 words a thread live, so 5 in 47 (held to
// 4, ptxas took 61 registers and rpb 8 ran 0.379-0.380 ms against
// 0.366-0.369 at 5, on an H100 80GB HBM3 at 700 W).
template <bool kSwar>
__global__ void __launch_bounds__(kSegThreads, kSwar ? 5 : 8)
    segment_scan(Batch b, Jobs J, const int* __restrict__ carry_in,
                 uint16_t* __restrict__ slots, int* __restrict__ carry_out,
                 int* __restrict__ flags, int* __restrict__ ticket) {
  extern __shared__ __align__(128) uint8_t seg_smem[];
  __shared__ int warp_tot[kSegWarps];
  __shared__ unsigned char last_start[kSegThreads];
  __shared__ int s_job;
  const int t = threadIdx.x;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(seg_smem);
  const uint32_t bars = base + kBarOffset;
  uint16_t* mbits = reinterpret_cast<uint16_t*>(seg_smem + kBitsOffset);
  uint16_t* sbits = mbits + J.job / kPer;
  uint8_t* rpar = reinterpret_cast<uint8_t*>(sbits + J.job / kPer);

  if (t == 0) {
    s_job = atomicAdd(ticket, 1);
    mbar_init(bars);
    mbar_init(bars + 8);
  }
  __syncthreads();
  const int job = s_job;
  const int job0 = job * J.job;
  const int job_end = min(job0 + J.job, b.cap);
  const int tiles = (job_end - job0 + kSegTile - 1) / kSegTile;
  // scan16 reads each tile once; swarpack twice (its match bits, then its
  // slots) where the job spans more than one tile, else it keeps the stage
  const int steps = kSwar && tiles > 1 ? 2 * tiles : tiles;
  if (t == 0) {
    stage_tile(b, base, bars, job0, tiles, 0);
    if (steps > 1) stage_tile(b, base, bars, job0, tiles, 1);
  }
  const int last = b.n - 1;
  if (b.n == 0 && job == 0 && t == 0) carry_out[0] = carry_in[0];
  // the last non-match before the current tile within its segment (the
  // reset: seg0 - 1 for a segment starting at seg0, odd, "1 if none")
  int run = job0 - 1;

  if constexpr (!kSwar) {
    uint32_t prev_last = 0;  // the start before the tile; the job's first: fix_first
    for (int step = 0; step < tiles; ++step) {
      const int i0 = job0 + step * kSegTile + t * kPer;
      const bool live = i0 < job_end;
      uint32_t vals[kPer / 2];
      uint4 x;
      uint32_t match = 0;
      if (live) {
        int after;
        read_stage(b, seg_smem, bars, step, i0, x, after);
        match = staged_pairs(b, i0, x, after, vals);
      }
      const int excl =
          block_excl_max<kSegThreads>(live ? last_nonmatch(i0, match) : kNeg, warp_tot);
      const int tile_max = all_max(warp_tot);
      if (t == 0 && step + 2 < steps) stage_tile(b, base, bars, job0, tiles, step + 2);
      const int seg0 = J.job == J.seg ? job0 : job0 + (i0 - job0) / J.seg * J.seg;
      const uint32_t starts = live ? scan_starts(i0, match, max(max(run, excl), seg0 - 1)) : 0u;
      run = max(run, tile_max);
      last_start[t] = (starts >> (kPer - 1)) & 1u;
      if (live && i0 + kPer == job_end) publish_last(flags, job, (starts >> (kPer - 1)) & 1u);
      __syncthreads();
      if (live) {
        const uint32_t prev = t > 0 ? last_start[t - 1] : prev_last;
        store_slots(slots, i0, x, vals, starts, (starts << 1) | prev);
        if (last >= i0 && last < i0 + kPer) carry_out[0] = (starts >> (last - i0)) & 1u;
      }
      prev_last = last_start[kSegThreads - 1];
    }
  } else {
    // 1. the job's match bits, and each row's parity of the last non-match
    // before it in its segment
    for (int step = 0; step < tiles; ++step) {
      const int i0 = job0 + step * kSegTile + t * kPer;
      const bool live = i0 < job_end;
      uint32_t match = 0;
      if (live) {
        uint4 x;
        int after;
        uint32_t vals[kPer / 2];
        read_stage(b, seg_smem, bars, step, i0, x, after);
        match = staged_pairs(b, i0, x, after, vals);
      }
      const int excl =
          block_excl_max<kSegThreads>(live ? last_nonmatch(i0, match) : kNeg, warp_tot);
      const int tile_max = all_max(warp_tot);
      if (t == 0 && step + 2 < steps) stage_tile(b, base, bars, job0, tiles, step + 2);
      if (live) {
        const int chunk = (i0 - job0) / kPer;
        mbits[chunk] = (uint16_t)match;
        if ((t & 7) == 0) {
          const int seg0 = J.job == J.seg ? job0 : job0 + (i0 - job0) / J.seg * J.seg;
          rpar[chunk >> 3] = (uint8_t)(max(max(run, excl), seg0 - 1) & 1);
        }
      }
      run = max(run, tile_max);
      __syncthreads();  // warp_tot's next use; the bits for step 2
    }
    // 2. start bits: row pair q of each segment, 8 threads a pair, gives
    // row q its low fields and row q + rpb / 2 its high fields
    const int rpb = J.seg / 128;
    const int half = rpb / 2;
    const int units = (job_end - job0) / J.seg * half;
    const int tr = t & 7;
    for (int u0 = 0; u0 < units; u0 += kSegThreads / 8) {
      const int u = u0 + (t >> 3);
      const bool mine = u < units;
      const int r0 = mine ? u / half * rpb : 0;
      const int q = mine ? u % half : 0;
      uint32_t s[kPer];
      swar_pair(mbits[(r0 + 2 * q) * 8 + tr], mbits[(r0 + 2 * q + 1) * 8 + tr], tr, s);
      if (mine) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + q + h * half;
          const uint32_t m = mbits[row * 8 + tr];
          const int rp = rpar[row];
          uint32_t st = 0;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int f = (int)((h ? s[k] >> 16 : s[k]) & 0xFFFFu);
            const int par = f > 0 ? (f & 1) : rp;
            if (((m >> k) & 1u) && ((k & 1) ^ par)) st |= 1u << k;
          }
          sbits[row * 8 + tr] = (uint16_t)st;
        }
      }
    }
    __syncthreads();
    const int chunks = (job_end - job0) / kPer;
    if (t == 0) {
      publish_last(flags, job, (uint32_t)sbits[chunks - 1] >> (kPer - 1));
      if (last >= job0 && last < job_end) {
        carry_out[0] = ((uint32_t)sbits[(last - job0) / kPer] >> ((last - job0) % kPer)) & 1u;
      }
    }
    // 3. the slots, each start's pair looked up again
    for (int k = 0; k < tiles; ++k) {
      const int step = tiles > 1 ? tiles + k : 0;
      const int i0 = job0 + k * kSegTile + t * kPer;
      const bool live = i0 < job_end;
      uint4 x;
      int after = 0;
      if (live) read_stage(b, seg_smem, bars, step, i0, x, after);
      if (tiles > 1) {
        __syncthreads();  // the stage is read: it may take step + 2
        if (t == 0 && step + 2 < steps) stage_tile(b, base, bars, job0, tiles, step + 2);
      }
      if (!live) continue;
      const int chunk = (i0 - job0) / kPer;
      const uint32_t starts = sbits[chunk];
      const uint32_t prev = chunk > 0 ? (uint32_t)sbits[chunk - 1] >> (kPer - 1) : 0u;
      uint32_t vals[kPer / 2];
#pragma unroll
      for (int j = 0; j < kPer / 2; ++j) vals[j] = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int v = 0;
        if ((starts >> j) & 1u) {
          pair_at<true>(b, i0 + j, byte_of(x, j), j + 1 < kPer ? byte_of(x, j + 1) : after, v);
        }
        vals[j >> 1] |= ((uint32_t)v & 0xFFFFu) << (16 * (j & 1));
      }
      store_slots(slots, i0, x, vals, starts, (starts << 1) | prev);
    }
  }
  if (t == 0) fix_first(carry_in, flags, job, job0, slots);
}

template <bool kSwar>
int launch_segment_scan(const Batch& b, int rpb, const int* carry_in, uint16_t* slots,
                        int* carry_out, int* scratch, cudaStream_t s) {
  const Jobs J = jobs_of(b.cap, rpb);
  // the largest shared memory any rpb takes, so a graph captured at one rpb
  // replays; then the jobs' flags and the ticket
  int err = (int)cudaFuncSetAttribute(segment_scan<kSwar>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      segment_smem(kSwar, kMaxSegment));
  if (!err) err = (int)cudaMemsetAsync(scratch, 0, (J.count + 1) * sizeof(int), s);
  if (err) return err;
  segment_scan<kSwar><<<J.count, kSegThreads, segment_smem(kSwar, J.job), s>>>(
      b, J, carry_in, slots, carry_out, scratch, scratch + J.count);
  return (int)cudaGetLastError();
}

// --- T10 noscan2: one launch, a look-back over the blocks' carry maps -------

constexpr int kBlockMap = 4;       // a block's flag: 4 | map (bit c: its carry out for carry c)
constexpr int kBlockCarry = 8;     // 8 | its carry out
constexpr int kRowScanUnroll = 2;  // sub-tiles of kTile positions a CTA (of 1-4, PERF.md)
constexpr int kRowScanTile = kRowScanUnroll * kTile;  // positions of a tile
constexpr int kRowScanThreads = kThreads + 32;        // 8 data warps and the control warp
constexpr int kLocalMaps = 3;  // maps of the blocks before a tile computed from their last rows
// blocks a tile can meet (rpb >= 8: 1024 positions at least)
constexpr int kRowScanBlocks = kRowScanTile / 1024 + 1;

// f after g, for maps of one bit (bit c: its value at c).
__device__ __forceinline__ uint32_t compose(uint32_t f, uint32_t g) {
  return ((f >> (g & 1u)) & 1u) | (((f >> ((g >> 1) & 1u)) & 1u) << 1);
}

// The carry into block blk, for every lane of one warp: a window of 32
// flags read at once, nearest first (lane k: block top - k), waited on
// until every flag up to the nearest that holds a carry is published, then
// composed from the nearest; the next window where none holds one. Blocks
// wholly past n (j * seg >= n) pass their carry and hold no flag, and past
// block 0 the call's carry_in stands as a carry. A flag never published
// ends the kernel with a fault after 2**26 rounds, never a hang.
__device__ int carry_into(const int* flags, int blk, int seg, int n,
                          const int* __restrict__ carry_in) {
  const int lane = threadIdx.x & 31;
  const int cin = kBlockCarry | (carry_in[0] != 0);
  uint32_t g = 2u;  // the identity
  for (int top = min(blk, n > 0 ? (n - 1) / seg + 1 : 0) - 1;; top -= 32) {
    const int j = top - lane;
    int w;
    uint32_t carries;
    for (uint32_t tries = 0;; ++tries) {
      if (tries == (1u << 26)) __trap();
      w = j >= 0 ? *reinterpret_cast<const volatile int*>(flags + j) : cin;
      carries = __ballot_sync(kFull, w & kBlockCarry);
      const uint32_t upto = carries ? (carries & (0u - carries)) * 2u - 1u : kFull;
      if (!(__ballot_sync(kFull, w == 0) & upto)) break;
    }
    // a carry as the constant map
    const uint32_t f = (w & kBlockCarry) ? ((w & 1) ? 3u : 0u) : (uint32_t)w & 3u;
    const int last = carries ? __ffs(carries) - 1 : 31;
    for (int k = 0; k <= last; ++k) g = compose(g, __shfl_sync(kFull, f, k));
    if (carries) return (int)(g & 1u);
  }
}

// The start bits of 16 positions from an even one, for block carry 0 and
// 1, bit-parallel (scan_starts's function, without its 16 steps): a
// position's last non-match is odd where an odd non-match is followed by
// matches only up to it (a segmented Kogge-Stone fill of the odd
// non-matches across the matches), and before the first non-match it is
// the run coming in: `before` (the row's last non-match before these 16),
// or where there is none (kNeg) the sentinel s - 1 - c, odd for c = 0 and
// even for c = 1 (s is even). start = match && (position odd) != (its last
// non-match odd).
__device__ __forceinline__ void parity_starts(uint32_t match, int before, uint32_t& st0,
                                              uint32_t& st1) {
  constexpr uint32_t kOdd = 0xAAAAu;
  uint32_t g = ~match & kOdd;  // odd non-matches
  uint32_t p = match;          // matches carry the fill on
  g |= p & (g << 1);
  p &= p << 1;
  g |= p & (g << 2);
  p &= p << 2;
  g |= p & (g << 4);
  p &= p << 4;
  g |= p & (g << 8);
  const uint32_t lead = (~match & (match + 1u)) - 1u;  // the positions before the first non-match
  const uint32_t odd0 = before != kNeg ? (uint32_t)before & 1u : 1u;
  const uint32_t odd1 = before != kNeg ? (uint32_t)before & 1u : 0u;
  st0 = match & (kOdd ^ (g | (odd0 ? lead : 0u))) & 0xFFFFu;
  st1 = match & (kOdd ^ (g | (odd1 ? lead : 0u))) & 0xFFFFu;
}

// The starts of the 16 positions at i0 (one thread of 8 lanes a row; every
// lane of the warp calls it) for block carry 0 and 1, from its bytes x and
// the byte after them; vals as staged_pairs's. Lanes that are not live
// (past cap) hold no match. i0 and the block's start are even and a row
// never crosses a block, so the sentinel enters only through
// parity_starts's run.
__device__ __forceinline__ void row_starts(const Batch& b, int i0, bool live, uint4 x, int after,
                                           uint32_t vals[kPer / 2], uint32_t& st0,
                                           uint32_t& st1) {
  const int lane = threadIdx.x & 31;
  const uint32_t match = live ? staged_pairs(b, i0, x, after, vals) : 0u;
  // the row's last non-match before this thread: 8 lanes a row
  int before = live ? last_nonmatch(i0, match) : kNeg;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const int y = __shfl_up_sync(kFull, before, o, 8);
    if ((lane & 7) >= o) before = max(before, y);
  }
  before = __shfl_up_sync(kFull, before, 1, 8);
  if ((lane & 7) == 0) before = kNeg;
  parity_starts(match, before, st0, st1);
}

__global__ void __launch_bounds__(kRowScanThreads)
    row_scan_kernel(Batch b, int seg, int nb, const int* __restrict__ carry_in,
                    uint16_t* __restrict__ slots, int* __restrict__ carry_out,
                    int* __restrict__ block_flags, int* __restrict__ ticket) {
  __shared__ int s_tile;
  __shared__ uint32_t s_warp_last[kRowScanUnroll][kWarps];  // 2 bits: a warp's last start
  __shared__ uint32_t s_map[kRowScanBlocks];  // maps of the blocks ending in the tile
  __shared__ int s_carry[kRowScanBlocks];     // carries into the tile's blocks
  __shared__ uint32_t s_prev;                 // the start before the tile, 2 bits
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kRowScanTile;
  const int blk0 = base / seg;

  uint4 x[kRowScanUnroll];
  uint32_t vals[kRowScanUnroll][kPer / 2];
  uint32_t st0[kRowScanUnroll], st1[kRowScanUnroll], up2[kRowScanUnroll];
  if (warp < kWarps) {
    // 1. data warps: the pairs, once, and the starts for carry 0 and 1;
    // thread t owns the 16 positions at u * kTile + 16 t of each sub-tile
    // u, all loads issued before any is used. A block's map is published
    // as soon as its last position's thread has it.
#pragma unroll
    for (int u = 0; u < kRowScanUnroll; ++u) {
      const int i0 = base + u * kTile + t * kPer;
      x[u] = i0 < b.cap ? *reinterpret_cast<const uint4*>(b.data + i0) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kRowScanUnroll; ++u) {
      const int i0 = base + u * kTile + t * kPer;
      const bool live = i0 < b.cap;
      int after = __shfl_down_sync(kFull, (int)(x[u].x & 0xFFu), 1);
      if (lane == 31) after = live && i0 + kPer < b.cap ? b.data[i0 + kPer] : 0;
      row_starts(b, i0, live, x[u], after, vals[u], st0[u], st1[u]);
      const uint32_t last2 = ((st0[u] >> (kPer - 1)) & 1u) | (((st1[u] >> (kPer - 1)) & 1u) << 1);
      up2[u] = __shfl_up_sync(kFull, last2, 1);
      const int s = i0 / seg * seg;
      const int last_pos = min(s + seg - 1, b.n - 1);
      if (live && last_pos >= i0 && last_pos < i0 + kPer) {
        const int k = last_pos - i0;
        const uint32_t map = ((st0[u] >> k) & 1u) | (((st1[u] >> k) & 1u) << 1);
        s_map[i0 / seg - blk0] = map;
        atomicExch(block_flags + i0 / seg, kBlockMap | (int)map);
      }
      if (lane == 31) s_warp_last[u][warp] = last2;
    }
  } else {
    // 1. the control warp, while the data warps load: four rows of 8 lanes.
    // Lanes 0-7: the start before the tile (inside a block: the previous
    // row's last). Lanes 8-31: the maps of the kLocalMaps nearest blocks
    // before the tile that hold a position below n, each from the row of
    // its last position, so the carry into the tile's first block waits on
    // no flag but those of older blocks (published long before).
    const int below_n = b.n > 0 ? (b.n - 1) / seg + 1 : 0;
    const int near = min(blk0, below_n) - 1;  // the nearest such block
    const int r = lane >> 3;
    const int j = near - (r - 1);             // row r's block (r >= 1)
    const int lp = r > 0 && j >= 0 ? min((j + 1) * seg - 1, b.n - 1) : 0;
    const int row = r == 0 ? base - 128 : (lp & ~127);
    const bool live = r == 0 ? base % seg != 0 : j >= 0;
    const int i0 = row + (lane & 7) * kPer;
    const uint4 h = live ? *reinterpret_cast<const uint4*>(b.data + i0) : make_uint4(0, 0, 0, 0);
    int after = __shfl_down_sync(kFull, (int)(h.x & 0xFFu), 1);
    if ((lane & 7) == 7) after = live && i0 + kPer < b.cap ? b.data[i0 + kPer] : 0;
    const int older = near - kLocalMaps;  // the nearest block whose flag is read
    int c = older >= 0 ? carry_into(block_flags, older + 1, seg, b.n, carry_in)
                       : carry_in[0] != 0;
    uint32_t hv[kPer / 2], h0, h1;
    row_starts(b, i0, live, h, after, hv, h0, h1);
    if (lane == 7) s_prev = ((h0 >> (kPer - 1)) & 1u) | (((h1 >> (kPer - 1)) & 1u) << 1);
    // the local maps, oldest first
    for (int q = kLocalMaps; q >= 1; --q) {
      const int jq = near - (q - 1);
      if (jq < 0) continue;
      const int lq = min((jq + 1) * seg - 1, b.n - 1);
      const int holder = 8 * q + (lq & 127) / kPer;  // the lane of jq's last position
      const uint32_t a0 = __shfl_sync(kFull, h0, holder);
      const uint32_t a1 = __shfl_sync(kFull, h1, holder);
      c = (int)(((c ? a1 : a0) >> (lq % kPer)) & 1u);
    }
    if (lane == 0) s_carry[0] = c;
  }
  __syncthreads();

  // 2. the control warp: the carries into the tile's later blocks, and the
  // carry out of each block ending here
  if (warp == kWarps) {
    const int blk_end = min((base + kRowScanTile - 1) / seg, nb - 1);
    int c = s_carry[0];
    for (int j = blk0; j <= blk_end; ++j) {
      const int lp = min((j + 1) * seg - 1, b.n - 1);
      if (lane == 0) s_carry[j - blk0] = c;
      if (lp >= max(j * seg, base) && lp < base + kRowScanTile) {
        c = (int)((s_map[j - blk0] >> c) & 1u);
        if (lane == 0) {
          atomicExch(block_flags + j, kBlockCarry | c);
          if (lp == b.n - 1) carry_out[0] = c;
        }
      } else if (lp >= j * seg && lp < base) {
        // the first block ended (at n - 1) in an earlier tile: its flag
        // holds its carry out, and every block after it passes that on
        c = carry_into(block_flags, j + 1, seg, b.n, carry_in);
      }
    }
    if (b.n == 0 && tile == 0 && lane == 0) carry_out[0] = carry_in[0] != 0;
  }
  __syncthreads();

  // 3. the slots, with the block's carry
  if (warp == kWarps) return;
#pragma unroll
  for (int u = 0; u < kRowScanUnroll; ++u) {
    const int i0 = base + u * kTile + t * kPer;
    if (i0 >= b.cap) break;
    const int s = i0 / seg * seg;
    const int c = s_carry[i0 / seg - blk0];
    const uint32_t starts = c ? st1[u] : st0[u];
    uint32_t prev;
    if (i0 == s) {
      prev = (uint32_t)c;  // consumed at the block's first position: its carry
    } else {
      // the lane before, the warp before, the sub-tile before or the row before the tile
      const uint32_t p2 = lane > 0 ? up2[u]
                          : warp > 0 ? s_warp_last[u][warp - 1]
                          : u > 0    ? s_warp_last[u > 0 ? u - 1 : 0][kWarps - 1]
                                     : s_prev;
      prev = (p2 >> c) & 1u;
    }
    store_slots(slots, i0, x[u], vals[u], starts, (starts << 1) | prev);
  }
}

int launch_row_scan(const Batch& b, int rpb, const int* carry_in, uint16_t* slots,
                    int* carry_out, int* scratch, cudaStream_t s) {
  const int seg = rpb * 128;
  const int nb = b.cap / seg;
  const int tiles = (b.cap + kRowScanTile - 1) / kRowScanTile;
  int err = (int)cudaMemsetAsync(scratch, 0, (size_t)(nb + 1) * sizeof(int), s);
  if (err) return err;
  row_scan_kernel<<<tiles, kRowScanThreads, 0, s>>>(b, seg, nb, carry_in, slots, carry_out,
                                                    scratch, scratch + nb);
  return (int)cudaGetLastError();
}

// --- T12: the block-local parity scan of a mask, tiles over CTAs ----------

constexpr int kMaskUnroll = 4;                    // groups of 16 a thread, one a sub-tile
constexpr int kMaskSub = kThreads * kPer;         // positions of a sub-tile
constexpr int kMaskTile = kMaskUnroll * kMaskSub;  // positions of a tile

// Bit k set where byte k of the 16 is nonzero.
__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // byte b of nz is 1 where nonzero; the product gathers the four to bits 21..24
    uint32_t nz = __vcmpne4(w[q], 0u) & 0x01010101u;
    bits |= ((nz * 0x00204081u) >> 21 & 0xFu) << (4 * q);
  }
  return bits;
}

// Bits 0..3 of nib as bytes 0..3 of 0 or 1 (the inverse of the gather above).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// The bf16 bits of 0 <= n < 256 (exact), at compile time; and of -1, -2.
__host__ __device__ constexpr unsigned short bf16_of(int n) {
  int e = 0;
  while (n >> (e + 1)) ++e;
  return n == 0 ? 0 : (unsigned short)((127 + e) << 7 | ((n << (7 - e)) & 0x7F));
}
constexpr unsigned short kBf16MinusOne = 0xBF80;
constexpr unsigned short kBf16MinusTwo = 0xC000;

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 p) {
  return (uint32_t)__bfloat16_as_ushort(__low2bfloat16(p)) |
         (uint32_t)__bfloat16_as_ushort(__high2bfloat16(p)) << 16;
}

// The start bits of the 16 positions at tile-local index i0, run being the
// last zero or segment sentinel before them (a tile-local index, or -1 / -2
// for a carry of odd / even parity). Groups and rows start at even
// positions, so a position's parity is its k's, and a tile-local index's
// parity is its global one's.
template <bool kBf16>
__device__ __forceinline__ uint32_t group_starts(int i0, uint32_t match, int run);

template <>
__device__ __forceinline__ uint32_t group_starts<false>(int i0, uint32_t match, int run) {
  return scan_starts(i0, match, run);
}

// The lane scan in bf16 pairs: lane l's value is l at a zero, else the
// run's parity as -1 or -2 (all exact in bf16), two lanes to a register,
// scanned inside each pair and then pair after pair with __hmax2; a lane's
// last zero has the parity of the scanned value, read through f32 (adding
// 1.5 * 2^23 puts the integer's lowest bit in the mantissa's).
template <>
__device__ __forceinline__ uint32_t group_starts<true>(int i0, uint32_t match, int run) {
  const __nv_bfloat16 none = __ushort_as_bfloat16((run & 1) ? kBf16MinusOne : kBf16MinusTwo);
  const __nv_bfloat16 lane0 = __int2bfloat16_rn(i0 & 127);
  uint32_t starts = 0;
  __nv_bfloat16 prev = none;
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    // lane0 + 2j + 1 is at most 127: the sums are exact
    __nv_bfloat16 lo = ((match >> (2 * j)) & 1u)
                           ? none : __hadd(lane0, __ushort_as_bfloat16(bf16_of(2 * j)));
    __nv_bfloat16 hi = ((match >> (2 * j + 1)) & 1u)
                           ? none : __hadd(lane0, __ushort_as_bfloat16(bf16_of(2 * j + 1)));
    __nv_bfloat162 p = __halves2bfloat162(lo, hi);
    p = __hmax2(p, __halves2bfloat162(prev, lo));
    p = __hmax2(p, __halves2bfloat162(prev, prev));
    prev = __high2bfloat16(p);
    const uint32_t w = bf162_bits(p);
    const uint32_t par_lo = __float_as_uint(__uint_as_float(w << 16) + 12582912.0f) & 1u;
    const uint32_t par_hi = __float_as_uint(__uint_as_float(w & 0xFFFF0000u) + 12582912.0f) & 1u;
    // an even lane starts after an odd last zero, an odd lane after an even one
    starts |= (par_lo << (2 * j)) | ((par_hi ^ 1u) << (2 * j + 1));
  }
  return starts & match;
}

// One CTA a tile of kMaskTile positions, taken from a ticket: thread t owns
// the 16 positions at u * kMaskSub + 16 t of each sub-tile u. Each group
// contributes its last zero, or s - 1 where it opens a segment at s (the
// sentinel); the tile's exclusive maximum of those runs over the sub-tiles
// in order, and across tiles a decoupled look-back carries one bit, the
// parity of the last zero or sentinel before the tile. A tile that opens a
// segment needs no carry: it publishes its prefix and walks nowhere, so no
// look-back crosses a segment start.
template <bool kBf16>
__device__ __forceinline__ void mask_scan(const uint8_t* __restrict__ mask,
                                          uint8_t* __restrict__ out, long long n, int seg,
                                          int tiles, unsigned long long* status) {
  __shared__ __align__(16) int warp_tot[kMaskUnroll][kWarps];
  __shared__ int word;  // the tile, then its carry's parity
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) word = (int)atomicAdd(reinterpret_cast<unsigned int*>(status + tiles), 1u);
  __syncthreads();
  const int tile = word;
  const long long base = (long long)tile * kMaskTile;
  const int head = (int)(base % seg);  // the tile's first position within its segment

  uint4 v[kMaskUnroll];
#pragma unroll
  for (int u = 0; u < kMaskUnroll; ++u) {
    const long long i = base + u * kMaskSub + threadIdx.x * kPer;
    v[u] = i < n ? *reinterpret_cast<const uint4*>(mask + i) : make_uint4(0, 0, 0, 0);
  }
  uint32_t match[kMaskUnroll];
  int sentinel[kMaskUnroll], incl[kMaskUnroll];
#pragma unroll
  for (int u = 0; u < kMaskUnroll; ++u) {
    const int i0 = u * kMaskSub + threadIdx.x * kPer;
    const bool live = base + i0 < n;
    // a group past the end counts as all ones and is not stored
    match[u] = live ? nonzero16(v[u]) : 0xFFFFu;
    sentinel[u] = live && (head + i0) % seg == 0 ? i0 - 1 : kNeg;
    incl[u] = max(last_nonmatch(i0, match[u]), sentinel[u]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, incl[u], o);
      if (lane >= o) incl[u] = max(incl[u], y);
    }
    if (lane == 31) warp_tot[u][warp] = incl[u];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int agg = kNeg;
#pragma unroll
    for (int u = 0; u < kMaskUnroll; ++u)
      for (int w = 0; w < kWarps; ++w) agg = max(agg, warp_tot[u][w]);
    const int par = agg == kNeg ? kNeg : (agg & 1);
    if (head == 0) {
      publish(status, tile, kPrefix, par);  // its sentinel at -1 is in agg
      word = 1;
    } else {
      word = look_back(status, tile, par, 1);
    }
  }
  // each group's exclusive maximum within the tile: the sub-tiles before
  // its own, then the warps and lanes before it in its own
  int before[kMaskUnroll];
  int done = kNeg;
#pragma unroll
  for (int u = 0; u < kMaskUnroll; ++u) {
    int pre = done;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[u][w];
      if (w < warp) pre = max(pre, t);
      done = max(done, t);
    }
    int ex = __shfl_up_sync(kFull, incl[u], 1);
    before[u] = lane == 0 ? pre : max(pre, ex);
  }
  __syncthreads();
  const int carry = word ? -1 : -2;  // a zero before the tile, of the carry's parity
#pragma unroll
  for (int u = 0; u < kMaskUnroll; ++u) {
    const int i0 = u * kMaskSub + threadIdx.x * kPer;
    if (base + i0 >= n) break;
    const int run = max(max(before[u], carry), sentinel[u]);
    const uint32_t st = group_starts<kBf16>(i0, match[u], run);
    *reinterpret_cast<uint4*>(out + base + i0) =
        make_uint4(spread4(st & 0xFu), spread4(st >> 4 & 0xFu), spread4(st >> 8 & 0xFu),
                   spread4(st >> 12));
  }
}

// The two variants' kernels, each with its own launch bounds: bf16's lane
// scan takes 44 registers unbounded, 5 CTAs an SM, and held to 6 CTAs (40
// registers) it runs 0.0652 ms against 0.0676; int32 takes 38 registers and
// 6 CTAs unbounded (0.0606), and any minimum of CTAs changes its code for
// the worse (0.0639 at 6, 0.0707 at 1, with 56 registers). exp_bf16scan at
// 64 MiB, an H100 80GB HBM3 at 700 W (PERF.md).
constexpr int kMaskBf16Ctas = 6;

__global__ void __launch_bounds__(kThreads)
    mask_scan_i32(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, long long n,
                  int seg, int tiles, unsigned long long* status) {
  mask_scan<false>(mask, out, n, seg, tiles, status);
}

__global__ void __launch_bounds__(kThreads, kMaskBf16Ctas)
    mask_scan_bf16(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, long long n,
                   int seg, int tiles, unsigned long long* status) {
  mask_scan<true>(mask, out, n, seg, tiles, status);
}

}  // namespace

// swar: 0 scan16, 1 swarpack. Arguments as blt_flat_pass (flat_bpe.cu),
// plus rpb, the Pallas block's rows (a multiple of 8 up to 1024, cap a
// multiple of rpb * 128, checked by the wrapper); scratch: jobs + 1 int32
// (jobs_of; tools_cuda.block_scan_plan), the jobs' flags and the ticket,
// zeroed on the stream before the launch. Returns the first nonzero CUDA
// error of the memset and the launch.
extern "C" int blt_block_scan(int swar, const void* data, int cap, int n,
                              int next_byte, const void* table,
                              const void* carry_in, void* slots,
                              void* carry_out, void* scratch, int rpb,
                              void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  auto launch = swar ? launch_segment_scan<true> : launch_segment_scan<false>;
  return launch(b, rpb, (const int*)carry_in, (uint16_t*)slots, (int*)carry_out,
                (int*)scratch, (cudaStream_t)stream);
}

// CTAs of scan16's and swarpack's kernel that one SM of the current device
// holds at once at rpb 1024 (swarpack's largest shared memory), as the CUDA
// runtime computes them. Returns the first nonzero CUDA error.
template <bool kSwar>
int segment_ctas_per_sm(int* ctas) {
  int err = (int)cudaFuncSetAttribute(segment_scan<kSwar>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      segment_smem(kSwar, kMaxSegment));
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, segment_scan<kSwar>, kSegThreads,
                                                            segment_smem(kSwar, kMaxSegment));
}

extern "C" int blt_scan16_ctas_per_sm(int* ctas) { return segment_ctas_per_sm<false>(ctas); }

extern "C" int blt_swarpack_ctas_per_sm(int* ctas) { return segment_ctas_per_sm<true>(ctas); }

// noscan2 (T10): arguments as blt_block_scan; scratch: blocks + 1 int32
// (cap / (rpb * 128); tools_cuda.row_scan_plan), the blocks' flags and the
// ticket, zeroed on the stream before the launch. Returns the first nonzero CUDA error of the memset and the
// launch.
extern "C" int blt_row_scan(const void* data, int cap, int n, int next_byte,
                            const void* table, const void* carry_in,
                            void* slots, void* carry_out, void* scratch,
                            int rpb, void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  return launch_row_scan(b, rpb, (const int*)carry_in, (uint16_t*)slots,
                         (int*)carry_out, (int*)scratch, (cudaStream_t)stream);
}

// CTAs of noscan2's kernel that one SM of the current device holds at once,
// as the CUDA runtime computes them. Returns the first nonzero CUDA error.
extern "C" int blt_row_scan_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, row_scan_kernel,
                                                            kRowScanThreads, 0);
}

// T12: bf16 0 for the int32 scan, 1 for the bf16x2 one. mask, out: rows x
// 128 bytes (16-byte aligned), rows a positive multiple of rpb (a multiple
// of 8 up to 1024, checked by the wrapper); scratch: ceil(rows * 128 /
// kMaskTile) + 1 64-bit words (tools_cuda.mask_scan_plan), the tiles'
// status words and the ticket, zeroed on the stream before the launch.
// Returns the first nonzero CUDA error of the memset and the launch.
extern "C" int blt_mask_scan(int bf16, const void* mask, void* out, int rows,
                             int rpb, void* scratch, void* stream) {
  const long long n = (long long)rows * 128;
  const int tiles = (int)((n + kMaskTile - 1) / kMaskTile);
  auto s = (cudaStream_t)stream;
  auto status = (unsigned long long*)scratch;
  int err = (int)cudaMemsetAsync(status, 0, (size_t)(tiles + 1) * sizeof(*status), s);
  if (err) return err;
  auto kernel = bf16 ? mask_scan_bf16 : mask_scan_i32;
  kernel<<<tiles, kThreads, 0, s>>>((const uint8_t*)mask, (uint8_t*)out, n, rpb * 128, tiles,
                                    status);
  return (int)cudaGetLastError();
}

// CTAs of T12's two kernels that one SM of the current device holds at
// once, as the CUDA runtime computes them. Returns the first nonzero CUDA
// error.
extern "C" int blt_mask_scan_i32_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mask_scan_i32, kThreads, 0);
}

extern "C" int blt_mask_scan_bf16_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mask_scan_bf16, kThreads, 0);
}
