// One general-table merge round over compacted int32 tokens (K4), and the
// rounds of its ablation (T4).
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_token_pass_call (kernel body
// _token_pass_kernel), the pass that _multipass_resident_call (the
// BLT_MP_COMPACT=sort loop) and PallasTokenEncoder.encode run once per round;
// with other flag sets, four variants of tools/exp_mp_ablate.py::_one_call
// (T4, body from make_variant_kernel).
//
// K4 is token_pass.cuh with the lookup, the scan and the shift: per
// position, the cuckoo32 value of the pair (tok[i], tok[i+1]) where the
// leftmost-first parity scan starts a merge, -1 where the position before
// started one, else the token. T4's variants drop one part each
// (multipass_cuda.TOKEN_PASSES): full (K4's function, in its three-launch
// design), noscan (start = m, one launch), nolookup (m = ((tok[i] ^
// tok[i+1]) & 7) == 3, val = tok[i] + 1),
// noshift (nxt = tok[i], so the key is tok[i] * 65536 + tok[i] in int32
// wrap). From the second link of the tool's chain on, the input holds -1
// tombstones; cuckoo32.cuh hashes a negative key with int32 wrap.
//
// Bound on the H100: the bytes, 4 in and 4 out per position (64 MiB each way
// at 16 Mi tokens, about 40 us at 3.35 TB/s). Each position also costs one or
// two dependent gathers into the 128 KB of planes (at 8192 slots), which the
// read-only cache holds; a wide table's 1 MiB of planes (65,536 slots) is
// read through L2. The Pallas rows_per_block sets nothing here: the
// tile is fixed at 4096 tokens and no output depends on it.
//
// Design: see token_pass.cuh. The main path's K4 is one launch with a
// decoupled look-back (flag set 15), each pair looked up once. The
// three-launch design, reduce / one-block tile max-scan / emit on one stream
// (7), computes the same function; T4's rows are variants of it, and it is
// timed beside the look-back.

#include "token_pass.cuh"

namespace {

// The flag sets of multipass_cuda.TOKEN_PASSES, the only ones instantiated
// (tests/test_torch_lookback.py holds the two lists equal): K4 15, its
// three-launch design 7; T4 noscan 5, nolookup 6, noshift 3.
using TokenSets = std::integer_sequence<int, 15, 7, 5, 6, 3>;

}  // namespace

// flags: the TokenFlag bits of token_pass.cuh (lookup 1, scan 2, shift 4,
// lookback 8). tokens, out: cap int32 (16-byte aligned, cap a multiple of
// 16, checked by the wrapper); k1, v1, k2, v2: slots int32 each (slots a
// power of two); scratch: 2 * ceil(cap / 4096) + 1 int32, 8-byte aligned.
// Returns the first nonzero CUDA error of the launches and the memset, or
// cudaErrorInvalidValue for a set not in TokenSets.
extern "C" int blt_token_pass(int flags, const void* tokens, int cap, int n,
                              const void* k1, const void* v1, const void* k2,
                              const void* v2, int slots, unsigned a1,
                              unsigned a2, int shift, void* out, void* scratch,
                              void* stream) {
  Planes t{(const int*)k1, (const int*)v1, (const int*)k2, (const int*)v2,
           a1, a2, shift, (uint32_t)(slots - 1)};
  Pass b{(const int*)tokens, cap, n, t};
  return dispatch_token_pass(flags, TokenSets(), b, (int*)out, (int*)scratch,
                             (cudaStream_t)stream);
}

// CTAs of K4's look-back round (tile_lookback) that one SM of the current
// device holds at once, as the CUDA runtime computes them from the compiled
// kernel's registers and shared memory. Returns the CUDA error of the query.
extern "C" int blt_token_pass_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, tile_lookback, kThreads, 0);
}
