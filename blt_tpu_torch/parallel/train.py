"""BPE merge-table training (port of ``blt_tpu/parallel/train.py``).

A capability extension over the reference (which only consumes pre-built
merges files, blt_core/src/config_loader.rs): learn the rules with the
classic greedy procedure — repeatedly count adjacent-pair frequencies and
merge the most frequent pair — with counting and merging running on the
card. Emitted rules use the same id policy as the reference loader (ids
from 256, one per rule, config_loader.rs:14-46). The encoder applies
pass-based greedy semantics (all rules eligible per pass,
tokenizer.rs:61-86), not classic rank-ordered BPE, so encoding the training
corpus is not guaranteed to reproduce the training-time merge sequence
rule-for-rule (SURVEY.md 2.1.2).

The pair domain grows as merges are learned, so counting uses a dense
int32 ``(V, V)`` histogram with V = 256 + num_merges, filled by
``index_add_`` (``bincount`` would count in int64, twice the bytes). A
round reads the winning pair index, its count and the longest row's
length in one device-to-host copy, and the trainers run each round over
the tokens up to that length only (the JAX trainer runs the full width:
past a row's length both leave zeros). Merging one rule is the parity
scan and a fixed-shape scatter compaction whose tail past the count is
zero, so checkpoints match the JAX trainer's array for array. The scan's
last non-matching position (``lax.cummax`` of a sentinel in the JAX
trainer) is a count, a scatter and a gather here: CUDA's ``torch.cummax``
scans a long row in one block, 0.72 s a round at 256 Mi positions on an
H100. The sharded trainer keeps its ``(B, N)`` rows as one tensor on one
device and runs every row op along dim 1.

Tensors live on ``device``; None means the first CUDA device, and raises
without one. ``save_merges`` writes a merges.txt the reference loader
grammar accepts when all keys are byte pairs (hierarchical rules are
commented, since the file grammar is u8-only, config_loader.rs:144-155).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import BpeMerges
from blt_tpu_torch.utils.device import require_cuda
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("train")

_NEG_INF32 = -(2**31) + 1


def _device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


def _count_pairs(tokens: torch.Tensor, length, vocab: int) -> torch.Tensor:
    """Dense int32 (vocab*vocab,) histogram of adjacent pairs within
    [0, length) of each row: ``tokens`` int32[N] with a scalar ``length``,
    or int32[B, N] with lengths[B] (rows counted apart, summed). Positions
    outside a row's pairs add 0 to bin 0, as the JAX scatter does."""
    rows = tokens if tokens.dim() == 2 else tokens.unsqueeze(0)
    lengths = torch.as_tensor(length, dtype=torch.int32, device=tokens.device).reshape(-1, 1)
    idx = torch.arange(rows.shape[1], dtype=torch.int32, device=tokens.device)
    valid = idx < (lengths - 1)
    pair = rows.to(torch.int64) * vocab + torch.roll(rows, -1, dims=1)
    hist = torch.zeros(vocab * vocab, dtype=torch.int32, device=tokens.device)
    hist.index_add_(0, torch.where(valid, pair, 0).reshape(-1),
                    valid.to(torch.int32).reshape(-1))
    return hist


def _best(hist: torch.Tensor, length: torch.Tensor) -> Tuple[int, int, int]:
    """(pair index, count, longest length): the most frequent pair, the
    smallest index among equals (``torch.argmax`` returns the first
    maximum), its count, and the largest of ``length``, read in one
    device-to-host copy."""
    best = torch.argmax(hist).reshape(1)
    pick = torch.cat((best, hist.index_select(0, best).to(torch.int64),
                      length.reshape(-1).max().reshape(1).to(torch.int64)))
    index, count, longest = pick.tolist()
    return index, count, longest


def _last_nonmatch(match: torch.Tensor) -> torch.Tensor:
    """int32: for each position, the index of the last position at or
    before it where ``match`` is false along the last dim, ``_NEG_INF32``
    where there is none — ``cummax(where(match, _NEG_INF32, idx))``, in
    linear passes: the k-th non-match's index is scattered to slot k - 1,
    and each position gathers the slot of the non-matches counted up to
    it."""
    n = match.shape[-1]
    nonmatch = ~match
    rank = torch.cumsum(nonmatch, dim=-1)  # int64: non-matches in [0, i]
    idx = torch.arange(n, dtype=torch.int32, device=match.device).expand_as(match)
    slots = torch.zeros((*match.shape[:-1], n + 1), dtype=torch.int32, device=match.device)
    slots.scatter_(-1, torch.where(nonmatch, rank - 1, n), idx)  # matches to slot n
    last = slots.gather(-1, torch.clamp_min(rank - 1, 0))
    return torch.where(rank > 0, last, _NEG_INF32)


def _merge_starts(tokens: torch.Tensor, length: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Bool mask of the leftmost-first non-overlapping starts of the pair
    (a, b) along the last dim, within each row's ``length``: a match starts
    a merge when the run of matches it ends began an odd number of
    positions back."""
    n = tokens.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=tokens.device)
    nxt = torch.roll(tokens, -1, dims=-1)
    match = (tokens == a) & (nxt == b) & (idx < (length.unsqueeze(-1) - 1))
    if a != b:
        # matches at i and i + 1 would need tokens[i + 1] == b == a: every
        # run is one match long, so every match starts a merge
        return match
    lz = torch.clamp_min(_last_nonmatch(match), -1)
    return match & (((idx - lz) & 1) == 1)


def _compact_rule(tokens: torch.Tensor, length: torch.Tensor, starts: torch.Tensor,
                  new_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``new_id`` at each start, drop the token each start consumed
    and compact every row to its front. Returns (tokens, count) with a
    zero tail past each row's count: a scatter to index n drops a slot,
    into a buffer of n + 1 whose last column is sliced away."""
    n = tokens.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=tokens.device)
    consumed = torch.zeros_like(starts)
    consumed[..., 1:] = starts[..., :-1]
    out_vals = torch.where(starts, new_id, tokens)
    keep = ~consumed & (idx < length.unsqueeze(-1))
    pos = torch.cumsum(keep, dim=-1) - 1  # int64
    if n:
        count = (pos[..., -1] + 1).to(torch.int32)
    else:
        count = torch.zeros(tokens.shape[:-1], dtype=torch.int32, device=tokens.device)
    scatter_idx = torch.where(keep, pos, n)
    out = torch.zeros((*tokens.shape[:-1], n + 1), dtype=torch.int32, device=tokens.device)
    out.scatter_(-1, scatter_idx, out_vals)
    return out[..., :n], count


def _apply_one_rule(
    tokens: torch.Tensor,
    length: torch.Tensor,
    a: int,
    b: int,
    new_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leftmost-first non-overlapping merge pass for a single rule:
    int32[N] tokens and a 0-d ``length`` (or int32[B, N] rows and
    lengths[B]). Returns (tokens, count)."""
    starts = _merge_starts(tokens, length, a, b)
    return _compact_rule(tokens, length, starts, new_id)


def _check_vocab(num_merges: int) -> int:
    """Dense-histogram vocab guard: pair ids are tokens*vocab+nxt in int32,
    so vocab must satisfy vocab**2 <= INT32_MAX (and the (V,V) histogram
    must stay allocatable); beyond that the counts would silently wrap
    and mode="drop" would discard them, biasing training."""
    vocab = 256 + num_merges
    if vocab * vocab > 2**31 - 1:
        raise ValueError(
            f"num_merges={num_merges} needs vocab {vocab}, beyond the dense "
            "pair-histogram design limit (vocab**2 must fit int32, i.e. "
            "num_merges <= 46084)"
        )
    return vocab


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host tokens as int32 on ``device``; bytes are widened there."""
    host = arr if arr.dtype == np.uint8 else arr.astype(np.int32)
    # a read-only buffer (``np.frombuffer`` of bytes) is copied first
    host = np.require(host, requirements=("C", "W"))
    return torch.from_numpy(host).to(device).to(torch.int32)


def learn_bpe(data: bytes | np.ndarray, num_merges: int, device=None) -> BpeMerges:
    """Learn ``num_merges`` rules from a byte corpus (greedy max-frequency).

    Ties break toward the smallest pair index (deterministic). Stops early
    when no pair occurs twice.
    """
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    vocab = _check_vocab(num_merges)
    dev = _device(device)
    tokens = _upload(arr, dev)
    length = torch.tensor(arr.shape[0], dtype=torch.int32, device=dev)
    merges: BpeMerges = {}
    new_id = 256
    for _ in range(num_merges):
        best, best_count, live = _best(_count_pairs(tokens, length, vocab), length)
        if best_count < 2:
            break
        a, b = best // vocab, best % vocab
        merges[(a, b)] = new_id
        tokens, length = _apply_one_rule(tokens[:live], length, a, b, new_id)
        new_id += 1
    return merges


def save_merges(merges: BpeMerges, path) -> None:
    """Write merges.txt in the reference loader grammar.

    Only u8-pair keys are representable in the file format
    (config_loader.rs:144-155); hierarchical rules are emitted as comments.
    Rules are written in id order, so when every rule is a byte pair the
    loader re-assigns identical ids; skipped hierarchical rules shift later
    ids on reload (the file grammar cannot express them). The text is the
    JAX trainer's, byte for byte.
    """
    with open(path, "w") as f:
        f.write("# merges learned by blt_tpu.parallel.train.learn_bpe\n")
        for (a, b), v in sorted(merges.items(), key=lambda kv: kv[1]):
            if a < 256 and b < 256:
                f.write(f"{a} {b}\n")
            else:
                f.write(f"# hierarchical rule ({a},{b})->{v} not file-representable\n")


def _count_pairs_sharded(tokens: torch.Tensor, lengths: torch.Tensor, vocab: int) -> torch.Tensor:
    """Global pair histogram over a (B, N) token batch: each row counted on
    its own, summed. Row-boundary pairs are excluded — training counts are
    statistical, and skipping B-1 pairs out of ~B*N keeps every row
    independent."""
    return _count_pairs(tokens, lengths, vocab)


def _apply_one_rule_rows(tokens, lengths, a: int, b: int, new_id: int):
    """``_apply_one_rule`` on every row of a (B, N) batch along dim 1."""
    return _apply_one_rule(tokens, lengths, a, b, new_id)


def _host(x, width: Optional[int] = None) -> np.ndarray:
    """``x`` as numpy; tokens narrowed to their live width are padded back
    to ``width`` with zeros."""
    if isinstance(x, torch.Tensor):
        if width is not None and x.shape[-1] < width:
            x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
        return x.cpu().numpy()
    return np.asarray(x)


def save_checkpoint(
    path,
    merges: BpeMerges,
    tokens,
    lengths,
    new_id: int,
    width: Optional[int] = None,
) -> None:
    """Atomically persist a training state (crash-safe: tmp + rename).

    The state is the full resumable tuple: learned rules so far, the next
    rule id, and the working token rows with their live lengths (tensors
    or arrays), under the JAX trainer's ``.npz`` keys and dtypes. Token
    rows narrower than ``width`` are stored zero-padded to it.
    """
    keys = np.array(list(merges.keys()), np.int32).reshape(-1, 2)
    vals = np.array(list(merges.values()), np.int32)
    # unique tmp name (concurrent trainers must not clobber each other's
    # half-written state) + fsync before the rename: on ext4/xfs the
    # rename can become durable before the data, which would leave a
    # truncated checkpoint at the final path after a power loss
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                keys=keys,
                vals=vals,
                new_id=np.int32(new_id),
                tokens=_host(tokens, width),
                lengths=_host(lengths),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load_checkpoint(path):
    """Load a save_checkpoint file (the port's or the JAX trainer's) ->
    (merges, new_id, tokens, lengths), the arrays as numpy."""
    z = np.load(path)
    merges = {
        (int(a), int(b)): int(v) for (a, b), v in zip(z["keys"], z["vals"])
    }
    return merges, int(z["new_id"]), z["tokens"], z["lengths"]


def learn_bpe_sharded(
    batch: np.ndarray,  # uint8[B, N] corpus rows
    lengths: np.ndarray,  # int32[B]
    num_merges: int,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    device=None,
) -> BpeMerges:
    """Greedy BPE training over a row-split corpus.

    The data-parallel variant of learn_bpe: counting reduces across rows
    each round; the winning rule is applied row-locally (merges never cross
    row boundaries during training — a statistical approximation that keeps
    every row independent). Deterministic: ties break toward the smallest
    pair index.

    With ``checkpoint_path`` set and ``checkpoint_every`` > 0, the full
    training state is persisted atomically every that-many learned rules
    (and once at completion); ``resume=True`` restarts from the checkpoint
    when it exists (one written by this trainer or the JAX one), producing
    the identical final table a crash-free run would have.
    """
    vocab = _check_vocab(num_merges)
    dev = _device(device)
    merges: BpeMerges = {}
    new_id = 256
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        merges, new_id, tok_np, len_np = load_checkpoint(checkpoint_path)
        tokens = _upload(tok_np, dev)
        lens = _upload(len_np, dev)
        log.info(
            "resumed training from %s (%d rules learned)",
            checkpoint_path,
            len(merges),
        )
    else:
        tokens = _upload(batch, dev)
        lens = _upload(lengths, dev)
    width = tokens.shape[1]
    while new_id - 256 < num_merges:
        best, best_count, live = _best(_count_pairs_sharded(tokens, lens, vocab), lens)
        if best_count < 2:
            break
        a, b = best // vocab, best % vocab
        merges[(a, b)] = new_id
        tokens, lens = _apply_one_rule_rows(tokens[:, :live], lens, a, b, new_id)
        new_id += 1
        if (
            checkpoint_path
            and checkpoint_every > 0
            and (new_id - 256) % checkpoint_every == 0
        ):
            save_checkpoint(checkpoint_path, merges, tokens, lens, new_id, width)
    if checkpoint_path and checkpoint_every > 0:
        save_checkpoint(checkpoint_path, merges, tokens, lens, new_id, width)
    return merges
