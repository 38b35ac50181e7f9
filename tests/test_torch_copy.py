"""The copy ring of ``blt_tpu_torch/csrc/chain.cu`` (T1 copy, T7), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py and
``chip_smoke.py`` hold it against its plain version there). Its host-side
mirror is held here: ``bpe_cuda.copy_plan``, the grid, spans and bulk
copies that ``copy_chain`` and ``copy_ring_kernel`` compute. Every byte
must be copied exactly once, by copies that are 16-byte aligned, a multiple
of 16 long and at most one stage long, each T7 block inside its own grid
step.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

from blt_tpu_torch.ops import bpe_cuda

CHAIN_CU = Path(bpe_cuda.__file__).resolve().parent.parent / "csrc" / "chain.cu"
SMS = 132  # an H100 SXM
STAGE = bpe_cuda.RING_STAGE_BYTES
SIZES = (128, STAGE - 128, STAGE + 128, (1 << 20) + 128, 64 << 20)
# T7's block counts (rows // rpb, so they divide the rows), and 0: T1's grid
CASES = list(dict.fromkeys((n, b) for n in SIZES for b in (1, 64, 256, 1024, n // 128, 0)
                           if b == 0 or (n // 128) % b == 0))


def test_mirror_constants_are_the_kernels():
    """The mirror's ring is the one chain.cu builds."""
    src = CHAIN_CU.read_text()
    ring = {name: math.prod(int(f) for f in v.split("*")) for name, v in
            re.findall(r"constexpr \w+ (kStages|kStageBytes|kBlocksPerSm) = ([\d *]+);", src)}
    assert ring == {"kStages": bpe_cuda.RING_STAGES, "kStageBytes": bpe_cuda.RING_STAGE_BYTES,
                    "kBlocksPerSm": bpe_cuda.RING_BLOCKS_PER_SM}


@pytest.mark.parametrize("n, blocks", CASES)
def test_copy_plan_copies_every_byte_once(n, blocks):
    plan = bpe_cuda.copy_plan(n, blocks, SMS)
    block, offset, length = plan["block"], plan["offset"], plan["length"]
    # each block's copies in order, the blocks in order: contiguous from 0 to n
    assert offset[0] == 0 and int(offset[-1] + length[-1]) == n
    assert np.array_equal(offset[1:], offset[:-1] + length[:-1])
    assert np.all(np.diff(block) >= 0)
    assert np.array_equal(np.unique(block), np.arange(plan["grid"]))
    # bulk copies: 16-byte edges, at most one stage
    assert np.all(offset % 16 == 0) and np.all(length % 16 == 0)
    assert np.all((length > 0) & (length <= STAGE))
    # the ring fits a block and has at most one stage per piece of a span
    assert 1 <= plan["stages"] <= bpe_cuda.RING_STAGES
    assert plan["stages"] == min(bpe_cuda.RING_STAGES, -(-plan["span"] // STAGE))
    assert plan["stages"] >= 2 or plan["span"] <= STAGE
    assert plan["smem_bytes"] <= 232448
    if blocks:
        # T7: one block per grid step of rpb rows, inside its own step
        step = n // blocks
        assert plan["grid"] == blocks and plan["span"] == step
        assert np.all(offset // step == block)
        assert np.all((offset + length - 1) // step == block)
    else:
        # T1: RING_BLOCKS_PER_SM blocks per SM, equal spans on 16-byte edges
        assert plan["grid"] <= SMS * bpe_cuda.RING_BLOCKS_PER_SM
        assert plan["span"] % 16 == 0 and plan["span"] * plan["grid"] >= n
