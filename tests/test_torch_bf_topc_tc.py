"""The tensor-core K4's host side: its gate ``topc_tc_admits``, its range
planner ``_topc_tc_ranges`` and the wrapper ``tile_topc`` on the CPU.

The kernel itself runs only on the card, where ``test_torch_bf_topk_cuda.py``
and ``chip_smoke.py`` hold it against ``tile_topc_ref``. These cases are pure
PyTorch and take milliseconds each.
"""

import numpy as np
import pytest
import torch

from torch_port_common import unit_rows
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM


@pytest.mark.parametrize("dtype,dim,tile_n,admit", [
    (torch.float32, 40, 128, True), (torch.float32, 37, 128, False),
    (torch.float32, 40, 64, False), (torch.bfloat16, 64, 4096, True),
    (torch.bfloat16, 36, 4096, False), (torch.float16, 64, 192, False),
    (torch.int8, 48, 512, True), (torch.int8, 40, 512, False), (torch.uint8, 16, 128, True),
    (torch.float64, 64, 128, False)])
def test_topc_tc_admits_widths_types_and_tiles(dtype, dim, tile_n, admit):
    # TMA loads rows of a multiple of 16 bytes in a type with a scoring lane,
    # and a tile must be whole 128-row sub-tiles to be one list of a range.
    q, x = torch.zeros((3, dim), dtype=dtype), torch.zeros((2 * tile_n, dim), dtype=dtype)
    assert bfk.topc_tc_admits(q, x, tile_n) is admit


def test_topc_tc_admits_refuses_an_unaligned_view():
    x, q = torch.zeros((257, 64), dtype=torch.bfloat16), torch.zeros((3, 64), dtype=torch.bfloat16)
    assert bfk.topc_tc_admits(q, x[1:], 128)  # a whole row in: 128 bytes, aligned
    off = x.flatten()[1:1 + 256 * 64].view(256, 64)  # 2 bytes in
    assert off.is_contiguous() and not bfk.topc_tc_admits(q, off, 128)
    assert not bfk.topc_tc_admits(q.flatten()[4:4 + 2 * 64].view(2, 64), x[1:], 128)  # 8 bytes


@pytest.mark.parametrize("B,live,sms", [
    (1024, 256, 132), (1024, 245, 132), (1, 245, 132), (130, 245, 132), (130, 125, 132),
    (1, 0, 132), (7, 1, 132), (5000, 256, 132), (64, 3, 114)])
def test_topc_tc_range_planner(B, live, sms):
    # Ranges are whole tiles, cover every live tile with no empty range, and
    # the grid is one wave of blocks of 64 queries where B allows.
    tiles, n = bfk._topc_tc_ranges(B, live, sms)
    assert tiles >= 1 and n >= 1
    assert n * tiles >= live and (n - 1) * tiles < max(live, 1)
    qblocks = -(-B // 64)
    assert n * qblocks <= max(sms, qblocks)
    want = {(1024, 256): (32, 8), (1024, 245): (31, 8), (1, 245): (2, 123),
            (130, 245): (6, 41), (130, 125): (3, 42), (1, 0): (1, 1)}
    if (B, live) in want:
        assert (tiles, n) == want[B, live]


@pytest.mark.parametrize("dtype,metric", [(torch.float32, "Cosine"), (torch.bfloat16, "L2"),
                                          (torch.uint8, "IP")])
def test_tile_topc_on_the_cpu_is_the_plain_version(dtype, metric):
    # Tensors the tensor-core gate admits still take the plain version on the
    # CPU, and count no launch of either kernel.
    rng = np.random.default_rng(4)
    if dtype == torch.uint8:
        x = torch.from_numpy(rng.integers(0, 256, size=(512, 32)).astype(np.uint8))
        q = torch.from_numpy(rng.integers(0, 256, size=(3, 32)).astype(np.uint8))
    else:
        x = torch.from_numpy(unit_rows(rng, 512, 32)).to(dtype)
        q = torch.from_numpy(unit_rows(rng, 3, 32)).to(dtype)
    aux = x.float().square().sum(1) if metric == "L2" else None
    kw = dict(metric=TM[metric], tile_n=128, c=16)
    assert bfk.topc_tc_admits(q, x, 128)
    before = (bfk.tile_topc.tc_launches, bfk.tile_topc.launches)
    d, i = bfk.tile_topc(q, x, aux, 300, **kw)
    rd, ri = bfk.tile_topc_ref(q, x, aux, 300, **kw)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert (bfk.tile_topc.tc_launches, bfk.tile_topc.launches) == before


def test_tile_topc_refuses_a_device_it_cannot_launch_on():
    # A tensor the gate admits on a device other than CUDA raises before any
    # launch is counted.
    q, x = torch.zeros((2, 64)), torch.zeros((256, 64))
    before = (bfk.tile_topc.tc_launches, bfk.tile_topc.launches)
    with pytest.raises(ValueError, match="CUDA"):
        bfk.tile_topc(q.to("meta"), x.to("meta"), None, 256, metric=TM.IP, tile_n=128, c=8)
    assert (bfk.tile_topc.tc_launches, bfk.tile_topc.launches) == before
