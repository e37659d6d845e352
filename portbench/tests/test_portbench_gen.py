"""The data a configuration's type decides: FLOAT32 rows unchanged bit for
bit, INT8 rows and queries quantized with the configuration's scale."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import cells, gen

FLOAT_CFG = {"type": "FLOAT32", "n_rows": 3000, "dim": 768, "intrinsic_dim": 48, "noise": 0.05}
TRAFFIC = {"pool_batches": 4, "batch": 32}
SEED = 2147483901
# blake2b-128 of rows, queries and labels as the harness made them before it
# knew any type but FLOAT32, on the CPU at FLOAT_CFG, TRAFFIC and SEED.
FLOAT_DIGEST = "84264ae61f763a8a1127acfca7b1a6bc"


def _digest(data) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in (data["rows"].numpy(), data["queries"].numpy(), data["labels"]):
        h.update(a.tobytes())
    return h.hexdigest()


def test_float32_data_is_unchanged_bit_for_bit():
    data = gen.make_data(FLOAT_CFG, TRAFFIC, SEED, torch.device("cpu"))
    assert data["rows"].dtype == data["queries"].dtype == torch.float32
    assert _digest(data) == FLOAT_DIGEST


@pytest.mark.parametrize("seed", [3, SEED])
def test_int8_data_is_the_float_data_quantized(seed):
    cfg = cells.load_cell("flat-s8-k10")["config"]
    cfg.update(n_rows=3000)
    scale = float(cfg["quant_scale"])
    data = gen.make_data(cfg, TRAFFIC, seed, torch.device("cpu"))
    as_float = gen.make_data(dict(cfg, type="FLOAT32"), TRAFFIC, seed, torch.device("cpu"))
    np.testing.assert_array_equal(data["labels"], as_float["labels"])
    for key in ("rows", "queries"):
        x = data[key]
        assert x.dtype == torch.int8 and x.shape[1] == 1024
        assert int(x.abs().max()) <= 127
        assert bool((x != 0).any(dim=1).all())  # no row or query is all zeros
        assert torch.equal(x, gen.quantize(as_float[key], scale))
        assert gen.clip_share(as_float[key], scale) <= 1e-3


def test_quantize_rounds_and_clips_symmetrically():
    x = torch.tensor([0.0, 0.5, 1.5, -2.5, 126.6, 127.5, 300.0, -300.0])
    assert gen.quantize(x, 1.0).tolist() == [0, 0, 2, -2, 127, 127, 127, -127]
    assert gen.clip_share(x, 1.0) == 3 / 8


def test_another_type_is_refused():
    with pytest.raises(ValueError, match="UINT8"):
        gen.make_data(dict(FLOAT_CFG, type="UINT8"), TRAFFIC, SEED, torch.device("cpu"))
