"""The step backward kernel's decomposition (t2onet_tpu_torch.ops.step.plan)
at the shapes chip_smoke.py runs it: blocks per image, the work of each
block, the scratch it needs and whether the 16-byte path applies. The
kernel itself runs only on a card (chip_smoke.py phases 5 and 6)."""

import pytest
import torch

from t2onet_tpu_torch.ops import step

# (b, h, w) -> (tiles, tiles_per_block, blocks_per_image, vector)
SHAPES = {
    (9, 8, 8): (1, 1, 1, True),
    (2, 33, 97): (8, 1, 8, False),           # h*w = 3201: scalar path
    (9, 64, 1024): (64, 1, 64, True),
    (64, 128, 128): (16, 1, 16, True),       # the trainers' shape
    (128, 512, 512): (256, 4, 64, True),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_at_chip_smoke_shapes(shape):
    b, h, w = shape
    cut = step.plan(b, h, w)
    assert (cut.tiles, cut.tiles_per_block, cut.blocks_per_image,
            cut.vector) == SHAPES[shape]
    assert cut.partials == b * cut.blocks_per_image * step.NQ
    assert cut.counters == b <= step.MAX_BATCH
    # one buffer per call: the partials, then the counters, 4-byte aligned
    assert cut.scratch_bytes == 8 * cut.partials + 4 * b
    # the blocks cover every tile, and every pixel of the flat planes,
    # with no block wholly past the last tile
    run = cut.tiles_per_block * step.TILE_PIXELS
    assert cut.blocks_per_image * cut.tiles_per_block >= cut.tiles
    assert (cut.blocks_per_image - 1) * cut.tiles_per_block < cut.tiles
    assert cut.blocks_per_image * run >= h * w
    assert cut.tiles * step.TILE_PIXELS >= h * w
    # a misaligned tensor takes the scalar path
    assert not step.plan(b, h, w, aligned=False).vector


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_plan_fills_the_card_first(sms):
    """Fewer multiprocessors let a block take more tiles, never fewer, and
    the grid keeps MIN_BLOCKS_PER_SM blocks per SM when a shape allows."""
    tpb = [step.plan(b, h, w, sms=sms).tiles_per_block
           for b, h, w in sorted(SHAPES)]
    big = [step.plan(b, h, w, sms=2 * sms).tiles_per_block
           for b, h, w in sorted(SHAPES)]
    assert all(t >= u for t, u in zip(tpb, big))
    for b, h, w in sorted(SHAPES):
        cut = step.plan(b, h, w, sms=sms)
        assert cut.tiles_per_block in (1, 2, 4)
        if cut.tiles_per_block > 1:
            assert b * cut.blocks_per_image >= step.MIN_BLOCKS_PER_SM * sms


def _meta_call(b=2, h=8, w=8):
    return [torch.empty((b, 3, h, w), device="meta"),
            torch.empty((b,), dtype=torch.int32, device="meta"),
            torch.empty((b, 24), device="meta"),
            torch.empty((b, 3, h, w), device="meta")]


@pytest.mark.parametrize("fault", ["g_shape", "batch", "dtype", "noncontig",
                                   "slots_shape"])
def test_checks_before_launch(fault):
    """What a CUDA call is refused for before its launch (shapes only, on
    meta tensors): the grid's batch limit among them."""
    args = _meta_call()
    step._check(*args)
    if fault == "g_shape":
        args[3] = args[3][:1]
    elif fault == "batch":
        args = _meta_call(b=step.MAX_BATCH + 1, h=1, w=1)
    elif fault == "dtype":
        args[2] = args[2].double()
    elif fault == "noncontig":
        args[0] = torch.empty((2, 3, 8, 16), device="meta")[..., ::2]
    else:
        args[1] = args[1][:1]
    with pytest.raises((TypeError, ValueError)):
        step._check(*args)
