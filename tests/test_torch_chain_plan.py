"""The chain kernel's decomposition (t2onet_tpu_torch.ops.chain.plan) at
the shapes chip_smoke.py runs it: blocks per image, the work of each block,
the tile path's pixels per thread, the shared memory and whether the
16-byte path applies; and what a CUDA call is refused for before its
launch. The kernel itself runs only on a card (chip_smoke.py phases 4-6)."""

import re

import pytest
import torch

from t2onet_tpu_torch.ops import build, chain, step

# (b, h, w, k) -> (tiles_per_block, blocks_per_image, vector,
#                  pixels_per_thread, smem_bytes)
SHAPES = {
    (128, 512, 512, 5): (4, 64, True, 7, 21168),  # bench.py's draw
    (8, 512, 512, 5): (2, 128, True, 7, 21168),   # serving
    (8, 384, 640, 5): (2, 120, True, 7, 21168),
    (1, 64, 1024, 5): (1, 64, True, 7, 21168),
    (3, 320, 448, 5): (1, 140, True, 7, 21168),
    (2, 33, 97, 5): (1, 8, False, 7, 21168),      # h*w = 3201
    (4, 128, 128, 5): (1, 16, True, 7, 21168),
    (64, 128, 128, 1): (1, 16, True, 5, 13872),   # the fused step
    (128, 512, 512, 1): (4, 64, True, 5, 13872),
    (3, 320, 448, 8): (1, 140, True, 9, 27648),   # GIER's K
    (2, 33, 97, 16): (1, 8, False, 16, 49152),    # MAX_STEPS
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_at_chip_smoke_shapes(shape):
    b, h, w, k = shape
    cut = chain.plan(b, h, w, k)
    assert tuple(cut) == SHAPES[shape]
    # the blocks cover every 32x32 tile (the kernel counts them as here),
    # and every pixel of the flat planes, with no block wholly past the
    # last tile
    tiles = -(-h // chain.TILE) * -(-w // chain.TILE)
    run = cut.tiles_per_block * chain.TILE_PIXELS
    assert cut.blocks_per_image * cut.tiles_per_block >= tiles
    assert (cut.blocks_per_image - 1) * cut.tiles_per_block < tiles
    assert cut.blocks_per_image * run >= h * w
    # the tile path's registers hold a tile and a k-pixel halo, with the
    # smallest instantiation that does; the planes fit in shared memory
    side = chain.TILE + 2 * k
    assert cut.pixels_per_thread * chain.THREADS >= side * side
    smaller = [n for n in chain.INSTANCES if n < cut.pixels_per_thread]
    assert all(n * chain.THREADS < side * side for n in smaller)
    assert cut.smem_bytes == 3 * side * side * 4 <= chain.SMEM_LIMIT
    # a misaligned tensor takes the scalar path
    assert not chain.plan(b, h, w, k, aligned=False).vector


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_plan_fills_the_card_first(sms):
    """Fewer multiprocessors let a block take more tiles, never fewer, and
    the grid keeps WAVES times the blocks the card holds at once
    (INSTANCES: blocks per SM by pixels per thread) when a shape allows."""
    tpb = [chain.plan(*s, sms=sms).tiles_per_block for s in sorted(SHAPES)]
    big = [chain.plan(*s, sms=2 * sms).tiles_per_block
           for s in sorted(SHAPES)]
    assert all(t >= u for t, u in zip(tpb, big))
    for b, h, w, k in sorted(SHAPES):
        cut = chain.plan(b, h, w, k, sms=sms)
        assert cut.tiles_per_block in (1, 2, 4)
        if cut.tiles_per_block > 1:
            assert b * cut.blocks_per_image >= \
                chain.WAVES * chain.INSTANCES[cut.pixels_per_thread] * sms


@pytest.mark.parametrize("h,w,aligned,vector", [
    (8, 8, True, True), (33, 97, True, False), (2, 2, True, True),
    (1, 6, True, False), (64, 64, False, False)])
def test_plan_vector_flag(h, w, aligned, vector):
    """16-byte accesses only where every image's planes start on a 16-byte
    boundary: h*w % 4 == 0 and aligned tensors."""
    assert chain.plan(2, h, w, 3, aligned=aligned).vector is vector


def test_plan_pixels_per_thread_by_k():
    """K maps to the smallest instantiation holding (32 + 2K)^2 pixels;
    past MAX_STEPS there is none (0), and the checks refuse the call."""
    got = {k: chain.plan(1, 64, 64, k).pixels_per_thread for k in range(18)}
    assert got == {0: 5, 1: 5, 2: 7, 3: 7, 4: 7, 5: 7, 6: 9, 7: 9, 8: 9,
                   9: 16, 10: 16, 11: 16, 12: 16, 13: 16, 14: 16, 15: 16,
                   16: 16, 17: 0}


def _source(name):
    with open(build.sources()[name]) as f:
        return f.read()


def test_kernel_constants_match_the_wrappers():
    """The constants that the .cu files and the wrappers share: the tile
    path's instantiations with their blocks per SM, the longest chain, the
    threads of a block; the step backward's blocks per SM."""
    src = _source("chain")
    cases = re.findall(r"launch_np<kMasked, (\d+), (\d+)>", src)
    assert {int(n): int(m) for n, m in cases} == chain.INSTANCES
    assert len(cases) == len(chain.INSTANCES)
    assert int(re.search(r"kMaxSteps = (\d+);", src).group(1)) == \
        chain.MAX_STEPS
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == \
        chain.THREADS
    assert int(re.search(r"kMinBlocks = (\d+);", _source("step_bwd"))
               .group(1)) == step.MIN_BLOCKS_PER_SM


def _meta_call(b=2, k=3, h=8, w=8):
    return [torch.empty((b, 3, h, w), device="meta"),
            torch.empty((b, k), dtype=torch.int32, device="meta"),
            torch.empty((b, k, 24), device="meta")]


@pytest.mark.parametrize("fault", ["batch", "too_long", "dtype", "noncontig",
                                   "slots_shape", "params_shape"])
def test_checks_before_launch(fault):
    """What a CUDA call is refused for before its launch (shapes only, on
    meta tensors): the grid's batch limit and the longest chain among
    them. The longest chain the kernel takes passes."""
    chain._check(*_meta_call(k=chain.MAX_STEPS))
    args = _meta_call()
    if fault == "batch":
        args = _meta_call(b=chain.MAX_BATCH + 1, h=1, w=1)
    elif fault == "too_long":
        args = _meta_call(k=chain.MAX_STEPS + 1)
    elif fault == "dtype":
        args[2] = args[2].double()
    elif fault == "noncontig":
        args[0] = torch.empty((2, 3, 8, 16), device="meta")[..., ::2]
    elif fault == "slots_shape":
        args[1] = args[1][:1]
    else:
        args[2] = args[2][:, :, :8]
    with pytest.raises((TypeError, ValueError)):
        chain._check(*args)
