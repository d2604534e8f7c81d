"""The training cells' batches equal the system's readers' batches for
the same seed: the pool is read by the readers, and `batches` draws and
collates it as they do."""

import numpy as np
import pytest

from benchmark.drivers import train
from benchmark.tests._rehearse import make_run


@pytest.mark.parametrize("cell", ["gier_train_b64", "fivek_train_b64"])
def test_batches_equal_the_readers(cell):
    run = make_run(cell)
    data = run.config["data"]
    pool = train.load_pool(run)
    seed = 2 ** 31 + 7
    mine = train.batches(pool, 16, seed, 11, bool(data["masks"]))
    if data["dataset"] == "GIER":
        from t2onet_tpu_torch.data.gier import GIERDatasetAct

        ds = GIERDatasetAct(
            f"{run.root}/{data['dir']}", f"{run.root}/{data['vocab_dir']}",
            f"{run.root}/{data['actions']}", "train",
            data_mode=data["data_mode"], is_load_mask=True, session=3,
            train_img_size=128, wire_dtype=np.uint8)
    else:
        from t2onet_tpu_torch.data.fivek import FiveKAct

        ds = FiveKAct(f"{run.root}/{data['dir']}/images",
                      f"{run.root}/{data['dir']}/annotations",
                      f"{run.root}/{data['actions']}", "train", 1, 128,
                      op_max_len=5, wire_dtype=np.uint8)
    theirs = ds.batches(16, 3, shuffle=True, seed=seed)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert set(a) == set(b) - {"req"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("cell", ["gier_train_b64", "fivek_train_b64"])
def test_pool_check_reads_the_pool_and_a_changed_value(cell):
    """Every item of the pool equals the benchmark's own decode, and one
    value changed in a sampled item's image (and, in GIER, its mask) is
    counted."""
    import os

    from benchmark import pool_check

    run = make_run(cell)
    data = run.config["data"]
    ds = train.reader(run)
    pool = train.load_pool(run, ds)
    act = os.path.join(run.root, data["actions"])
    seed = 2 ** 31 + 9
    assert pool_check.pool_off(ds, pool, seed, 128, act) == 0
    i = pool_check.sample_items(pool, seed)[0]
    x, y, req, ops, params, masks = pool[i]
    x = x.copy()
    x[0, 0, 0] ^= 1
    if masks:
        k = sorted(masks)[0]
        masks = {**masks, k: 1.0 - masks[k]}
    pool[i] = (x, y, req, ops, params, masks)
    want = 1 + (128 * 128 if masks else 0)
    assert pool_check.pool_off(ds, pool, seed, 128, act) == want


def test_rle_string_form_round_trip():
    """The string form of a COCO RLE decodes to the mask that its runs
    describe (counts from the third on stored against two back)."""
    from benchmark.pool_check import rle_counts, rle_mask

    counts = [3, 5, 2, 40, 1, 13]

    def enc(cs):
        out = []
        for k, c in enumerate(cs):
            x = c - cs[k - 2] if k > 2 else c
            more = True
            while more:
                g = x & 31
                x >>= 5
                more = not ((x == 0 and not g & 16) or (x == -1 and g & 16))
                out.append(chr(48 + (g | (32 if more else 0))))
        return "".join(out)

    assert rle_counts(enc(counts)) == counts
    m = rle_mask({"size": [8, 8], "counts": enc(counts)})
    flat = m.T.reshape(-1)
    assert flat[:3].sum() == 0 and flat[3:8].all() and flat[8:10].sum() == 0
    assert int(m.sum()) == 5 + 40 + 13
