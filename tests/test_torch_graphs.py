"""`utils.graphs`, the CUDA-graph cache that the serving decode and the
supervised training step share.

On the CPU: a `None` key runs the eager code, reports "eager" and stores
nothing; the moved-weights check stays false after `load_state_dict`
(which copies in place) and turns true once a parameter's or a buffer's
storage is replaced.

On a CUDA card (marked `card`, skipped without one): a tiny function
captured at its key's first sight, whose eager result that call returns,
then replayed on new inputs bit-equal to eager, with cloned outputs that
the next replay does not overwrite and its other outputs passed through;
replaced weights make the key capture again."""

import pytest
import torch

from t2onet_tpu_torch.utils.graphs import GraphCache, Weights

torch.set_num_threads(2)


def _module():
    """Parameters, buffers and an LSTM (whose weights `.to()` flattens on
    a card)."""
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 4),
                               torch.nn.BatchNorm1d(4),
                               torch.nn.LSTM(4, 4))


def _never(*_):
    raise AssertionError("called")


# -- on the CPU ---------------------------------------------------------------

def test_none_key_runs_eagerly_and_stores_nothing():
    cache = GraphCache()
    module = _module()
    x = torch.ones(2, 4)
    calls = []

    def eager():
        calls.append(1)
        return "result", (x,)

    assert cache.run(None, module, _never, eager, _never) == ("result",
                                                              "eager")
    assert cache.run(None, module, _never, eager, _never)[1] == "eager"
    assert len(calls) == 2
    assert cache.values() == []


@pytest.mark.parametrize("replaced", ["0.weight", "1.running_mean",
                                      "2.weight_hh_l0"])
def test_weights_move_when_storage_is_replaced(replaced):
    module = _module()
    weights = Weights(module)
    assert not weights.moved()
    state = {k: v.clone() + 1 for k, v in module.state_dict().items()}
    module.load_state_dict(state)
    assert not weights.moved()
    tensor = module.state_dict(keep_vars=True)[replaced]
    with torch.no_grad():
        tensor.data = tensor.detach().clone()
    assert weights.moved()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    """Skips the test where PyTorch finds no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
@torch.no_grad()
def test_capture_then_replays_with_cloned_outputs(card):
    lin = torch.nn.Linear(4, 4).to(card)

    def fn(x):
        return x * lin.weight[0] + lin.bias, "tag"

    cache = GraphCache()

    def call(x):
        return cache.run("key", lin, fn, eager=lambda: (fn(x), (x,)),
                         replay=lambda graph: graph(x))

    x1, x2, x3 = (torch.rand(3, 4, device=card) for _ in range(3))
    (out, tag), mode = call(x1)
    assert mode == "capture" and tag == "tag"
    assert torch.equal(out, fn(x1)[0])
    (a, tag), mode = call(x2)
    assert mode == "replay" and tag == "tag"
    want_a = fn(x2)[0]
    assert torch.equal(a, want_a)
    (b, _), mode = call(x3)
    assert mode == "replay"
    assert torch.equal(b, fn(x3)[0])
    assert torch.equal(a, want_a)          # not overwritten by the replay
    (graph,) = cache.values()
    lin.weight.data = lin.weight.detach().clone()
    assert graph.weights.moved()
    (c, _), mode = call(x1)
    assert mode == "capture" and torch.equal(c, fn(x1)[0])
    (regraphed,) = cache.values()
    assert regraphed is not graph
    assert call(x2)[1] == "replay"
