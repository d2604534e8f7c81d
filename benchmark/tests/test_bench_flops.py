"""The FLOP and byte counters against counts made by hand at tiny
shapes."""

from benchmark import flops

TINY = {"resnet_widths": [1, 1, 1, 1], "vis_feat_dim": 1, "hidden_size": 1,
        "word_vec_dim": 1, "n_layers": 2, "encoder_max_len": 3,
        "op_vocab_size": 2, "operator_fc_dim": 1, "decoder_max_len": 2}


def test_resnet18_by_hand():
    # 8x8 in: stem 3x3 s2 -> 4x4 (2*3*9*16); stage 1 at 2x2: block 0 two
    # 3x3 (2*9*4 each) and the 1x1 shortcut (2*4), block 1 two 3x3;
    # stages 2-4 at 1x1: 4 3x3 (2*9) and a 1x1 (2); fc 2
    stem = 2 * 3 * 9 * 16
    stage1 = 4 * 2 * 9 * 4 + 2 * 4
    later = 3 * (4 * 2 * 9 + 2)
    assert flops.resnet18(TINY, 8, 8) == stem + stage1 + later + 2


def test_lstm_attention_heads_by_hand():
    # encoder: 2 directions x 2 layers x tokens x 2*4H*(in+H), in 1 then 2
    assert flops.encoder(TINY, 3) == 3 * 2 * (2 * 4 * 2 + 2 * 4 * 3)
    # decoder, hidden 2: vis 2*1*2, LSTM l0 2*(1+2+2)*8, l1 2*4*8,
    # attention 2*2*3*2, out 2*4*2 + 2*2*2
    assert flops.decoder_step(TINY) == (4 + 80 + 64 + 24 + 16 + 8)
    # heads: 8 x 2*2*1 and 2*1*k, k summing to 38
    assert flops.heads(TINY) == 8 * 4 + 2 * 38


def test_chain_and_step_bytes_by_hand():
    # one 2x2 image, one brightness step: read and write 3 planes of 4
    # f32 values, one slot and 24 params
    b, f = flops.chain_call([[1]], 2, 2, masked=False)
    assert b == 6 * 4 * 4 + 4 + 96 and f == 6 * 4
    # a white step first and brightness after: input not read
    b, f = flops.chain_call([[8, 1]], 2, 2, masked=False)
    assert b == 3 * 4 * 4 + 4 + 96 and f == 6 * 4
    # masked: the mask plane is read, each op step blends (10 a pixel)
    b, f = flops.chain_call([[8]], 2, 2, masked=True)
    assert b == 7 * 4 * 4 + 4 + 96 and f == 10 * 4
    b, f = flops.step_bwd_call([0, 1], 2, 2, masked=False)
    assert b == (6 + 9) * 4 * 4 + 2 * (4 + 2 * 96) and f == 13 * 4
    assert flops.least_seconds(3.35e12, 0) == 1.0
    assert flops.least_seconds(0, 67e12) == 1.0


def test_serve_and_train_counts_compose():
    import numpy as np

    one = flops.serve_request(TINY, 3, [1], 2, 2, 8)
    steps = 2 * (flops.resnet18(TINY, 8, 8) + flops.decoder_step(TINY)
                 + flops.heads(TINY))
    assert one == flops.encoder(TINY, 3) + steps + 6 * 64 + 6 * 4
    batch = {"x": np.array([[1, 5, 2, 0]]), "img_x": np.zeros((1, 3, 8, 8)),
             "y": np.zeros((1, 4))}
    sup = flops.train_step(TINY, batch, True)
    assert sup == 3 * (flops.encoder(TINY, 3) + 3 * (
        flops.resnet18(TINY, 8, 8) + flops.decoder_step(TINY))
        + 2 * flops.heads(TINY))
