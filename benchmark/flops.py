"""Operations and bytes, counted from shapes, and the peaks they are
divided by.

Peaks: the published NVIDIA H100 SXM data sheet, dense: 67e12 FLOP/s of
float32 outside the tensor cores (TF32 is off in every configuration
here) and 3.35e12 B/s of HBM3.

Model FLOPs count 2 for each multiply-add of every convolution, LSTM
gate product, attention product, linear layer and parameter head, and
the chain steps' arithmetic (`FWD_FLOPS`); element-wise work around them
(BatchNorm, activations, the LSTM's gate non-linearities) is left out. A
training step counts three times its forward: the backward takes a
product for the input's gradient and one for the weights'.

A kernel's least time is the larger of its bytes over the memory rate
(each input read once and each output written once) and its f32
arithmetic over the f32 rate. The arithmetic per pixel of each chain
slot is the algorithm's adds, multiplies, divisions and transcendental
calls, whatever implements them; min, max, compare and select are not
counted, so the count is a floor.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# f32 arithmetic a pixel (three channels) of one chain step, by slot:
# 0 identity, 1 brightness, 2 contrast, 3 saturation, 4 color curve,
# 5 inpaint (identity), 6 tone curve, 7 sharpness, 8 white
FWD_FLOPS = {0: 0, 1: 6, 2: 16, 3: 15, 4: 45, 5: 0, 6: 45, 7: 21, 8: 0}
MASK_FWD_FLOPS = 10           # (1 - m), then y*m + x*(1 - m) a channel
# the VJP: twice the forward's arithmetic for the image's cotangent and
# one add a pixel for each parameter sum
BWD_FLOPS = {0: 0, 1: 13, 2: 34, 3: 31, 4: 114, 5: 0, 6: 98, 7: 43, 8: 0}
MASK_BWD_FLOPS = 9


def conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def linear(fan_in: int, fan_out: int) -> int:
    return 2 * fan_in * fan_out


def _out(x: int, stride: int) -> int:
    """A 3x3 padding-1 or 1x1 padding-0 convolution's output side."""
    return (x - 1) // stride + 1


def resnet18(model: dict, h: int, w: int) -> int:
    """One image's forward through the vision encoder and its fc."""
    widths = model["resnet_widths"]
    h, w = _out(h, 2), _out(w, 2)
    total = conv(3, widths[0], 3, h, w)
    cin = widths[0]
    for planes in widths:
        h, w = _out(h, 2), _out(w, 2)
        total += conv(cin, planes, 3, h, w) + conv(planes, planes, 3, h, w)
        total += conv(cin, planes, 1, h, w)
        total += 2 * conv(planes, planes, 3, h, w)
        cin = planes
    return total + linear(cin, model["vis_feat_dim"])


def encoder(model: dict, n_tokens: int) -> int:
    """The bidirectional LSTM over one request's `n_tokens` tokens."""
    hid, total = model["hidden_size"], 0
    width = model["word_vec_dim"]
    for _ in range(model["n_layers"]):
        total += 2 * n_tokens * linear(width + hid, 4 * hid)
        width = 2 * hid
    return total


def decoder_step(model: dict) -> int:
    """One decode step of one request: the visual projection, the LSTM,
    attention over every encoder position, the op head."""
    d = 2 * model["hidden_size"]
    length = model["encoder_max_len"]
    total = linear(model["vis_feat_dim"], d)
    total += linear(model["word_vec_dim"] + d + d, 4 * d)
    total += (model["n_layers"] - 1) * linear(2 * d, 4 * d)
    total += 2 * 2 * length * d
    total += linear(2 * d, d) + linear(d, model["op_vocab_size"])
    return total


def heads(model: dict) -> int:
    d, fc = 2 * model["hidden_size"], model["operator_fc_dim"]
    return sum(linear(d, fc) + linear(fc, k)
               for k in (1, 1, 1, 24, 1, 8, 1, 1))


def serve_request(model: dict, n_tokens: int, slots, h: int, w: int,
                  probe: int) -> int:
    """One served request: the decode's full rollout at the probe (each
    step the vision encoder, a decoder step, the heads and the chosen
    op's arithmetic on the probe) and the execute of its program at
    (h, w)."""
    steps = model["decoder_max_len"]
    executed = list(slots) + [0] * (steps - len(slots))
    total = encoder(model, n_tokens)
    total += steps * (resnet18(model, probe, probe) + decoder_step(model)
                      + heads(model))
    total += sum(FWD_FLOPS[s] for s in executed) * probe * probe
    return total + sum(FWD_FLOPS[s] for s in slots) * h * w


def train_step(model: dict, batch: dict, supervised: bool) -> int:
    """One training step on a host batch. Supervised: every step's image
    through the vision encoder in one forward, the teacher-forced decode
    and the heads; episode: the rollout's vision encoder, decoder and
    heads at each step. The episode's chain steps are drawn inside the
    step and count as the identity's 0: a chain step's arithmetic is
    under 0.2% of the vision encoder's at 128 px."""
    x = batch["x"]
    b = x.shape[0]
    h, w = batch["img_x"].shape[-2:]
    total = sum(encoder(model, int((row != 0).sum())) for row in x)
    if supervised:
        n_dec = batch["y"].shape[1] - 1
        total += b * n_dec * (resnet18(model, h, w) + decoder_step(model))
        total += b * (n_dec - 1) * heads(model)
    else:
        total += b * model["decoder_max_len"] * (
            resnet18(model, h, w) + decoder_step(model) + heads(model))
    return 3 * total


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def chain_call(slots_rows, h: int, w: int, masked: bool):
    """(bytes, flops) of one chain call over (B, K) slot rows. Unmasked,
    a white step sets every pixel to 1 whatever its input, so only the
    steps after an image's last white one are needed and its input is not
    read; otherwise the input is read and the output written (and the
    mask read)."""
    n_bytes = n_flops = 0
    for row in slots_rows:
        row = [min(max(int(v), 0), 8) for v in row]
        planes = 7 if masked else 6
        if not masked and 8 in row:
            row = row[len(row) - row[::-1].index(8):]
            planes = 3
        n_bytes += planes * h * w * 4 + len(row) * (4 + 24 * 4)
        n_flops += sum(FWD_FLOPS[s] + (MASK_FWD_FLOPS if masked
                                       and s not in (0, 5) else 0)
                       for s in row) * h * w
    return n_bytes, n_flops


def step_bwd_call(slots, h: int, w: int, masked: bool):
    """(bytes, flops) of one step backward over (B,) slots: the
    identities read g and write d_img, unmasked white writes zeros, every
    other op reads the image and g (and the mask) and writes d_img; each
    image's parameters are read and their gradients written."""
    n_bytes = n_flops = 0
    for s in slots:
        s = min(max(int(s), 0), 8)
        if s in (0, 5):
            planes = 6
        elif s == 8 and not masked:
            planes = 3
        else:
            planes = 10 if masked else 9
        n_bytes += planes * h * w * 4 + 4 + 2 * 24 * 4
        n_flops += (BWD_FLOPS[s] + (MASK_BWD_FLOPS if masked
                                    and s not in (0, 5) else 0)) * h * w
    return n_bytes, n_flops


def least_seconds(n_bytes: int, n_flops: int) -> float:
    return max(n_bytes / PEAK_BYTES_S, n_flops / PEAK_F32_FLOPS)
