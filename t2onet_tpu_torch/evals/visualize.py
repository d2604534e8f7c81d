"""Per-sample web-gallery rows and attention heatmaps (counterpart of
`t2onet_tpu.evals.visualize`).

A row holds the input, the image after each executed step (captioned
with its op and parameters), the ground truth and the decoder's
attention over the request's tokens (reference utils/visualize.py:33-64,
140-162). Images are written with cv2; the heatmap with matplotlib, or
with cv2 on a host without matplotlib.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from t2onet_tpu_torch.data.text import parse_sent


def save_img(img_chw: np.ndarray, path: str):
    """(3, H, W) float in [0, 1] -> an 8-bit jpg/png on disk."""
    import cv2

    arr = (np.clip(np.asarray(img_chw), 0, 1).transpose(1, 2, 0) * 255
           ).astype(np.uint8)
    cv2.imwrite(path, arr[:, :, ::-1])          # RGB -> BGR for cv2


def _show_attention_cv2(request_tokens, op_names, attn, path):
    """The matplotlib heatmap's content drawn with cv2: one viridis cell
    per (op, token), ops down the left, tokens across the top."""
    import cv2

    cell, left, top = 40, 110, 90
    rows, cols = attn.shape
    lo, hi = float(attn.min()), float(attn.max())
    scaled = (attn - lo) / (hi - lo) if hi > lo else np.zeros_like(attn)
    heat = cv2.applyColorMap((scaled * 255).astype(np.uint8),
                             cv2.COLORMAP_VIRIDIS)
    heat = cv2.resize(heat, (cols * cell, rows * cell),
                      interpolation=cv2.INTER_NEAREST)
    canvas = np.full((top + rows * cell + 10, left + cols * cell + 10, 3),
                     255, np.uint8)
    canvas[top:top + rows * cell, left:left + cols * cell] = heat
    font, black = cv2.FONT_HERSHEY_SIMPLEX, (0, 0, 0)
    for i, name in enumerate(op_names):
        cv2.putText(canvas, str(name)[:12], (4, top + i * cell + cell // 2 + 4),
                    font, 0.4, black, 1, cv2.LINE_AA)
    for j, tok in enumerate(request_tokens):
        # tokens written upwards above their column
        label = np.full((14, top - 4, 3), 255, np.uint8)
        cv2.putText(label, str(tok)[:12], (2, 11), font, 0.4, black, 1,
                    cv2.LINE_AA)
        label = cv2.rotate(label, cv2.ROTATE_90_COUNTERCLOCKWISE)
        x = left + j * cell + (cell - label.shape[1]) // 2
        canvas[0:label.shape[0], x:x + label.shape[1]] = label
    cv2.imwrite(path, canvas)


def show_attention(request_tokens: Sequence[str], op_names: Sequence[str],
                   attn: np.ndarray, path: str):
    """Attention heatmap (ops x request tokens), reference
    visualize.py:140-162."""
    attn = np.asarray(attn)[: len(op_names), : len(request_tokens)]
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {os.path.basename(path)} "
              f"drawn with cv2")
        _show_attention_cv2(request_tokens, op_names, attn, path)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(4, len(request_tokens) * 0.6),
                                    max(2, len(op_names) * 0.5)))
    im = ax.matshow(attn, cmap="viridis")
    ax.set_xticks(range(len(request_tokens)))
    ax.set_xticklabels(request_tokens, rotation=60, fontsize=8)
    ax.set_yticks(range(len(op_names)))
    ax.set_yticklabels(op_names, fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def update_web_row(webpage, sample_id: int, request: str,
                   input_img: np.ndarray, step_imgs: np.ndarray,
                   ops: Sequence[int], params: np.ndarray,
                   id2op: dict, gt_img: Optional[np.ndarray] = None,
                   attn: Optional[np.ndarray] = None,
                   trim_params: int = 3):
    """One gallery row: input, each executed step (caption: op and its
    first `trim_params` params), then the ground truth and the attention
    heatmap when given. File names and captions are the JAX package's."""
    img_dir = webpage.get_image_dir()
    webpage.add_header(f"[{sample_id}] {request}")
    ims, txts = [], []

    name = f"{sample_id:05d}_input.jpg"
    save_img(input_img, os.path.join(img_dir, name))
    ims.append(name)
    txts.append("input")

    for i, op in enumerate(ops):
        op = int(op)
        name = f"{sample_id:05d}_step{i}.jpg"
        save_img(step_imgs[i], os.path.join(img_dir, name))
        ims.append(name)
        p = np.asarray(params[i]).ravel()[:trim_params]
        txts.append(f"{id2op.get(op, op)} {np.round(p, 3).tolist()}")

    if gt_img is not None:
        name = f"{sample_id:05d}_gt.jpg"
        save_img(gt_img, os.path.join(img_dir, name))
        ims.append(name)
        txts.append("ground truth")

    if attn is not None:
        name = f"{sample_id:05d}_attn.png"
        # label exactly the positions the encoder read: txt2idx builds
        # [START, w1..wk, END, pads], so column 0 is START and the last
        # labelled column END; a request longer than max_len - 2 words
        # was truncated, so the labels are too
        n_words = int(np.asarray(attn).shape[-1]) - 2
        toks = ["<s>"] + parse_sent(request)[:n_words] + ["</s>"]
        ops_names = [str(id2op.get(int(o), o)) for o in ops]
        show_attention(toks, ops_names, attn, os.path.join(img_dir, name))
        ims.append(name)
        txts.append("attention")

    webpage.add_images(ims, txts)
