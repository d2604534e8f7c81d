"""Batched serving engine: requests -> op programs -> edited images
(counterpart of `t2onet_tpu.serve.ServingEngine`, its batch path).

Two stages per micro-batch of one shape bucket:

- **Decode** (request -> op program): the actor's greedy rollout at a
  fixed probe resolution (`decode_size`), on a bilinear view of each
  unpadded image resized on the device. Each step executes through the
  bank, as the JAX engine's decode does.
- **Execute** (program -> pixels): the whole program, truncated at its
  first <END>, at native resolution in one call of the chain kernel.

Each micro-batch is uploaded once as f32: that tensor feeds both the
probe view and the execute. With `u8_wire` the execute sees the image
quantized to 8 bits (clip before the cast) and its output comes back as
uint8, so the numbers are those of the JAX engine's u8 wire.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from t2onet_tpu_torch.data.text import txt2idx
from t2onet_tpu_torch.evals.bucketing import bucket_shape, pad_to_bucket
from t2onet_tpu_torch.ops.chain import fused_chain, vocab_ops_to_slots
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.precision import set_cuda_precision

END_ID = 2
MAX_PARAM = 24


def program_slots(ops):
    """Vocab-id op rows (B, S) -> chain slot ids (int32), with every slot
    at and after a row's first <END> forced to identity."""
    after = torch.cumsum((ops == END_ID).to(torch.int32), dim=1) > 0
    slots = vocab_ops_to_slots(ops)
    return torch.where(after, torch.zeros_like(slots), slots)


def resize_bilinear(imgs, h: int, w: int):
    """(B, C, H, W) f32 -> (B, C, h, w) with half-pixel sampling and no
    antialias: the sampling of cv2's INTER_LINEAR."""
    return F.interpolate(imgs, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)


@dataclass
class EditResult:
    image: np.ndarray                   # (3, h, w) f32, native resolution
    ops: List[str]                      # executor op names up to <END>
    params: List[List[float]]
    bucket: Tuple[int, int]
    latency_s: float


class ServingEngine:
    """Micro-batching two-stage server.

    :param actor: `models.actor.Actor`; moved to `device` and set to eval.
    :param vocab2id: request token vocabulary.
    :param device: where decode and execute run ("cuda" needs a card,
        and turns TF32 off; there is no fallback to the CPU).
    :param decode_size: probe resolution of the decode stage.
    :param quantum, max_side: shape buckets (see evals.bucketing).
    :param max_batch: requests per micro-batch.
    """

    def __init__(self, actor, vocab2id: Dict[str, int], *, device,
                 decode_size: int = 128, quantum: int = 64,
                 max_side: int = 1024, max_batch: int = 8,
                 encoder_max_len: int = 17, u8_wire: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("ServingEngine(device='cuda') but no CUDA "
                                   "device is available")
            set_cuda_precision()
        self.actor = actor.to(self.device).eval()
        self.vocab2id = vocab2id
        self.decode_size = decode_size
        self.quantum = quantum
        self.max_side = max_side
        self.max_batch = max_batch
        self.encoder_max_len = encoder_max_len
        self.u8_wire = u8_wire
        self.stats = {"requests": 0, "batches": 0}

    # -- stages -----------------------------------------------------------
    def _execute(self, imgs, slots, params):
        if self.u8_wire:
            imgs = imgs.to(torch.float32) / 255.0
        out = fused_chain(imgs, slots, params.contiguous())
        if self.u8_wire:
            out = torch.round(out * 255.0).to(torch.uint8)
        return out

    def _wire(self, stack):
        """The native images as the execute receives them: with the u8
        wire, clipped BEFORE the cast (uint8 wraps modulo 256)."""
        if not self.u8_wire:
            return stack
        return torch.round(torch.clamp(stack, 0.0, 1.0) * 255.0) \
            .to(torch.uint8)

    # -- host-side prep ---------------------------------------------------
    def _tokenize(self, request: str) -> np.ndarray:
        return txt2idx(request, self.vocab2id, self.encoder_max_len)[0]

    def _prep_img(self, image) -> np.ndarray:
        """f32 [0,1] CHW; an image whose long side exceeds max_side is
        downscaled, aspect kept — never cropped."""
        img = np.asarray(image, np.float32)
        h, w = img.shape[1], img.shape[2]
        if max(h, w) > self.max_side:
            scale = self.max_side / max(h, w)
            nh, nw = max(round(h * scale), 1), max(round(w * scale), 1)
            img = resize_bilinear(torch.from_numpy(img)[None], nh, nw)[0] \
                .numpy()
        return img

    # -- batch path ---------------------------------------------------------
    @torch.inference_mode()
    def edit_batch(self, images: Sequence[np.ndarray],
                   requests: Sequence[str]) -> List[EditResult]:
        """Edit (3, h, w) f32 images by their requests; images of one
        bucket run together, max_batch at a time. Order is kept."""
        t_submit = time.time()
        imgs = [self._prep_img(im) for im in images]
        tokens = [self._tokenize(r) for r in requests]
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(imgs):
            b = bucket_shape(img.shape[1], img.shape[2], self.quantum,
                             self.max_side)
            groups.setdefault(b, []).append(i)

        results: List[EditResult] = [None] * len(imgs)
        for bucket, idx in groups.items():
            for s in range(0, len(idx), self.max_batch):
                chunk = idx[s:s + self.max_batch]
                self._run_chunk(chunk, imgs, tokens, bucket, results,
                                t_submit)
        return results

    def _run_chunk(self, chunk, imgs, tokens, bucket, results, t_submit):
        padded, valids = zip(*(pad_to_bucket(imgs[i], self.quantum,
                                              self.max_side) for i in chunk))
        stack = torch.from_numpy(np.stack(padded)).to(self.device)
        x = torch.from_numpy(np.stack([tokens[i] for i in chunk])) \
            .to(self.device)
        ds = self.decode_size
        probe = torch.cat([resize_bilinear(stack[j:j + 1, :, :h, :w], ds, ds)
                           for j, (h, w) in enumerate(valids)])
        dec = self.actor.episode(x, probe)
        ops, params = dec["ops"], dec["params"]
        out = self._execute(self._wire(stack), program_slots(ops), params)
        out_np = out.cpu().numpy()
        ops_np = ops.cpu().numpy()
        params_np = params.cpu().numpy()
        for j, i in enumerate(chunk):
            h, w = valids[j]
            out_j = out_np[j, :, :h, :w]
            if self.u8_wire:
                out_j = out_j.astype(np.float32) / 255.0
            names, plist = [], []
            for step in range(ops_np.shape[1]):
                op = int(ops_np[j, step])
                if op == END_ID:
                    break
                if op >= 3:
                    names.append(OP_NAMES[op - 3])
                    plist.append(params_np[j, step].round(4).tolist())
            results[i] = EditResult(image=out_j, ops=names, params=plist,
                                    bucket=bucket,
                                    latency_s=time.time() - t_submit)
        self.stats["requests"] += len(chunk)
        self.stats["batches"] += 1

    def warmup(self, buckets: Sequence[Tuple[int, int]] = ((512, 512),)):
        """Run one request per bucket (first-use kernel build, cuDNN
        algorithm choice, allocator growth)."""
        for (h, w) in buckets:
            img = np.full((3, h, w), 0.5, np.float32)
            self.edit_batch([img], ["increase the brightness"])
