"""Batched serving engine: requests -> op programs -> edited images
(counterpart of `t2onet_tpu.serve`).

Two stages per micro-batch of one shape bucket:

- **Decode** (request -> op program): the actor's greedy rollout at a
  fixed probe resolution (`decode_size`), on a bilinear view of each
  unpadded image resized on the device; with `decode_native` on the
  padded native stack itself, as the JAX engine's. Each step executes
  through the bank, as the JAX engine's decode does.
- **Execute** (program -> pixels): the whole program, truncated at its
  first <END>, at native resolution in one call of the chain kernel, or
  with `use_pallas=False` step by step through the bank.

Each micro-batch is uploaded once as f32: that tensor feeds both the
probe view and the execute. With `u8_wire` the execute sees the image
quantized to 8 bits (clip before the cast) and its output comes back as
uint8, so the numbers are those of the JAX engine's u8 wire.

The engine runs over a device mesh (`mesh=`, `parallel.mesh.Mesh`; a
single device is a mesh of one). It keeps a replica of the actor and a
CUDA stream on each distinct device. Each micro-batch is padded to a
multiple of the mesh size with its last request (as the JAX engine
pads), cut into the mesh's row blocks, each block decoded on its device
and executed through `fused_chain_sharded` (one chain kernel a shard),
and its outputs copied back into the batch's host buffers in request
order.

On CUDA devices the engine pipelines, as the JAX engine does with async
dispatch: `launch` stacks each micro-batch into pinned host memory,
uploads it, decodes and executes it on the engine's CUDA streams, copies
the outputs into pinned host buffers without blocking and records an
event a device after the copies; it returns while the card works.
`readback` waits on each batch's events and assembles the results, in
`io_threads` threads. The decode reads nothing back from the device (the
request lengths go to the encoder from the host), so the host stacks
batch k+1 while the card runs batch k.

On a CUDA device the decode after the request encoder (`Actor.rollout`,
about 1,700 operations for five steps) replays a CUDA graph through
`utils.graphs`, one for each device and decode input shape, so one for
each row count at the probe. The encoder stays eager: its packing takes
each request's length from the host. So do the probe resize and the
execute. The first sight of a shape runs eagerly, which serves its rows,
and then captures; `stats` counts `decode_calls` (row blocks decoded),
`decode_graph_captures` and `decode_graph_replays`. On the CPU the
decode runs eagerly.

While spans are recorded (`utils.profiling`) a micro-batch's launch is
`serve.launch` (its batch id, bucket, size and request ids), holding
`serve.launch.stack` (padding and stacking into pinned memory) and
`serve.launch.decode` (the decode as the host enqueues it; `graphed`:
whether it replays a graph); the
batcher's waits are `serve.batcher.readback` and `serve.batcher.linger`.
`stats["queue_wait_s"]` sums each launched request's wait from submit to
its micro-batch's launch.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from t2onet_tpu_torch.data.text import txt2idx
from t2onet_tpu_torch.evals.bucketing import bucket_shape, pad_to_bucket
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops.chain import fused_chain_sharded, vocab_ops_to_slots
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.parallel.mesh import Mesh, as_mesh, shard_rows
from t2onet_tpu_torch.precision import set_cuda_precision
from t2onet_tpu_torch.utils.graphs import GraphCache
from t2onet_tpu_torch.utils.profiling import span

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


@dataclass
class _Pending:
    img: np.ndarray
    x_idx: np.ndarray
    t_submit: float
    rid: int                            # the request's id in its engine
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[EditResult] = None
    error: Optional[BaseException] = None


@dataclass
class _InFlight:
    """A launched micro-batch: its id, its requests, their valid (h, w),
    the bucket, and its outputs on the host (pinned on a CUDA device,
    written by copies that `events` follow, one a device; none on the
    CPU)."""
    batch: int
    chunk: List[_Pending]
    valids: List[Tuple[int, int]]
    bucket: Tuple[int, int]
    out: torch.Tensor                   # (B, 3, H, W) uint8 or f32
    meta: torch.Tensor                  # (B, S + S * 24) f32: ops, params
    events: List[torch.cuda.Event]


def _rollout(actor, enc_out, h, c, valid, dec_in):
    """The greedy decode after the request encoder, (ops, params): what
    the decode graph captures."""
    out = actor.rollout((enc_out, (h, c), valid), dec_in)
    return out["ops"], out["params"]


class ServingEngine:
    """Micro-batching two-stage server.

    :param actor: `models.actor.Actor`; moved to `device` and set to eval.
    :param vocab2id: request token vocabulary.
    :param device: where decode and execute run ("cuda" needs a card,
        and turns TF32 off; there is no fallback to the CPU): the mesh of
        this one device when no mesh is given.
    :param decode_size: probe resolution of the decode stage.
    :param quantum, max_side: shape buckets (see evals.bucketing).
    :param max_batch: requests per micro-batch.
    :param decode_native: decode on the padded native stack instead of
        the probe (the reference's programs).
    :param use_pallas: execute through the chain kernel; False executes
        step by step through the bank (the name is the JAX engine's).
    :param mesh: optional `parallel.mesh.Mesh` (or a sequence of
        devices) in place of `device`: micro-batches shard over it, a
        replica of the actor on each distinct device; max_batch must
        divide by its size.
    :param io_threads: threads that wait on launched micro-batches and
        assemble their results (1: the caller's thread, serially).
    """

    def __init__(self, actor, vocab2id: Dict[str, int], *, device=None,
                 decode_size: int = 128, quantum: int = 64,
                 max_side: int = 1024, max_batch: int = 8,
                 decode_native: bool = False, encoder_max_len: int = 17,
                 use_pallas: bool = True, u8_wire: bool = True, mesh=None,
                 io_threads: int = 8):
        if (device is None) == (mesh is None):
            raise ValueError("ServingEngine takes a device or a mesh")
        if mesh is None:
            mesh = [device]
        devices = mesh.devices if isinstance(mesh, Mesh) else mesh
        self._cuda = any(torch.device(d).type == "cuda" for d in devices)
        if self._cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("ServingEngine(device='cuda') but no CUDA "
                                   "device is available")
            set_cuda_precision()
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.devices[0]
        if max_batch % self.mesh.size:
            raise ValueError(f"max_batch {max_batch} not divisible by mesh "
                             f"size {self.mesh.size}")
        self.actor = actor.to(self.device).eval()
        # the actor on each distinct device of the mesh
        self.replicas = {self.device: self.actor}
        for d in self.mesh.distinct:
            if d not in self.replicas:
                self.replicas[d] = copy.deepcopy(self.actor).to(d).eval()
        self.vocab2id = vocab2id
        self.decode_size = decode_size
        self.quantum = quantum
        self.max_side = max_side
        self.max_batch = max_batch
        self.decode_native = decode_native
        self.encoder_max_len = encoder_max_len
        self.use_pallas = use_pallas
        self.u8_wire = u8_wire
        self.io_threads = max(1, io_threads)
        self._io_pool = None
        self._streams = {}              # a CUDA stream a device, at first use
        self.graphs = GraphCache()      # the decode's, by `_graph_key`
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        # requests and micro-batches answered, host seconds launching and
        # reading back, the launched requests' summed wait from submit to
        # the start of their micro-batch's launch, and row blocks decoded,
        # by a graph's replay or capture among them
        self.stats = {"requests": 0, "batches": 0, "launch_s": 0.0,
                      "sync_s": 0.0, "queue_wait_s": 0.0, "decode_calls": 0,
                      "decode_graph_replays": 0, "decode_graph_captures": 0}
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()

    # -- stages -----------------------------------------------------------
    def _decode(self, x, dec_in, host_lengths, device, sp=None):
        """The greedy rollout of one row block on `device`: (ops (rows, S),
        params (rows, S, 24)). The request encoder runs eagerly; on a CUDA
        device the rest replays the graph of its `_graph_key`, or at the
        key's first sight, or once the actor's weights have moved, runs
        eagerly and then captures one (`utils.graphs`). The span `sp`, if
        given, says whether this call replayed (`graphed`)."""
        actor = self.replicas[device]
        enc_out, (h, c), valid = actor.lang_encoder(x, host_lengths)
        inputs = (enc_out, h, c, valid, dec_in)
        rollout = functools.partial(_rollout, actor)
        (ops, params), mode = self.graphs.run(
            self._graph_key(device, dec_in), actor, rollout,
            eager=lambda: (rollout(*inputs), inputs),
            replay=lambda graph: graph(*inputs))
        with self._lock:
            self.stats["decode_calls"] += 1
            if mode == "replay":
                self.stats["decode_graph_replays"] += 1
            elif mode == "capture":
                self.stats["decode_graph_captures"] += 1
        if sp is not None:
            sp.set(graphed=mode == "replay")
        return ops, params

    @staticmethod
    def _graph_key(device, dec_in):
        """The decode graph a row block replays: one for each device and
        decode input shape (rows included) on a CUDA device; None (eager)
        elsewhere."""
        if device.type != "cuda":
            return None
        return device, tuple(dec_in.shape)

    def _execute(self, imgs, slots, params):
        """Execute a batch: lists of its shards over the mesh, each on its
        device (one `fused_chain_sharded` call)."""
        if self.u8_wire:
            imgs = [i.to(torch.float32) / 255.0 for i in imgs]
        params = [p.contiguous() for p in params]
        if self.use_pallas:
            outs = fused_chain_sharded(imgs, slots, params, self.mesh)
        else:
            outs = [self._bank_chain(*a) for a in zip(imgs, slots, params)]
        if self.u8_wire:
            outs = [torch.round(o * 255.0).to(torch.uint8) for o in outs]
        return outs

    @staticmethod
    def _bank_chain(imgs, slots, params):
        out = imgs
        for k in range(slots.shape[1]):
            vocab_ids = torch.where(slots[:, k] == 0, 0,
                                    slots[:, k] + 2).long()
            out, _ = bank.execute_bank(out, vocab_ids, params[:, k])
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
        downscaled, aspect kept — never cropped. The downscale weighs in
        f64 and casts back, as the native resize of the JAX engine does
        (an f32 resize sits up to 9e-5 from it)."""
        img = np.asarray(image, np.float32)
        h, w = img.shape[1], img.shape[2]
        if max(h, w) > self.max_side:
            scale = self.max_side / max(h, w)
            nh, nw = max(round(h * scale), 1), max(round(w * scale), 1)
            img64 = torch.from_numpy(img.astype(np.float64))[None]
            img = resize_bilinear(img64, nh, nw)[0].numpy().astype(np.float32)
        return img

    def _host(self, shape, dtype):
        """A host buffer: pinned where a card runs (non-blocking copies)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def _stream(self, device):
        """The engine's CUDA stream on `device`: one a device, whichever
        thread asks first."""
        with self._lock:
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            return self._streams[device]

    @contextlib.contextmanager
    def _on_streams(self):
        """The engine's CUDA stream on each CUDA device of the mesh as the
        current one there, each first waiting for the caller's stream,
        where the weights were written. Nothing on the CPU."""
        with contextlib.ExitStack() as streams:
            for d in self.mesh.distinct:
                if d.type == "cuda":
                    stream = self._stream(d)
                    stream.wait_stream(torch.cuda.current_stream(d))
                    streams.enter_context(torch.cuda.stream(stream))
            yield

    # -- batch path ---------------------------------------------------------
    def edit_batch(self, images: Sequence[np.ndarray],
                   requests: Sequence[str]) -> List[EditResult]:
        """Edit (3, h, w) f32 images by their requests; images of one
        bucket run together, max_batch at a time. Order is kept."""
        pending = [_Pending(img=self._prep_img(im), x_idx=self._tokenize(r),
                            t_submit=time.time(),
                            rid=next(self._request_ids))
                   for im, r in zip(images, requests)]
        self._process(pending)
        return [p.result for p in pending]

    def submit(self, image: np.ndarray, request: str) -> _Pending:
        """Enqueue one request; returns a handle with .done / .result /
        .error. flush() (or a MicroBatcher) processes the queue."""
        p = _Pending(img=self._prep_img(image),
                     x_idx=self._tokenize(request), t_submit=time.time(),
                     rid=next(self._request_ids))
        with self._lock:
            self._queue.append(p)
        return p

    def flush(self) -> int:
        """Process everything queued; returns the number of requests.

        Never raises into the caller (the MicroBatcher thread): a failed
        batch marks every unserved request with .error and sets .done, so
        that waiters unblock and the server stays up."""
        todo = self._take()
        if todo:
            try:
                self._process(todo)
            except Exception as e:  # noqa: BLE001 — serving boundary
                traceback.print_exc()
                _mark_failed(todo, e)
        return len(todo)

    def _take(self) -> List[_Pending]:
        """Pop everything queued."""
        with self._lock:
            todo, self._queue = self._queue, []
        return todo

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats_snapshot(self) -> dict:
        """A consistent copy of the counters (for /healthz): they are
        written under the lock."""
        with self._lock:
            return dict(self.stats)

    def oldest_submit(self) -> Optional[float]:
        with self._lock:
            return min((p.t_submit for p in self._queue), default=None)

    # -- pipeline ------------------------------------------------------------
    def _launch_iter(self, pending: List[_Pending]):
        """Upload, decode and execute each micro-batch, yielding its
        in-flight record as soon as it is queued on the device."""
        groups: Dict[Tuple[int, int], List[_Pending]] = {}
        for p in pending:
            b = bucket_shape(p.img.shape[1], p.img.shape[2], self.quantum,
                             self.max_side)
            groups.setdefault(b, []).append(p)
        for bucket, group in groups.items():
            for i in range(0, len(group), self.max_batch):
                chunk = group[i:i + self.max_batch]
                batch = next(self._batch_ids)
                t0 = time.time()
                with span("serve.launch", batch=batch, bucket=bucket,
                          n=len(chunk), requests=[p.rid for p in chunk]):
                    rec = self._launch_chunk(chunk, bucket, batch)
                launch_s = time.time() - t0
                wait_s = sum(t0 - p.t_submit for p in chunk)
                with self._lock:
                    self.stats["launch_s"] += launch_s
                    self.stats["queue_wait_s"] += wait_s
                yield rec

    def _decode_input(self, stack_d, valids):
        """The decode's input: the padded stack itself (decode_native), or
        each image's valid region resized to the probe on the device."""
        if self.decode_native:
            return stack_d
        ds = self.decode_size
        return torch.cat([resize_bilinear(stack_d[j:j + 1, :, :h, :w], ds, ds)
                          for j, (h, w) in enumerate(valids)])

    @torch.inference_mode()
    def _launch_chunk(self, chunk: List[_Pending], bucket,
                      batch: int) -> _InFlight:
        """Pad the micro-batch to a multiple of the mesh size with its
        last request, upload, decode and execute each row block on its
        device, and copy every output into the batch's host buffers
        (pinned where a card runs, with an event a card after the
        copies)."""
        m = self.mesh
        n = len(chunk)
        pad = (-n) % m.size
        with span("serve.launch.stack"):
            padded, valids = zip(*(pad_to_bucket(p.img, self.quantum,
                                                 self.max_side)
                                   for p in chunk))
            valids_p = list(valids) + [valids[-1]] * pad
            stack = self._host((n + pad, 3) + bucket, torch.float32)
            np.stack(list(padded) + [padded[-1]] * pad, out=stack.numpy())
            tokens = self._host((n + pad, self.encoder_max_len), torch.int64)
            np.stack([p.x_idx for p in chunk] + [chunk[-1].x_idx] * pad,
                     out=tokens.numpy())
            host_lengths = (tokens != 0).sum(dim=1)
        rows = shard_rows(n + pad, m)
        with self._on_streams():
            wires, ops, params = [], [], []
            for r, d in zip(rows, m.devices):
                stack_d = stack[r].to(d, non_blocking=True)
                with span("serve.launch.decode") as sp:
                    dec_in = self._decode_input(stack_d, valids_p[r])
                    o, p = self._decode(tokens[r].to(d, non_blocking=True),
                                        dec_in, host_lengths[r], d, sp)
                wires.append(self._wire(stack_d))
                ops.append(o)
                params.append(p)
            outs = self._execute(wires, [program_slots(o) for o in ops],
                                 params)
            out_h = self._host((n + pad,) + tuple(outs[0].shape[1:]),
                               outs[0].dtype)
            meta_h = self._host((n + pad, ops[0].shape[1] * (1 + MAX_PARAM)),
                                torch.float32)
            for r, out, o, p in zip(rows, outs, ops, params):
                out_h[r].copy_(out, non_blocking=True)
                meta_h[r].copy_(torch.cat([o.to(torch.float32),
                                           p.reshape(p.shape[0], -1)], dim=1),
                                non_blocking=True)
            events = [self._record(d) for d in m.distinct
                      if d.type == "cuda"]
        return _InFlight(batch, list(chunk), list(valids), bucket,
                         out_h[:n], meta_h[:n], events)

    def _record(self, device):
        """An event on the engine's stream of `device`, after the work
        queued there."""
        event = torch.cuda.Event()
        event.record(self._streams[device])
        return event

    def launch(self, pending: List[_Pending]) -> List[_InFlight]:
        """Launch every micro-batch; returns the in-flight records for
        `readback` (the MicroBatcher's launch-ahead handle)."""
        return list(self._launch_iter(pending))

    def _ensure_pool(self):
        if self._io_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._io_pool = ThreadPoolExecutor(
                max_workers=self.io_threads, thread_name_prefix="serve-io")
        return self._io_pool

    @torch.inference_mode()
    def _assemble(self, rec: _InFlight) -> None:
        """Wait for a launched batch's copies, then set each request's
        result and .done."""
        for event in rec.events:
            event.synchronize()
        out_np, meta_np = rec.out.numpy(), rec.meta.numpy()
        n_steps = meta_np.shape[1] // (1 + MAX_PARAM)
        ops_np = meta_np[:, :n_steps].astype(np.int32)
        params_np = meta_np[:, n_steps:].reshape(
            meta_np.shape[0], n_steps, MAX_PARAM)
        for j, p in enumerate(rec.chunk):
            h, w = rec.valids[j]
            # a copy: the pinned buffer goes back to the allocator
            out_j = (out_np[j, :, :h, :w].astype(np.float32) / 255.0
                     if self.u8_wire else out_np[j, :, :h, :w].copy())
            names, plist = [], []
            for s in range(n_steps):
                op = int(ops_np[j, s])
                if op == END_ID:
                    break
                if op >= 3:
                    names.append(OP_NAMES[op - 3])
                    plist.append(params_np[j, s].round(4).tolist())
            p.result = EditResult(image=out_j, ops=names, params=plist,
                                  bucket=rec.bucket,
                                  latency_s=time.time() - p.t_submit)
            p.done.set()
        with self._lock:
            self.stats["requests"] += len(rec.chunk)
            self.stats["batches"] += 1

    def readback(self, inflight: Iterable[_InFlight]) -> None:
        """Wait for the launched batches and assemble their results. With
        io_threads > 1 each batch goes to the IO pool the moment the
        iterable yields it, so that batch k's wait and assembly overlap
        the launch of batches k+1.. when it is `_launch_iter`."""
        t1 = time.time()
        if self.io_threads > 1:
            pool = self._ensure_pool()
            for f in [pool.submit(self._assemble, rec) for rec in inflight]:
                f.result()
        else:
            for rec in inflight:
                self._assemble(rec)
        with self._lock:
            self.stats["sync_s"] += time.time() - t1

    def _process(self, pending: List[_Pending]) -> None:
        """Launch every micro-batch and read it back: through the IO pool
        as each is launched, or all launched first with one IO thread."""
        self.readback(self._launch_iter(pending) if self.io_threads > 1
                      else self.launch(pending))

    def warmup(self, buckets: Sequence[Tuple[int, int]] = ((512, 512),)):
        """Run one request per bucket (first-use kernel build, cuDNN
        algorithm choice, allocator growth)."""
        for (h, w) in buckets:
            img = np.full((3, h, w), 0.5, np.float32)
            self.edit_batch([img], ["increase the brightness"])

    @torch.inference_mode()
    def device_compute_probe(self, size: int = 512, iters: int = 10,
                             request: str = "increase the brightness"):
        """Decode + execute ms per micro-batch of max_batch requests with
        the inputs already on the mesh's devices and nothing read back but
        a barrier: the part of serving's cost that host transfers and host
        preparation do not move. Best of 3 runs of `iters` calls. Call
        warmup() first."""
        n = self.max_batch
        per = n // self.mesh.size
        x_np = np.stack([self._tokenize(request)] * per)
        host_lengths = torch.from_numpy((x_np != 0).sum(axis=1))
        ps = size if self.decode_native else self.decode_size
        shards = [(d, torch.from_numpy(x_np).to(d),
                   self._wire(torch.full((per, 3, size, size), 0.5,
                                         device=d)),
                   torch.full((per, 3, ps, ps), 0.5, device=d))
                  for d in self.mesh.devices]

        def once():
            with self._on_streams():
                decoded = [self._decode(x, dec, host_lengths, d)
                           for d, x, _, dec in shards]
                return self._execute([native for _, _, native, _ in shards],
                                     [program_slots(o) for o, _ in decoded],
                                     [p for _, p in decoded])

        def barrier(outs):
            for d in self.mesh.distinct:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            return [o[0, 0, 0, :1].cpu() for o in outs]

        barrier(once())
        best = float("inf")
        for _trial in range(3):
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = once()
            barrier(out)
            best = min(best, (time.perf_counter() - t0) / iters)
        return {"device_ms_per_batch": round(best * 1e3, 2),
                "device_ms_per_req": round(best * 1e3 / n, 3),
                "probe_batch": n, "img": f"{size}px"}


def _mark_failed(pending: List[_Pending], error: BaseException) -> None:
    for p in pending:
        if p.result is None and not p.done.is_set():
            p.error = error
            p.done.set()


class MicroBatcher:
    """A background thread that drains a ServingEngine's queue: it fires
    when `max_batch` requests wait or the oldest has lingered `linger_ms`.

    pipeline_depth > 1 keeps that many launched micro-batches in flight
    before it waits for the oldest: batch k+1's host preparation, upload
    and device work run while batch k's results come back. `stop` drains
    what is in flight and then the queue."""

    def __init__(self, engine: ServingEngine, linger_ms: float = 10.0,
                 pipeline_depth: int = 2):
        self.engine = engine
        self.linger_s = linger_ms / 1e3
        self.pipeline_depth = max(1, pipeline_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)
        self.engine.flush()

    def _take_ready(self):
        """Pop everything queued if the fire condition holds, else []."""
        depth = self.engine.queue_depth()
        if depth == 0:
            return []
        oldest = self.engine.oldest_submit() or time.time()
        if (depth >= self.engine.max_batch
                or time.time() - oldest >= self.linger_s):
            return self.engine._take()
        return []

    def _readback(self, batch, recs):
        try:
            with span("serve.batcher.readback",
                      batches=[r.batch for r in recs]):
                self.engine.readback(recs)
        except Exception as e:  # noqa: BLE001 — serving boundary
            traceback.print_exc()
            _mark_failed(batch, e)

    def _run(self):
        # inference mode is per thread: this one decodes
        with torch.inference_mode():
            inflight = deque()      # launched, not read back
            while not self._stop.is_set():
                todo = self._take_ready()
                if todo:
                    try:
                        inflight.append((todo, self.engine.launch(todo)))
                    except Exception as e:  # noqa: BLE001 — serving boundary
                        traceback.print_exc()
                        _mark_failed(todo, e)
                    if len(inflight) < self.pipeline_depth:
                        continue            # keep launching ahead
                if inflight and (todo or self.engine.queue_depth() == 0
                                 or len(inflight) >= self.pipeline_depth):
                    self._readback(*inflight.popleft())
                    continue
                if not todo:
                    with span("serve.batcher.linger"):
                        time.sleep(self.linger_s / 4 if self.linger_s
                                   else 1e-3)
            while inflight:                 # drain on stop
                self._readback(*inflight.popleft())
