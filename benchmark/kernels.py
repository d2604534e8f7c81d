"""The hand-written kernels' launches in a traced stretch: the two entry
points (`ops.chain.fused_chain`, `ops.step.step_bwd`) are wrapped while a
`--trace 1` run traces, to read each launch's shape and slots, from which
`flops.chain_call` and `flops.step_bwd_call` give its least time. The
wrappers change no argument and no result."""

from __future__ import annotations

from benchmark import flops

# the profiler's kernel names hold these parts
PARTS = {"chain": "chain_kernel", "step_bwd": "step_bwd"}


class KernelLog:
    def __init__(self):
        self.recording = False
        self.calls = []           # (kind, slots on the device, (b,h,w), mask?)

    def install(self):
        from t2onet_tpu_torch.ops import chain, step

        fused_chain, step_bwd = chain.fused_chain, step.step_bwd

        def chain_wrapped(imgs, op_slots, params, mask=None):
            out = fused_chain(imgs, op_slots, params, mask)
            if self.recording and imgs.device.type == "cuda":
                self.calls.append(("chain", op_slots.detach().clone(),
                                   tuple(imgs.shape), mask is not None))
            return out

        def step_bwd_wrapped(imgs, op_slots, params, g, mask=None):
            out = step_bwd(imgs, op_slots, params, g, mask)
            if self.recording and imgs.device.type == "cuda":
                self.calls.append(("step_bwd", op_slots.detach().clone(),
                                   tuple(imgs.shape), mask is not None))
            return out

        chain.fused_chain = chain_wrapped
        step.step_bwd = step_bwd_wrapped

    def least_seconds(self):
        """{kind: (summed least seconds, launches)} of the recorded
        launches."""
        out = {k: [0.0, 0] for k in PARTS}
        for kind, slots, (_, _, h, w), masked in self.calls:
            rows = slots.cpu().numpy()
            if kind == "chain":
                n_bytes, n_flops = flops.chain_call(
                    rows.reshape(rows.shape[0], -1), h, w, masked)
            else:
                n_bytes, n_flops = flops.step_bwd_call(rows.ravel(), h, w,
                                                       masked)
            out[kind][0] += flops.least_seconds(n_bytes, n_flops)
            out[kind][1] += 1
        return {k: tuple(v) for k, v in out.items()}
