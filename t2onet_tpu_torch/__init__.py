"""t2onet_tpu_torch — the PyTorch and CUDA counterpart of t2onet_tpu.

The same language-guided image editor, written for an NVIDIA H100:
plain tensor code is PyTorch, and each Pallas kernel of the JAX package
is a kernel written by hand for Hopper (`csrc/`). The JAX package stays
the reference; tests hold this package to it.

- `ops`     — operator math, the executor bank and the chain kernel.
- `models`  — ResNet vision encoder, bi-LSTM request encoder, attention
              decoder step and the actor's greedy rollout.
- `serve`   — the serving engine: tokenize, decode at a probe
              resolution, execute the program at native resolution.
- `convert` — carries a JAX actor's variables into the port's modules.
- `planner` — the offline beam-search planner that writes the action
              files the trainers learn from.

Importing the package loads no kernel and starts nothing: kernels are
built at their first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
