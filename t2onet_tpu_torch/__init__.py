"""t2onet_tpu_torch — the PyTorch and CUDA counterpart of t2onet_tpu.

The same language-guided image editor, written for an NVIDIA H100:
plain tensor code is PyTorch, and each Pallas kernel of the JAX package
is a kernel written by hand for Hopper (`csrc/`). The JAX package stays
the reference; tests hold this package to it.

- `ops`     — operator math, the executor bank and the chain kernel.
- `models`  — ResNet vision encoder, bi-LSTM request encoder, attention
              decoder step and the actor's greedy rollout; the inpaint
              fillers; T2ONet+D's discriminator, VGG19 and pix2pixHD.
- `serve`   — the serving engine: tokenize, decode at a probe
              resolution, execute the program at native resolution.
- `convert` — carries a JAX actor's (and filler's and discriminator's)
              variables, or a reference seq2seqGAN model.pth, into the
              port's modules.
- `planner` — the offline beam-search planner that writes the action
              files the trainers learn from, by a pixel or a learned
              distance.
- `evals`   — L1, SSIM, FID (InceptionV3 features) and the gallery.
- `parallel` — data parallelism, the device mesh, and the (data x
              model) grid that splits the parameter heads.
- `cli`     — every entry point; `python -m t2onet_tpu_torch <command>`
              runs them by JAX's command names.

Importing the package loads no kernel and starts nothing: kernels are
built at their first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
