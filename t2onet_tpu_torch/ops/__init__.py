"""Operator math, the executor bank and the chain kernel.

Images are NCHW (B, 3, H, W) float32 in [0, 1], as in `t2onet_tpu.ops`.
"""
