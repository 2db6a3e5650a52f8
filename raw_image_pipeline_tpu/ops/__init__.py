"""ISP ops in JAX.

Every op is a pure, jit-compatible function over batched NHWC uint8 frames
([B,H,W] Bayer or [B,H,W,3] BGR). Per-frame statistics reduce over the
spatial axes only, so a batch of frames behaves exactly like the reference
applied frame-by-frame.
"""
